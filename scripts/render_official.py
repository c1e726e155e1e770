"""Render scenes at their OFFICIAL reference configs (models/scenes._DEFAULTS,
mirroring the reference's main.cu) and save PNGs to docs/renders/full/.

    python scripts/render_official.py scene [scene ...]

These renders are the images the golden statistics in tests/goldens/official
derive from (scripts/gen_self_goldens.py official).  Run on a GPU: the
10,000-spp configs take hours on a CPU.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from art_tpu.core.cache import enable_compile_cache  # noqa: E402
from art_tpu.models import build_scene, scene_defaults  # noqa: E402
from art_tpu.render.renderer import RenderConfig, render_scene  # noqa: E402
from art_tpu.utils.ppm import write_png  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "docs", "renders", "full")


def main():
    enable_compile_cache()
    os.makedirs(OUT, exist_ok=True)
    for name in sys.argv[1:]:
        d = scene_defaults(name)
        nx, ny, spp = d["nx"], d["ny"], d["spp"]
        print(f"[{name}] official {nx}x{ny} spp={spp}", flush=True)
        fb, _ = render_scene(build_scene(name, nx, ny),
                             RenderConfig(nx=nx, ny=ny, spp=spp), verbose=True)
        write_png(fb, os.path.join(OUT, f"{name}_official.png"))


if __name__ == "__main__":
    main()
