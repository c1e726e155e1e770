"""Generate the committed golden statistics under tests/goldens/.

    python scripts/gen_self_goldens.py [name ...]

Three kinds, each a 16x8 grid statistic (art_tpu.utils.parity):

* self-goldens for scenes without a reference golden image
  (cornell_smoke; three_spheres, our extra scene): a deterministic CPU
  render at the test's own config, ``<scene>.json``;
* ``cornell_box_legacy_walls.json``: the legacy green-wall Cornell box
  (the wall colours of the reference's older golden images) rendered on
  the CPU at high spp;
* ``official/<scene>.json``: statistics of the repo's 10,000-spp official
  renders ``docs/renders/full/<scene>_official.png`` (which
  docs/parity_report.json gates against the reference goldens), plus
  ``official/bouncing_spheres_1200x800.json``, the central 3:2 crop of
  the 2:1 official render — the same camera at aspect 1.5 sees exactly
  those columns.  Reading the PNGs needs Pillow.

tests/test_parity.py and chip_smoke.py compare fresh renders against these
within Monte-Carlo tolerance.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from art_tpu.models import build_scene  # noqa: E402
from art_tpu.models.scenes import cornell_box  # noqa: E402
from art_tpu.render.renderer import RenderConfig, render_scene  # noqa: E402
from art_tpu.utils.parity import GOLDEN_DIR, GRID, downsample, grid_stats, render_grid  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OFFICIAL_DIR = os.path.join(REPO, "docs", "renders", "full")

# scene -> (nx, ny, spp, seed)
SELF = {
    "cornell_smoke": (96, 96, 96, 3),
    "three_spheres": (96, 54, 48, 3),
}
LEGACY = ("cornell_box_legacy_walls", 96, 96, 4096, 11)
OFFICIAL = [
    "bouncing_spheres", "checkered_spheres", "cornell_box", "cornell_smoke",
    "earth", "final_scene", "original_scene", "perlin", "quads",
    "simple_light", "simple_light_book", "three_spheres",
]


def _write(path, data):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f)
    print(f"wrote {path} mean={data['mean_rgb']}", flush=True)


def _wanted(name):
    return len(sys.argv) < 2 or name in sys.argv[1:]


def _official(name, crop_aspect=None):
    from PIL import Image

    src = os.path.join(OFFICIAL_DIR, f"{name}_official.png")
    with Image.open(src) as im:
        img = np.asarray(im.convert("RGB"), np.uint8)
    h, w, _ = img.shape
    if crop_aspect is not None:
        keep = int(round(h * crop_aspect))
        x0 = (w - keep) // 2
        img = img[:, x0:x0 + keep]
        w = keep
    return dict(
        scene=name, source=os.path.relpath(src, REPO),
        width=w, height=h, grid=list(GRID), **grid_stats(downsample(img)),
    )


def main():
    for name, (nx, ny, spp, seed) in SELF.items():
        if not _wanted(name):
            continue
        fb, _ = render_scene(
            build_scene(name, nx, ny),
            RenderConfig(nx=nx, ny=ny, spp=spp, seed=seed),
        )
        data = dict(scene=name, nx=nx, ny=ny, spp=spp, seed=seed,
                    grid=list(GRID), **grid_stats(render_grid(fb)))
        _write(os.path.join(GOLDEN_DIR, f"{name}.json"), data)

    name, nx, ny, spp, seed = LEGACY
    if _wanted(name):
        fb, _ = render_scene(
            cornell_box(nx, ny, legacy_walls=True),
            RenderConfig(nx=nx, ny=ny, spp=spp, seed=seed),
        )
        data = dict(scene=name, nx=nx, ny=ny, spp=spp, seed=seed,
                    grid=list(GRID), **grid_stats(render_grid(fb)))
        _write(os.path.join(GOLDEN_DIR, f"{name}.json"), data)

    for name in OFFICIAL:
        if _wanted("official") or _wanted(f"official/{name}"):
            _write(os.path.join(GOLDEN_DIR, "official", f"{name}.json"),
                   _official(name))
    if _wanted("official"):
        _write(
            os.path.join(GOLDEN_DIR, "official", "bouncing_spheres_1200x800.json"),
            _official("bouncing_spheres", crop_aspect=1.5),
        )


if __name__ == "__main__":
    main()
