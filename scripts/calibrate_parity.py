"""Calibrate CI parity thresholds: render every scene tiny on CPU and print
correlation vs candidate goldens (helps pick mappings + thresholds)."""

import os as _os, sys as _sys
# importable from any cwd without PYTHONPATH: repo root hosts art_tpu/
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import os
import sys
import time

import jax
jax.config.update("jax_platforms", "cpu")

import numpy as np
from PIL import Image

from art_tpu.models import build_scene
from art_tpu.render.renderer import RenderConfig, render_scene

# the reference repository's images/ directory
GOLDEN_DIR = os.environ.get("ART_TPU_REFERENCE_IMAGES", "reference/images")
GRID = (16, 8)

CANDIDATES = {
    "three_spheres": ["spheres.png", "materials.png", "defocus.png"],
    "quads": ["quads.png"],
    "checkered_spheres": ["checkered.png"],
    "perlin": ["perlin.png"],
    "earth": ["textureWrap.png", "spheres.png"],
    "bouncing_spheres": ["utk.png", "motion-blur.png", "checkeredBounce.png"],
    "simple_light": ["poolBall.png", "simpleLight.png"],
    "cornell_box": ["cornellBox.png", "instancing.png", "redBlue.png"],
    "cornell_smoke": ["instancing.png", "cornellBox.png"],
    "final_scene": ["finalScene.png"],
    "original_scene": ["alfredo2.png"],
}

NX = 96
SPP = {"cornell_box": 48, "cornell_smoke": 48, "simple_light": 48,
       "final_scene": 32, "original_scene": 32}


def down(img, grid=GRID):
    return np.asarray(
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).resize(
            grid, Image.BILINEAR),
        np.float32,
    ) / 255.0


for name, cands in CANDIDATES.items():
    if len(sys.argv) > 1 and name not in sys.argv[1:]:
        continue
    gold0 = np.asarray(Image.open(f"{GOLDEN_DIR}/{cands[0]}").convert("RGB"),
                       np.float32) / 255.0
    gh, gw = gold0.shape[:2]
    ny = max(8, int(round(NX * gh / gw)))
    spp = SPP.get(name, 24)
    t0 = time.time()
    scene = build_scene(name, NX, ny)
    fb, _ = render_scene(scene, RenderConfig(nx=NX, ny=ny, spp=spp, seed=3))
    dt = time.time() - t0
    ours = down(np.clip(fb[::-1], 0, 1))
    row = [f"{name:18s} ({dt:5.1f}s spp={spp})"]
    for c in cands:
        gold = np.asarray(Image.open(f"{GOLDEN_DIR}/{c}").convert("RGB"),
                          np.float32) / 255.0
        g = down(gold)
        corr = float(np.corrcoef(ours.mean(-1).ravel(), g.mean(-1).ravel())[0, 1])
        md = float(np.abs(ours.mean((0, 1)) - g.mean((0, 1))).max())
        row.append(f"{c}:corr={corr:.3f},md={md:.3f}")
    print("  ".join(row), flush=True)
