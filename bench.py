"""Benchmark: per-scene throughput sweep on one GPU.

Renders fixed-shape sample chunks (one compiled program per scene) and
reports steady-state ray throughput, plus the extrapolated full-frame time
of the headline scene (bouncing spheres, 1200x800 @ 500 spp).  Compilation
happens in a warm-up render outside the timed window.

Prints the card's name and power limit on stderr and ONE JSON line on
stdout.  Fails when JAX finds no GPU, and when any scene fails.
"""

from __future__ import annotations

import json
import os
import sys
import time

from art_tpu.core.cache import enable_compile_cache
from art_tpu.utils.device import card_name_and_power_limit, device_record

NX, NY, SPP_FULL = 1200, 800, 500
SPP_CHUNK = 500  # one compiled program; deep queue keeps pool occupancy high
TIME_BUDGET_S = 150.0

# secondary scenes: (nx, ny, spp per measured chunk, time budget)
SWEEP = [
    ("cornell_smoke", 600, 600, 400, 60.0),
    ("final_scene", 800, 800, 500, 90.0),
    ("quads", 1200, 600, 500, 45.0),
    ("earth", 1200, 600, 500, 45.0),
    ("original_scene", 800, 800, 500, 75.0),
]


def measure(name, nx, ny, spp, budget_s):
    from art_tpu.models import build_scene
    from art_tpu.render.renderer import RenderConfig, render_scene

    scene = build_scene(name, nx, ny)
    cfg = RenderConfig(nx=nx, ny=ny, spp=spp)
    print(f"bench[{name}]: warm-up compile...", file=sys.stderr)
    render_scene(scene, cfg)  # compile + first run
    total_rays = 0.0
    total_secs = 0.0
    spp_done = 0
    start = time.perf_counter()
    while (time.perf_counter() - start) < budget_s:
        _, stats = render_scene(scene, cfg)
        total_rays += stats["rays"]
        total_secs += stats["seconds"]
        spp_done += stats["spp"]
        print(
            f"bench[{name}]: spp={spp_done} rate={stats['mrays_per_sec']:.2f} Mrays/s",
            file=sys.stderr,
        )
        if spp_done >= SPP_FULL:
            break
    mrays = total_rays / total_secs / 1e6 if total_secs > 0 else 0.0
    return mrays, total_secs, spp_done


def main() -> None:
    enable_compile_cache()
    device = device_record()
    if device["platform"] != "gpu":
        raise SystemExit(f"bench: needs a GPU, JAX found {device}")
    card = card_name_and_power_limit()
    print(f"bench: card {card}", file=sys.stderr)
    mrays, secs, spp_done = measure(
        "bouncing_spheres", NX, NY, SPP_CHUNK, TIME_BUDGET_S
    )
    sec_per_frame = secs * (SPP_FULL / max(spp_done, 1))

    per_scene = {"bouncing_spheres": round(mrays, 3)}
    for name, nx, ny, spp, budget in SWEEP:
        m, _, _ = measure(name, nx, ny, spp, budget)
        per_scene[name] = round(m, 3)

    result = {
        "metric": "Mrays_per_sec(bouncing_spheres 1200x800)",
        "value": round(mrays, 3),
        "unit": "Mrays/s",
        "sec_per_frame_500spp": round(sec_per_frame, 2),
        "spp_measured": spp_done,
        "per_scene_mrays": per_scene,
        "device": device,
        "card": card,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
