"""Smoke run of the wavefront renderer on a GPU: the quickest proof that the
system still starts and renders correctly on the card.

    python chip_smoke.py             # one card, every phase below
    python chip_smoke.py --cards 4   # four cards: the sharded path only

Its timings are a smoke reading, not a benchmark: one process, short
renders, compile times from a cold cache.

Phases on one card:

* ``parity`` — every registered scene at 64x48 and ``PARITY_SPP`` spp with
  one seed, rendered on the GPU and on this process's CPU backend, gated
  on 16x8 grid statistics (art_tpu/utils/parity.py);
* ``full`` — the reference configurations through ``render_scene`` at
  reduced spp (``FULL``), gated against the golden statistics of the
  official renders, with compile seconds, Mrays/s, s/frame, wavefront
  iterations, pool occupancy and the wavefront program's memory analysis;
* ``cli`` — ``art_tpu.cli.main`` renders cornell_box 600x600 to a PPM file.

With ``--cards 4``: final_scene 800x800 on a (4, 1) and a (2, 2) mesh,
each compared with a one-card render of the same scene, and the output
shards checked to live on all four cards.

Prints the card's name and power limit, ``jax.__version__`` and
``XLA_FLAGS`` on earlier lines; the last line is the JSON object
``{"ok": true, "device": {...}}``.  Exits non-zero, without that line, when
the default backend is not ``gpu``, a phase fails, or a comparison misses
its tolerance.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from art_tpu.core.cache import CHECKOUT, enable_compile_cache
from art_tpu.models import SCENES, build_scene
from art_tpu.render import renderer
from art_tpu.render.renderer import RenderConfig, plan_batches, render_scene
from art_tpu.utils.device import card_name_and_power_limit, device_record
from art_tpu.utils.parity import compare, load_golden, render_grid

# GPU against the CPU reference: one seed, but the two backends round
# differently (FMA contraction, sqrt, division, atomic scatter order), and
# the first ray whose fate differs shifts the pool's refill order, so the
# two renders become independent sample streams.  The gate is therefore
# the spread of two independent renders at this size (PERF.md).
PARITY_NX, PARITY_NY, PARITY_SPP = 64, 48, 64
PARITY_MIN_CORR, PARITY_MAX_MEAN_DIFF = 0.97, 0.01

# (scene, nx, ny, spp, golden, min corr, max mean diff); the gates are
# test_parity.py's for bouncing_spheres and final_scene.  The clamped mean
# of a low-spp render reads dark (firefly clipping), so each spp is the
# least whose mean sits inside the gate with margin (PERF.md).
FULL = [
    ("bouncing_spheres", 1200, 800, 128,
     "official/bouncing_spheres_1200x800", 0.97, 0.03),
    ("final_scene", 800, 800, 64, "official/final_scene", 0.98, 0.12),
    ("cornell_smoke", 600, 600, 32, "official/cornell_smoke", 0.98, 0.05),
]
SHARDED_SCENE, SHARDED_NX, SHARDED_NY, SHARDED_SPP = "final_scene", 800, 800, 64


class SmokeFailure(Exception):
    """A phase ran but its result is wrong."""


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def require_gpu() -> dict:
    """The device record of the default backend; fails unless it is a GPU."""
    dev = device_record()
    check(dev["platform"] == "gpu", f"default backend is {dev['platform']}, not gpu")
    return dev


def contract_line(dev: dict) -> str:
    return json.dumps({"ok": True, "device": dev})


# ---------------------------------------------------------------------------
# parity against the CPU backend
# ---------------------------------------------------------------------------


def phase_parity() -> None:
    cfg = RenderConfig(nx=PARITY_NX, ny=PARITY_NY, spp=PARITY_SPP, seed=7)
    cpu = jax.devices("cpu")[0]
    for name in sorted(SCENES):
        fb_gpu, _ = render_scene(build_scene(name, cfg.nx, cfg.ny), cfg)
        with jax.default_device(cpu):
            fb_cpu, _ = render_scene(build_scene(name, cfg.nx, cfg.ny), cfg)
        check(np.isfinite(fb_gpu).all(), f"parity {name}: non-finite GPU pixels")
        corr, mean_diff = compare(render_grid(fb_gpu), render_grid(fb_cpu))
        print(f"parity {name}: gpu vs cpu corr {corr:.4f} "
              f"mean diff {mean_diff:.4f}", flush=True)
        check(corr >= PARITY_MIN_CORR and mean_diff <= PARITY_MAX_MEAN_DIFF,
              f"parity {name}: corr {corr} mean diff {mean_diff}")


# ---------------------------------------------------------------------------
# full-size renders
# ---------------------------------------------------------------------------


def wavefront_memory(scene, cfg: RenderConfig) -> str:
    """``compiled.memory_analysis()`` of the scene's wavefront program."""
    t = scene.tables
    n_prims = max(t.n_spheres, t.n_quads, t.n_boxes, 1)
    tile, spp_chunk, slots = plan_batches(cfg.nx * cfg.ny, cfg.spp, n_prims, cfg)
    compiled = renderer._wavefront_jit.lower(
        t, scene.camera, jnp.int32(0), key=jax.random.PRNGKey(0),
        background=jnp.asarray(scene.background, jnp.float32),
        spp=spp_chunk, tile_pixels=tile, total_pixels=cfg.nx * cfg.ny,
        nx=cfg.nx, ny=cfg.ny, max_depth=cfg.max_depth,
        gradient_bg=scene.gradient_bg, n_slots=slots,
    ).compile()
    m = compiled.memory_analysis()
    return (f"args {m.argument_size_in_bytes} B, outputs "
            f"{m.output_size_in_bytes} B, temps {m.temp_size_in_bytes} B, "
            f"code {m.generated_code_size_in_bytes} B")


def timed(scene, cfg: RenderConfig):
    """(fb, steady stats, compile seconds): a first render that compiles,
    then a second one that only runs."""
    t0 = time.perf_counter()
    render_scene(scene, cfg)
    first = time.perf_counter() - t0
    fb, stats = render_scene(scene, cfg)
    return fb, stats, max(first - stats["seconds"], 0.0)


def phase_full() -> None:
    for name, nx, ny, spp, golden, min_corr, max_md in FULL:
        scene = build_scene(name, nx, ny)
        cfg = RenderConfig(nx=nx, ny=ny, spp=spp)
        fb, st, compile_s = timed(scene, cfg)
        check(fb.shape == (ny, nx, 3) and np.isfinite(fb).all(),
              f"full {name}: bad framebuffer")
        corr, mean_diff = compare(render_grid(fb), load_golden(golden))
        print(f"full {name} {nx}x{ny} spp={st['spp']} (smoke reading): "
              f"compile {compile_s:.1f} s, {st['mrays_per_sec']:.2f} Mrays/s, "
              f"{st['seconds']:.3f} s/frame, iterations {st['iterations']}, "
              f"occupancy {st['occupancy']:.3f}, slots {st['n_slots']}, "
              f"tile {st['tile_pixels']} px x {st['spp_chunk']} spp", flush=True)
        print(f"full {name} memory: {wavefront_memory(scene, cfg)}", flush=True)
        print(f"full {name} vs {golden}: corr {corr:.4f} "
              f"mean diff {mean_diff:.4f}", flush=True)
        check(corr >= min_corr and mean_diff <= max_md,
              f"full {name}: corr {corr} mean diff {mean_diff}")


def phase_cli() -> None:
    from art_tpu import cli
    from art_tpu.utils.ppm import read_ppm

    out = os.path.join(CHECKOUT, "out", "chip_smoke_cornell_box.ppm")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    rc = cli.main(["--scene", "cornell_box", "--nx", "600", "--ny", "600",
                   "--spp", "16", "--out", out])
    check(rc == 0, f"cli exited {rc}")
    with open(out) as f:
        img = read_ppm(f.read())
    check(img.shape == (600, 600, 3) and img.max() > 0, "cli: bad PPM")
    print(f"cli cornell_box 600x600: wrote {os.path.relpath(out, CHECKOUT)}",
          flush=True)


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def phase_sharded() -> None:
    from art_tpu.parallel.sharding import make_mesh, render_scene_sharded

    devs = jax.devices()
    check(len(devs) >= 4, f"--cards 4 needs four cards, JAX sees {len(devs)}")
    scene = build_scene(SHARDED_SCENE, SHARDED_NX, SHARDED_NY)
    cfg = RenderConfig(nx=SHARDED_NX, ny=SHARDED_NY, spp=SHARDED_SPP)
    fb_one, st_one, _ = timed(scene, cfg)
    print(f"sharded {SHARDED_SCENE} one card: {st_one['mrays_per_sec']:.2f} "
          f"Mrays/s, {st_one['seconds']:.3f} s (smoke reading)", flush=True)
    for shape in ((4, 1), (2, 2)):
        mesh = make_mesh(shape, devices=devs[:4])
        render_scene_sharded(scene, cfg, mesh=mesh)  # compile
        fb, st = render_scene_sharded(scene, cfg, mesh=mesh)
        corr, mean_diff = compare(render_grid(fb), render_grid(fb_one))
        print(f"sharded {SHARDED_SCENE} mesh {shape}: "
              f"{st['mrays_per_sec']:.2f} Mrays/s, {st['seconds']:.3f} s, "
              f"{st['mrays_per_sec'] / st_one['mrays_per_sec']:.2f}x one "
              f"card; vs one card corr {corr:.4f} mean diff {mean_diff:.4f}",
              flush=True)
        check(corr >= PARITY_MIN_CORR and mean_diff <= PARITY_MAX_MEAN_DIFF,
              f"sharded {shape}: corr {corr} mean diff {mean_diff}")
        placed = shard_devices(scene, cfg, mesh)
        print(f"sharded mesh {shape}: output shards on {sorted(placed)}",
              flush=True)
        check(placed == {d.id for d in devs[:4]},
              f"sharded {shape}: output on devices {placed}")


def shard_devices(scene, cfg: RenderConfig, mesh) -> set:
    """Device ids holding the shards of one sharded dispatch's output."""
    from art_tpu.parallel.sharding import _sharded_step_jit

    n_px = mesh.shape["px"]
    n_pixels = -(-cfg.nx * cfg.ny // n_px) * n_px
    step = _sharded_step_jit(mesh, cfg.nx, cfg.ny, 1, 4, scene.gradient_bg, 1024)
    rad, _ = step(scene.tables, scene.camera,
                  jnp.arange(n_pixels, dtype=jnp.int32) % (cfg.nx * cfg.ny),
                  jax.random.PRNGKey(0),
                  jnp.asarray(scene.background, jnp.float32))
    return {s.device.id for s in rad.addressable_shards}


PHASES = {
    "parity": phase_parity,
    "full": phase_full,
    "cli": phase_cli,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    ap.add_argument("--phase", action="append", choices=sorted(PHASES),
                    help="run only these one-card phases (default: all)")
    args = ap.parse_args(argv)

    enable_compile_cache()
    dev = require_gpu()
    print(f"card: {card_name_and_power_limit()}", flush=True)
    print(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}",
          flush=True)
    start = time.perf_counter()
    if args.cards == 4:
        phase_sharded()
    else:
        for name in args.phase or PHASES:
            t0 = time.perf_counter()
            PHASES[name]()
            print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"smoke total {time.perf_counter() - start:.1f} s", flush=True)
    print(contract_line(dev))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
