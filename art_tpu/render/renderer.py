"""Render driver: tiling, queue batching, gamma, framebuffer assembly.

The reference launches one CUDA thread per pixel looping ns samples
(reference src/main.cu:107-133).  Here the driver feeds the persistent
wavefront integrator: each jit dispatch renders a (pixel-tile x sample
chunk) queue through a fixed pool of ray slots, sized to bound the
(R x N) working set of the brute-force intersection passes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import sys
import time as _time
import zipfile

import jax
import jax.numpy as jnp
import numpy as np

from art_tpu.core import rng as artrng
from art_tpu.core.camera import Camera, generate_rays
from art_tpu.render.integrator import render_wavefront, trace
from art_tpu.scene.tables import SceneTables


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    nx: int = 400
    ny: int = 225
    spp: int = 16
    max_depth: int = 50  # reference hardcodes 50 (src/main.cu:54)
    gamma: float = 2.2
    seed: int = 1984  # reference seed (src/main.cu:92)
    # max (R x N) intersection elements per iteration
    batch_budget: int = 1 << 23
    max_slots: int = 1 << 16
    # max pixels per tile: bounds the framebuffer scatter target
    max_tile_pixels: int = 1 << 16
    # max queue elements (pixel-samples) per jit dispatch; deep queues
    # amortize the drain tail, where the pool empties
    queue_budget: int = 1 << 25


def plan_batches(n_pixels: int, spp: int, n_prims_max: int, cfg: RenderConfig):
    """Choose (tile_pixels, spp_chunk, n_slots) for the wavefront pool."""
    n_prims_max = max(n_prims_max, 1)
    n_slots = max(1024, min(cfg.max_slots, cfg.batch_budget // n_prims_max))
    max_tile = cfg.max_tile_pixels
    queue_budget = cfg.queue_budget
    tile_pixels = min(n_pixels, max_tile)
    # Balance tiles: ceil-dividing 360000 px into 65536-px tiles would pad
    # the last tile with 8.5% clamped (wasted) pixels; distributing the
    # remainder across all tiles instead keeps every tile full of real
    # work (128-aligned for tidy framebuffer rows).
    n_tiles = -(-n_pixels // tile_pixels)
    even = (n_pixels + n_tiles - 1) // n_tiles
    tile_pixels = min(tile_pixels, (even + 127) // 128 * 128)
    spp_chunk = min(spp, max(1, queue_budget // tile_pixels))
    # Balance spp chunks like tiles: spp=513 with a 512 cap would render
    # 2x512=1024 samples (half wasted); 2x257=514 keeps the same chunk
    # count with ~zero overshoot.
    n_chunks = -(-spp // spp_chunk)
    spp_chunk = -(-spp // n_chunks)
    # Never make the pool larger than the queue: padded queue elements are
    # wasted oversampling work (they are normalized out, but cost time).
    n_q = tile_pixels * spp_chunk
    if n_slots > n_q:
        n_slots = max(256, n_q)
    return tile_pixels, spp_chunk, n_slots


def sample_counts(tile_pixels: int, spp: int, n_slots: int) -> np.ndarray:
    """Per-pixel sample count for one wavefront dispatch.

    The global work-stealing queue consumes exactly P*spp elements, so every
    pixel receives exactly spp samples."""
    del n_slots
    return np.full(tile_pixels, spp, np.int64)


def _render_batch(
    tables: SceneTables,
    cam: Camera,
    pix: jnp.ndarray,  # (P,) int32 pixel ids (j*nx + i)
    key: jax.Array,
    background: jnp.ndarray,
    *,
    nx: int,
    ny: int,
    spp_chunk: int,
    max_depth: int,
    gradient_bg: bool,
):
    """Fixed-batch render path (compile-check entry + small utilities):
    (P,3) radiance sum over spp_chunk, plus ray count."""
    P = pix.shape[0]
    R = P * spp_chunk
    pix_r = jnp.repeat(pix, spp_chunk)
    i = (pix_r % nx).astype(jnp.float32)
    j = (pix_r // nx).astype(jnp.float32)

    # sub-pixel jitter u=(i+xi)/nx, v=(j+xi)/ny (src/main.cu:121-122)
    xi = artrng.uniform(artrng.fold(key, artrng.SITE_JITTER), (R, 2))
    s = (i + xi[:, 0]) / nx
    t = (j + xi[:, 1]) / ny

    o, d, times = generate_rays(cam, s, t, key)
    radiance, rays_traced = trace(
        tables, o, d, times, key, background, gradient_bg, max_depth
    )
    return radiance.reshape(P, spp_chunk, 3).sum(axis=1), rays_traced


_wavefront_jit = jax.jit(
    render_wavefront,
    static_argnames=(
        "spp", "tile_pixels", "total_pixels", "nx", "ny",
        "max_depth", "gradient_bg", "n_slots",
    ),
)


def _scene_digest(scene) -> str:
    """Digest of the compiled scene (tables + camera + background) for
    checkpoint identity."""
    h = hashlib.sha1()
    for leaf in jax.tree_util.tree_leaves((scene.tables, scene.camera)):
        h.update(np.asarray(leaf).tobytes())
    h.update(np.asarray(scene.background, np.float32).tobytes())
    h.update(bytes([int(bool(scene.gradient_bg))]))
    return h.hexdigest()[:16]


def apply_gamma(fb: np.ndarray, gamma: float) -> np.ndarray:
    """Per-channel gamma (reference src/main.cu:37-42)."""
    if gamma == 1.0:
        return fb
    return np.power(np.maximum(fb, 0.0), 1.0 / gamma)


def render_scene(
    scene,
    cfg: RenderConfig,
    verbose: bool = False,
    checkpoint_path: str | None = None,
):
    """Render a CompiledScene; returns (framebuffer (ny,nx,3) float, stats dict).

    Row 0 of the framebuffer is the *bottom* scanline (reference fb layout,
    pixel = j*nx + i).

    ``checkpoint_path``: optional .npz path.  The radiance accumulator is
    saved after every (tile, chunk) dispatch and a matching render resumes
    from the last completed dispatch — the reference has no recovery story
    (a render is all-or-nothing, SURVEY.md §5); here a 10000-spp frame
    survives interruption.
    """
    tables: SceneTables = scene.tables
    cam: Camera = scene.camera
    background = jnp.asarray(scene.background, jnp.float32)

    n_pixels = cfg.nx * cfg.ny
    n_prims_max = max(tables.n_spheres, tables.n_quads, tables.n_boxes, 1)
    tile_pixels, spp_chunk, n_slots = plan_batches(
        n_pixels, cfg.spp, n_prims_max, cfg
    )
    n_tiles = -(-n_pixels // tile_pixels)
    n_chunks = -(-cfg.spp // spp_chunk)

    if verbose:
        print(
            f"render {cfg.nx}x{cfg.ny} spp={cfg.spp} depth={cfg.max_depth} "
            f"tiles={n_tiles}x{tile_pixels}px chunks={n_chunks}x{spp_chunk}spp "
            f"slots={n_slots}",
            file=sys.stderr,
        )

    master = jax.random.PRNGKey(cfg.seed)
    fb = np.zeros((n_pixels, 3), np.float32)
    counts_chunk = sample_counts(tile_pixels, spp_chunk, n_slots)
    total_rays = 0.0
    total_iters = 0
    start = _time.perf_counter()

    # ---- checkpoint/resume bookkeeping ----
    ckpt_sig = np.array(
        [cfg.nx, cfg.ny, cfg.spp, cfg.max_depth, cfg.seed, tile_pixels, spp_chunk, n_slots]
    )
    # Scene identity: name + digest of the compiled tables/camera/background,
    # so a checkpoint written for scene A is ignored (not silently resumed)
    # when rendering scene B with the same config.
    ckpt_scene = f"{getattr(scene, 'name', 'scene')}:{_scene_digest(scene)}"
    done_dispatches = -1  # index of last completed (tile * n_chunks + chunk)
    if checkpoint_path:
        # np.savez appends '.npz' to extension-less paths; normalize so the
        # save and the resume load agree on one filename.
        if not checkpoint_path.endswith(".npz"):
            checkpoint_path += ".npz"
        try:
            ck = np.load(checkpoint_path)
            if np.array_equal(ck["sig"], ckpt_sig) and str(ck["scene"]) == ckpt_scene:
                fb = ck["fb"]
                done_dispatches = int(ck["done"])
                total_rays = float(ck["rays"])
                if verbose:
                    print(
                        f"resuming from checkpoint: {done_dispatches + 1} dispatches done",
                        file=sys.stderr,
                    )
        except (OSError, KeyError, ValueError, EOFError, zipfile.BadZipFile):
            # missing file, truncated zip from a mid-save kill, or a
            # foreign/old format all mean: start fresh
            pass

    def save_ckpt(done):
        # write-then-rename so a kill mid-save can never leave a truncated
        # archive at checkpoint_path
        tmp = checkpoint_path + ".tmp"
        with open(tmp, "wb") as fh:
            np.savez(
                fh, sig=ckpt_sig, scene=ckpt_scene, fb=fb, done=done,
                rays=total_rays,
            )
        os.replace(tmp, checkpoint_path)

    for tile in range(n_tiles):
        lo = tile * tile_pixels
        hi = min(lo + tile_pixels, n_pixels)
        for chunk in range(n_chunks):
            dispatch = tile * n_chunks + chunk
            if dispatch <= done_dispatches:
                continue
            k = artrng.fold(master, tile, chunk)
            batch, rays, iters = _wavefront_jit(
                tables,
                cam,
                jnp.int32(lo),
                key=k,
                background=background,
                spp=spp_chunk,
                tile_pixels=tile_pixels,
                total_pixels=n_pixels,
                nx=cfg.nx,
                ny=cfg.ny,
                max_depth=cfg.max_depth,
                gradient_bg=scene.gradient_bg,
                n_slots=n_slots,
            )
            # fb holds raw radiance sums until the final normalization
            fb[lo:hi] += np.asarray(batch)[: hi - lo]
            total_rays += float(rays)
            total_iters += int(iters)
            if checkpoint_path:
                save_ckpt(dispatch)

    elapsed = _time.perf_counter() - start
    counts = counts_chunk[0] * n_chunks  # exact spp per pixel (uniform)
    fb = apply_gamma(fb / counts, cfg.gamma)
    fb = fb.reshape(cfg.ny, cfg.nx, 3)

    stats = {
        "seconds": elapsed,
        "rays": total_rays,
        "mrays_per_sec": total_rays / elapsed / 1e6 if elapsed > 0 else 0.0,
        "spp": n_chunks * spp_chunk,
        "tile_pixels": tile_pixels,
        "spp_chunk": spp_chunk,
        "n_slots": n_slots,
        "iterations": total_iters,
        "occupancy": (
            total_rays / (total_iters * n_slots) if total_iters else 0.0
        ),
    }
    if verbose:
        print(
            f"took {elapsed:.3f} seconds. rays={total_rays:.3g} "
            f"({stats['mrays_per_sec']:.2f} Mrays/s)",
            file=sys.stderr,
        )
    return fb, stats
