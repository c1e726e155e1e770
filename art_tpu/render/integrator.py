"""Wavefront path-tracing integrators (component-planar hot path).

Two entry points, both pure functions of a threefry seed:

* ``trace`` — trace a fixed ray batch to completion (``lax.while_loop`` over
  bounces with early all-dead exit).  Direct analog of the reference
  ``color()`` loop (src/main.cu:44-87); used for tests and ad-hoc rays.

* ``render_wavefront`` — the production path: a **persistent ray pool with
  global work-stealing queue refill**.  The reference dedicates one CUDA
  thread per pixel for its whole sample loop (src/main.cu:107-133), which
  on a vector machine would leave most lanes dead while the deepest path
  finishes.  Here a fixed pool of R slots is kept saturated: every
  iteration, slots whose ray terminated claim the next (pixel, sample)
  queue elements (rank = prefix sum of the dead mask — no slot can become a
  straggler) and dead-ray radiance is scatter-added into the framebuffer.

All per-ray vector state lives as component planes ((R,) per component):
each elementwise op then reads and writes contiguous (R,) arrays, and XLA
fuses the per-component chains into a few wide kernels.

Randomness: one fused uniform block per iteration, derived from
``fold(key, iteration)`` — every (slot, iteration, site) triple is used at
most once, so all draws are independent without per-ray key state.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from art_tpu.core import rng as artrng
from art_tpu.core.camera import Camera, rays_from_uniforms_p
from art_tpu.core.vecmath import T_MIN, p_mul, p_unstack, p_where
from art_tpu.ops.intersect import apply_media_p, closest_surface_p
from art_tpu.ops.shade import shade_p
from art_tpu.scene.tables import SceneTables

# uniform-block column layout (per iteration)
_U_BALL = slice(0, 3)
_U_CHOICE = 3
_U_JITTER0 = 4
_U_JITTER1 = 5
_U_LENS0 = 6
_U_LENS1 = 7
_U_TIME = 8
_U_MEDIA = 9  # columns 9.. are per-medium


def _n_uniform_cols(tables: SceneTables) -> int:
    return _U_MEDIA + max(tables.n_media, 1)


def background_color_p(d, bg: jnp.ndarray, gradient: bool):
    """Solid or y-gradient sky (reference src/main.cu:58-67), planar."""
    shape = d[0].shape
    if not gradient:
        return tuple(jnp.broadcast_to(bg[c], shape) for c in range(3))
    inv_len = 1.0 / jnp.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    t = 0.5 * (d[1] * inv_len + 1.0)
    # (1-t)*white + t*blue
    return (1.0 - 0.5 * t, 1.0 - 0.3 * t, jnp.broadcast_to(jnp.float32(1.0), shape))


def background_color(d: jnp.ndarray, bg: jnp.ndarray, gradient: bool) -> jnp.ndarray:
    return jnp.stack(background_color_p(p_unstack(d), bg, gradient), axis=-1)


# Debug ablation flags, read once at import (never inside traced bodies).
_DBG = __import__("os").environ.get("ART_TPU_DBG", "")
_NO_FLUSH = bool(__import__("os").environ.get("ART_TPU_NO_FLUSH"))
# Framebuffer flush strategy: aos (default, one atomic scatter-add of
# (R, 3) rows) | aos4 | planar | planar_drop | drop | subslot.
_FLUSH_ENV = __import__("os").environ.get("ART_TPU_FLUSH", "aos")


_SUBSLOTS = 8
# numpy, not jnp: a module-level device array would initialize the backend
# at import time
_SLOT_IOTA = __import__("numpy").arange(1 << 20, dtype=__import__("numpy").int32)


def _bounce_step(tables, o, d, tm, throughput, radiance, active,
                 u_ball, u_choice, u_media, background, gradient_bg):
    """One shared bounce: intersect -> media -> background/emission -> scatter.

    All vector quantities are 3-tuples of (R,) planes; ``u_ball`` is a
    3-tuple of uniform planes, ``u_choice`` one plane, ``u_media`` an
    indexable block of per-medium planes.  Returns
    (new_o, new_d, new_throughput, new_radiance, survived)."""
    if "fake_intersect" in _DBG:  # perf-debug: dependency-preserving stub
        from art_tpu.ops.intersect import HitRecordP
        from art_tpu.core.vecmath import p_ray_at, p_unit

        t5 = jnp.abs(d[0]) + 5.0
        rec = HitRecordP(
            hit=active,
            t=t5,
            p=p_ray_at(o, d, t5),
            normal=p_unit((-d[0], -d[1], -d[2])),
            u=tm * 0.0,
            v=tm * 0.0,
            mat=jnp.zeros_like(active, dtype=jnp.int32),
        )
    else:
        surf = closest_surface_p(tables, o, d, tm, T_MIN)
        rec = apply_media_p(tables, o, d, T_MIN, surf, u_media, time=tm)

    bg = background_color_p(d, background, gradient_bg)
    miss = active & ~rec.hit
    radiance = tuple(
        radiance[c] + jnp.where(miss, throughput[c] * bg[c], 0.0) for c in range(3)
    )

    live_hit = active & rec.hit
    if "fake_shade" in _DBG:  # perf-debug: dependency-preserving stub
        from art_tpu.core.vecmath import p_reflect
        from art_tpu.ops.shade import ScatterResultP

        nd = p_reflect(d, rec.normal)
        z = jnp.zeros_like(rec.t)
        sc = ScatterResultP(
            emitted=(z, z, z),
            attenuation=(z + 0.9, z + 0.9, z + 0.9),
            direction=nd,
            scattered=rec.hit & (u_choice < 0.7),
        )
    else:
        sc = shade_p(tables, d, rec, u_ball, u_choice)

    radiance = tuple(
        radiance[c] + jnp.where(live_hit, throughput[c] * sc.emitted[c], 0.0)
        for c in range(3)
    )

    survived = live_hit & sc.scattered
    throughput = p_where(survived, p_mul(throughput, sc.attenuation), throughput)
    o = p_where(survived, rec.p, o)
    d = p_where(survived, sc.direction, d)
    return o, d, throughput, radiance, survived


# ---------------------------------------------------------------------------
# Fixed-batch tracer (tests / ad-hoc rays)
# ---------------------------------------------------------------------------


class _TraceState(NamedTuple):
    bounce: jnp.ndarray
    origin: tuple
    direction: tuple
    time: jnp.ndarray
    throughput: tuple
    radiance: tuple
    alive: jnp.ndarray
    rays_traced: jnp.ndarray


def trace(
    tables: SceneTables,
    origins: jnp.ndarray,  # (R,3)
    directions: jnp.ndarray,  # (R,3)
    times: jnp.ndarray,
    key: jax.Array,
    background: jnp.ndarray,
    gradient_bg: bool,
    max_depth: int = 50,
):
    """Trace a ray batch to completion; returns (radiance (R,3), rays_traced ())."""
    R = origins.shape[0]
    ncols = _n_uniform_cols(tables)
    ones = jnp.ones((R,), jnp.float32)
    zeros = jnp.zeros((R,), jnp.float32)
    state = _TraceState(
        bounce=jnp.int32(0),
        origin=p_unstack(origins),
        direction=p_unstack(directions),
        time=times,
        throughput=(ones, ones, ones),
        radiance=(zeros, zeros, zeros),
        alive=jnp.ones((R,), bool),
        rays_traced=jnp.float32(0.0),
    )

    def cond(st: _TraceState):
        return (st.bounce < max_depth) & jnp.any(st.alive)

    def body(st: _TraceState) -> _TraceState:
        U = artrng.uniform(artrng.fold(key, 1000 + st.bounce), (ncols, R))
        o, d, throughput, radiance, survived = _bounce_step(
            tables, st.origin, st.direction, st.time,
            st.throughput, st.radiance, st.alive,
            (U[0], U[1], U[2]), U[_U_CHOICE], U[_U_MEDIA:],
            background, gradient_bg,
        )
        return _TraceState(
            bounce=st.bounce + 1,
            origin=o,
            direction=d,
            time=st.time,
            throughput=throughput,
            radiance=radiance,
            alive=survived,
            rays_traced=st.rays_traced + jnp.sum(st.alive.astype(jnp.float32)),
        )

    final = jax.lax.while_loop(cond, body, state)
    return jnp.stack(final.radiance, axis=-1), final.rays_traced


# ---------------------------------------------------------------------------
# Persistent-wavefront renderer (the production path)
# ---------------------------------------------------------------------------


class _PoolState(NamedTuple):
    it: jnp.ndarray  # () int32 iteration counter (keys the RNG block)
    next_q: jnp.ndarray  # () int32 global queue head
    o: tuple  # 3 x (R,)
    d: tuple  # 3 x (R,)
    tm: jnp.ndarray  # (R,)
    throughput: tuple  # 3 x (R,)
    radiance: tuple  # 3 x (R,)
    bounce: jnp.ndarray  # (R,) int32
    pix: jnp.ndarray  # (R,) int32 destination row in fb
    active: jnp.ndarray  # (R,) bool
    fb: jnp.ndarray  # (P,3) radiance accumulator
    rays: jnp.ndarray  # () float32 cumulative traced segments


def flush(fb, pix, died, radiance, mode: str, n_pixels: int):
    """Add the radiance of the rays that ``died`` this iteration to their
    framebuffer rows ``pix``; several rays may hit one row.  ``fb`` has the
    layout ``mode`` keeps (see ``render_wavefront``)."""
    if _NO_FLUSH:  # perf-debug only: wrong image
        return jax.tree_util.tree_map(
            lambda f: f.reshape(-1).at[0].add(
                jnp.sum(jnp.where(died, radiance[0], 0.0))
            ).reshape(f.shape),
            fb,
        )
    if mode == "planar":
        return tuple(
            fb[c].at[pix].add(jnp.where(died, radiance[c], 0.0))
            for c in range(3)
        )
    if mode == "planar_drop":
        pix_w = jnp.where(died, pix, n_pixels)
        return tuple(
            fb[c].at[pix_w].add(radiance[c], mode="drop") for c in range(3)
        )
    if mode == "subslot":
        # collision-light: K sub-accumulators per pixel keyed by slot % K —
        # two in-flight samples of one pixel collide only when their slots
        # are congruent mod K
        payload = jnp.stack(
            [jnp.where(died, radiance[c], 0.0) for c in range(3)], axis=-1
        )
        idx = pix * _SUBSLOTS + (_SLOT_IOTA[: pix.shape[0]] & (_SUBSLOTS - 1))
        return fb.at[idx].add(payload)
    if mode == "aos4":
        # 16-byte-aligned rows: pad the payload to 4 lanes
        payload = jnp.stack(
            [jnp.where(died, radiance[c], 0.0) for c in range(3)]
            + [jnp.zeros_like(radiance[0])],
            axis=-1,
        )
        return fb.at[pix].add(payload)
    if mode == "drop":
        # non-died lanes write out of range and are dropped: fewer
        # effective writes and no where-masking of the payload
        pix_w = jnp.where(died, pix, n_pixels)
        return fb.at[pix_w].add(jnp.stack(radiance, axis=-1), mode="drop")
    # "aos" (default)
    payload = jnp.stack(
        [jnp.where(died, radiance[c], 0.0) for c in range(3)], axis=-1
    )
    return fb.at[pix].add(payload)


def flush_init(mode: str, n_pixels: int):
    """Empty framebuffer in the layout of flush ``mode``."""
    if mode.startswith("planar"):
        return tuple(jnp.zeros((n_pixels,), jnp.float32) for _ in range(3))
    rows = n_pixels * _SUBSLOTS if mode == "subslot" else n_pixels
    return jnp.zeros((rows, 4 if mode == "aos4" else 3), jnp.float32)


def flush_result(fb, mode: str, n_pixels: int) -> jnp.ndarray:
    """(n_pixels, 3) radiance sums from a framebuffer of flush ``mode``."""
    if isinstance(fb, tuple):
        return jnp.stack(fb, axis=-1)
    if mode == "subslot":
        return fb.reshape(n_pixels, _SUBSLOTS, 3).sum(axis=1)
    return fb[:, :3]


def render_wavefront(
    tables: SceneTables,
    cam: Camera,
    pix_offset,  # () int32 first pixel id of this tile (traced)
    spp: int,
    key: jax.Array,
    background: jnp.ndarray,
    *,
    tile_pixels: int,
    total_pixels: int,
    nx: int,
    ny: int,
    max_depth: int,
    gradient_bg: bool,
    n_slots: int,
):
    """Render tile_pixels x spp samples with a persistent R-slot ray pool.

    Returns (fb_sum (tile_pixels,3) — radiance *summed* over spp,
    rays_traced (), iterations ())."""
    P = tile_pixels
    R = n_slots
    n_q = P * spp
    ncols = _n_uniform_cols(tables)
    # Safety bound: every queue element costs <= max_depth iterations.
    max_iters = (n_q * max_depth) // R + max_depth + 2
    _FLUSH = _FLUSH_ENV

    ones = jnp.ones((R,), jnp.float32)
    zeros = jnp.zeros((R,), jnp.float32)
    state = _PoolState(
        it=jnp.int32(0),
        next_q=jnp.int32(0),
        o=(zeros, zeros, zeros),
        d=(zeros, zeros, ones),
        tm=zeros,
        throughput=(ones, ones, ones),
        radiance=(zeros, zeros, zeros),
        bounce=jnp.zeros((R,), jnp.int32),
        pix=jnp.zeros((R,), jnp.int32),
        active=jnp.zeros((R,), bool),
        fb=flush_init(_FLUSH, P),
        rays=jnp.float32(0.0),
    )

    def cond(st: _PoolState):
        return ((st.next_q < n_q) | jnp.any(st.active)) & (st.it < max_iters)

    def body(st: _PoolState) -> _PoolState:
        # ---- refill dead slots from the global queue ----
        U = artrng.uniform(artrng.fold(key, st.it), (ncols, R))
        u_ball = (U[0], U[1], U[2])
        u_choice = U[_U_CHOICE]
        u_media = U[_U_MEDIA:]
        dead = ~st.active
        dead_i = dead.astype(jnp.int32)
        rank = jnp.cumsum(dead_i) - dead_i  # exclusive prefix among dead
        q = st.next_q + rank
        take = dead & (q < n_q)
        # sample-major: spp consecutive queue ids share a pixel, so live
        # pixels form a monotone band
        p_row = q // spp
        pixel = jnp.minimum(pix_offset + p_row, total_pixels - 1)
        i = (pixel % nx).astype(jnp.float32)
        j = (pixel // nx).astype(jnp.float32)
        s = (i + U[_U_JITTER0]) / nx
        t = (j + U[_U_JITTER1]) / ny
        o_new, d_new, tm_new = rays_from_uniforms_p(
            cam, s, t, U[_U_LENS0], U[_U_LENS1], U[_U_TIME]
        )

        o = p_where(take, o_new, st.o)
        d = p_where(take, d_new, st.d)
        tm = jnp.where(take, tm_new, st.tm)
        throughput = p_where(take, (ones, ones, ones), st.throughput)
        radiance = p_where(take, (zeros, zeros, zeros), st.radiance)
        bounce = jnp.where(take, 0, st.bounce)
        pix = jnp.where(take, p_row, st.pix)
        active = st.active | take
        next_q = st.next_q + jnp.sum(take.astype(jnp.int32))

        # ---- one bounce for the whole pool ----
        o2, d2, throughput, radiance, survived = _bounce_step(
            tables, o, d, tm, throughput, radiance, active,
            u_ball, u_choice, u_media, background, gradient_bg,
        )
        bounce = bounce + active.astype(jnp.int32)
        still_alive = survived & (bounce < max_depth)

        # ---- flush newly-terminated rays to the framebuffer ----
        died = active & ~still_alive
        fb = flush(st.fb, pix, died, radiance, _FLUSH, P)

        return _PoolState(
            it=st.it + 1,
            next_q=next_q,
            o=o2,
            d=d2,
            tm=tm,
            throughput=throughput,
            radiance=radiance,
            bounce=bounce,
            pix=pix,
            active=still_alive,
            fb=fb,
            rays=st.rays + jnp.sum(active.astype(jnp.float32)),
        )

    final = jax.lax.while_loop(cond, body, state)
    return flush_result(final.fb, _FLUSH, P), final.rays, final.it
