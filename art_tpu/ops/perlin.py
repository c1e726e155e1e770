"""Hash-based gradient Perlin noise, bit-reproducing the reference hashes.

The reference uses permutation-table-free gradient noise built from integer
hashes (wanghash + spatial mix, reference src/perlin.cuh:6-32).  The hashes
below are the same uint32 arithmetic, vectorized over point batches, so the
procedural textures are deterministic and bit-comparable with the CUDA
build (up to libm sin/pow differences in downstream texture formulas).
"""

from __future__ import annotations

import jax.numpy as jnp

_U32 = jnp.uint32


def wanghash(x: jnp.ndarray) -> jnp.ndarray:
    """Wang hash on uint32 (reference src/perlin.cuh:6-13)."""
    x = x.astype(_U32)
    x = (x ^ _U32(61)) ^ (x >> 16)
    x = x * _U32(9)
    x = x ^ (x >> 4)
    x = x * _U32(0x27D4EB2D)
    x = x ^ (x >> 15)
    return x


def mix3(x: jnp.ndarray, y: jnp.ndarray, z: jnp.ndarray) -> jnp.ndarray:
    """Spatial lattice hash (reference src/perlin.cuh:14-16)."""
    return (
        x.astype(_U32) * _U32(73856093)
        ^ y.astype(_U32) * _U32(19349663)
        ^ z.astype(_U32) * _U32(83492791)
    )


def u2m11(h: jnp.ndarray) -> jnp.ndarray:
    """Map uint32 -> [-1, 1] using the upper-24-bit trick (src/perlin.cuh:18-21)."""
    bits = (h >> 8) & _U32(0x00FFFFFF)
    return bits.astype(jnp.float32) * jnp.float32(1.0 / 8388607.5) - 1.0


def grad_p(xi: jnp.ndarray, yi: jnp.ndarray, zi: jnp.ndarray):
    """Pseudo-random unit gradient per lattice point (src/perlin.cuh:28-32).

    Returns a 3-tuple of component planes."""
    h = wanghash(mix3(xi, yi, zi))
    gx = u2m11(h)
    gy = u2m11(wanghash(h))
    gz = u2m11(wanghash(h ^ _U32(0x9E3779B9)))
    inv = 1.0 / jnp.sqrt(jnp.maximum(gx * gx + gy * gy + gz * gz, 1e-30))
    return gx * inv, gy * inv, gz * inv


def grad(xi, yi, zi) -> jnp.ndarray:
    gx, gy, gz = grad_p(xi, yi, zi)
    return jnp.stack([gx, gy, gz], axis=-1)


def _smooth(t: jnp.ndarray) -> jnp.ndarray:
    return t * t * (3.0 - 2.0 * t)


def noise_p(px, py, pz) -> jnp.ndarray:
    """Gradient noise over component planes (src/perlin.cuh:34-70)."""
    fx, fy, fz = jnp.floor(px), jnp.floor(py), jnp.floor(pz)
    u, v, w = px - fx, py - fy, pz - fz
    i = fx.astype(jnp.int32)
    j = fy.astype(jnp.int32)
    k = fz.astype(jnp.int32)

    uu, vv, ww = _smooth(u), _smooth(v), _smooth(w)
    accum = jnp.zeros_like(px)
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                gx, gy, gz = grad_p(i + di, j + dj, k + dk)
                s = (
                    (uu if di else (1.0 - uu))
                    * (vv if dj else (1.0 - vv))
                    * (ww if dk else (1.0 - ww))
                )
                accum = accum + s * (
                    gx * (u - di) + gy * (v - dj) + gz * (w - dk)
                )
    return accum


def noise(p: jnp.ndarray) -> jnp.ndarray:
    """(..., 3) wrapper over noise_p."""
    return noise_p(p[..., 0], p[..., 1], p[..., 2])


def turb_p(px, py, pz, depth: int, depth_mask: jnp.ndarray | None = None) -> jnp.ndarray:
    """Turbulence |sum w_i * noise(2^i p)| (src/perlin.cuh:72-82).

    ``depth`` is the static unroll bound; ``depth_mask`` (optional, (...,)
    int32) zeroes octaves at index >= per-point depth so textures with
    different octave counts can share one evaluation."""
    accum = jnp.zeros_like(px)
    weight = 1.0
    for i in range(depth):
        term = weight * noise_p(px, py, pz)
        if depth_mask is not None:
            term = jnp.where(i < depth_mask, term, 0.0)
        accum = accum + term
        weight *= 0.5
        px, py, pz = px * 2.0, py * 2.0, pz * 2.0
    return jnp.abs(accum)


def turb(p: jnp.ndarray, depth: int, depth_mask: jnp.ndarray | None = None) -> jnp.ndarray:
    return turb_p(p[..., 0], p[..., 1], p[..., 2], depth, depth_mask)
