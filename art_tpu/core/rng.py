"""Counter-based random sampling for the wavefront tracer.

Stateless replacement for the reference's per-pixel mutable curandState
(reference src/main.cu:89-105, README "RNG discipline"): every random draw
is produced from a threefry key folded with static *site* identifiers —
``fold(master, tile, chunk, bounce, site)`` — so the whole render is a pure
function of one seed, with full statistical independence across pixels,
samples, bounces, and sample sites.  No state is read or written.

The reference's rejection loops are replaced with analytic equal-distribution
samplers:

* ``random_in_unit_disk`` (reference src/camera.cuh:8-16, rejection) →
  polar inversion ``(sqrt(u1), 2*pi*u2)``;
* ``random_in_unit_sphere`` — uniform in the unit *ball* (reference
  src/material.cuh:12-18, rejection) → gaussian direction x cbrt-radius.

Both produce exactly the uniform distribution the rejection loops converge
to, with zero divergence — no lane idles in a retry loop.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Stable site identifiers so fold chains never collide between sample sites.
SITE_JITTER = 1
SITE_LENS = 2
SITE_TIME = 3
SITE_SCATTER = 4
SITE_CHOICE = 5
SITE_MEDIUM = 6


def fold(key: jax.Array, *ids: int) -> jax.Array:
    """Fold a chain of identifiers into a key (order-sensitive)."""
    for i in ids:
        key = jax.random.fold_in(key, i)
    return key


def uniform(key: jax.Array, shape) -> jnp.ndarray:
    """U[0,1) float32 block."""
    return jax.random.uniform(key, shape, dtype=jnp.float32)


def random_in_unit_disk(key: jax.Array, n: int) -> jnp.ndarray:
    """(n, 2) points uniform in the unit disk.

    Equal in distribution to the reference rejection sampler
    (src/camera.cuh:8-16) but branch-free.
    """
    return disk_from_uniforms(uniform(key, (n, 2)))


def random_in_unit_ball(key: jax.Array, n: int) -> jnp.ndarray:
    """(n, 3) points uniform inside the unit ball.

    Equal in distribution to the reference's ``random_in_unit_sphere``
    rejection loop (src/material.cuh:12-18).
    """
    return ball_from_uniforms(uniform(key, (n, 3)))


def ball_from_uniforms(u: jnp.ndarray) -> jnp.ndarray:
    """Map (n, 3) U[0,1) to points uniform in the unit ball, analytically.

    z = 2u1-1 (uniform cos-theta), phi = 2*pi*u2 give a uniform direction on
    the sphere; r = u3^(1/3) gives the radial CDF of the ball.  Branch-free
    equal-distribution replacement for the reference rejection loop.
    """
    z = 2.0 * u[:, 0] - 1.0
    phi = (2.0 * jnp.pi) * u[:, 1]
    s = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    r = jnp.cbrt(u[:, 2])
    return jnp.stack(
        [r * s * jnp.cos(phi), r * s * jnp.sin(phi), r * z], axis=-1
    )


def disk_from_uniforms(u: jnp.ndarray) -> jnp.ndarray:
    """Map (n, 2) U[0,1) to points uniform in the unit disk."""
    r = jnp.sqrt(u[:, 0])
    phi = (2.0 * jnp.pi) * u[:, 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi)], axis=-1)
