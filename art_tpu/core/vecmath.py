"""Batched 3-vector math over ``(..., 3)`` arrays.

Vectorized analog of the reference ``vec3`` class (reference src/vec3.cuh:8-158):
instead of a 3-float struct with operator overloads, every quantity is a jnp
array whose last axis has size 3, and all helpers broadcast over leading
(ray-batch) axes.  No classes — pure functions only, so everything fuses
under jit.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Large finite stand-in for FLT_MAX in interval math (reference uses FLT_MAX,
# src/main.cu:57).  Using 3.4e38 exactly risks inf on arithmetic; 1e30 is far
# beyond any scene extent (max ~5000).  Host scalars (not jnp) so importing
# the module never initializes a backend.
BIG = np.float32(1e30)
T_MIN = np.float32(1e-3)  # reference t_min = 0.001 (src/main.cu:57)


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the trailing axis (reference src/vec3.cuh:92)."""
    return jnp.sum(a * b, axis=-1)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched cross product (reference src/vec3.cuh:97-101)."""
    return jnp.cross(a, b)


def length(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(dot(a, a))


def squared_length(a: jnp.ndarray) -> jnp.ndarray:
    return dot(a, a)


def unit_vector(a: jnp.ndarray) -> jnp.ndarray:
    """Normalize over trailing axis (reference src/vec3.cuh:155-158).

    Matches the reference exactly: divides by the length with no epsilon
    guard (a zero vector yields inf/nan, as in CUDA).
    """
    return a / length(a)[..., None]


def reflect(v: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Mirror reflection (reference src/material.cuh:20-23)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(v: jnp.ndarray, n: jnp.ndarray, ni_over_nt: jnp.ndarray):
    """Snell refraction in the reference's book-1 form (src/material.cuh:26-36).

    Returns ``(ok, refracted)`` where ``ok`` is the total-internal-reflection
    test ``disc > 0`` and ``refracted`` is only meaningful where ``ok``.
    """
    uv = unit_vector(v)
    dt = dot(uv, n)
    disc = 1.0 - ni_over_nt * ni_over_nt * (1.0 - dt * dt)
    ok = disc > 0.0
    safe_disc = jnp.maximum(disc, 0.0)
    refracted = (
        ni_over_nt[..., None] * (uv - n * dt[..., None])
        - n * jnp.sqrt(safe_disc)[..., None]
    )
    return ok, refracted


def schlick(cosine: jnp.ndarray, ref_idx: jnp.ndarray) -> jnp.ndarray:
    """Schlick reflectance approximation (reference src/material.cuh:38-43).

    (1-c)^5 is expanded to multiplies — jnp.power lowers to
    exp(5*log x)."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    x = 1.0 - cosine
    x2 = x * x
    return r0 + (1.0 - r0) * (x2 * x2 * x)


def ray_at(origin: jnp.ndarray, direction: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """point_at_parameter: A + t*B (reference src/ray.cuh:18)."""
    return origin + t[..., None] * direction


# ---------------------------------------------------------------------------
# Component-planar ("SoA of SoA") vector helpers.
#
# The hot path represents a vector batch as a 3-tuple of (R,) planes:
# every elementwise op then streams contiguous (R,) arrays instead of a
# strided (R, 3) layout.  The (R, 3) API above remains the portable reference used by
# the tests and the scene compiler.
# ---------------------------------------------------------------------------


def p_unstack(a: jnp.ndarray):
    """(..., 3) -> ((...,), (...,), (...,)) planes."""
    return (a[..., 0], a[..., 1], a[..., 2])


def p_stack(p) -> jnp.ndarray:
    return jnp.stack(p, axis=-1)


def p_dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def p_cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def p_add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def p_sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def p_mul(a, b):
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def p_scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def p_where(mask, a, b):
    return (
        jnp.where(mask, a[0], b[0]),
        jnp.where(mask, a[1], b[1]),
        jnp.where(mask, a[2], b[2]),
    )


def p_length(a):
    return jnp.sqrt(p_dot(a, a))


def p_unit(a):
    inv = 1.0 / p_length(a)
    return p_scale(a, inv)


def p_reflect(v, n):
    return p_sub(v, p_scale(n, 2.0 * p_dot(v, n)))


def p_refract(v, n, ni_over_nt):
    """Planar version of refract(); returns (ok, refracted-tuple)."""
    uv = p_unit(v)
    dt = p_dot(uv, n)
    disc = 1.0 - ni_over_nt * ni_over_nt * (1.0 - dt * dt)
    ok = disc > 0.0
    root = jnp.sqrt(jnp.maximum(disc, 0.0))
    refracted = p_sub(p_scale(p_sub(uv, p_scale(n, dt)), ni_over_nt), p_scale(n, root))
    return ok, refracted


def p_ray_at(o, d, t):
    return (o[0] + t * d[0], o[1] + t * d[1], o[2] + t * d[2])


def p_rotate_y(p, cos_t, sin_t):
    return (cos_t * p[0] + sin_t * p[2], p[1], -sin_t * p[0] + cos_t * p[2])


def p_rotate_y_inv(p, cos_t, sin_t):
    return (cos_t * p[0] - sin_t * p[2], p[1], sin_t * p[0] + cos_t * p[2])


def rotate_y(p: jnp.ndarray, cos_t: jnp.ndarray, sin_t: jnp.ndarray) -> jnp.ndarray:
    """Rotate about +Y: world = R(theta) * local (reference src/main.cu:491-496).

    ``cos_t``/``sin_t`` broadcast against the leading axes of ``p``.
    """
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return jnp.stack(
        [cos_t * x + sin_t * z, y, -sin_t * x + cos_t * z], axis=-1
    )


def rotate_y_inv(p: jnp.ndarray, cos_t: jnp.ndarray, sin_t: jnp.ndarray) -> jnp.ndarray:
    """Inverse Y rotation: local = R(-theta) * world (reference src/hittable.cuh:118-127)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return jnp.stack(
        [cos_t * x - sin_t * z, y, sin_t * x + cos_t * z], axis=-1
    )
