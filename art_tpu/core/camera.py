"""Thin-lens + motion-blur camera as a pure ray-generation function.

Vectorized redesign of the reference ``camera`` class (src/camera.cuh:18-79):
the camera is a small frozen parameter bundle; ``generate_rays`` maps a batch
of (pixel, jitter) samples to a SoA ray batch in one vectorized pass.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp

from art_tpu.core import rng as artrng
from art_tpu.core.vecmath import cross, unit_vector


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Camera:
    """Precomputed camera frame (reference src/camera.cuh:59-78)."""

    origin: jnp.ndarray  # (3,)
    lower_left_corner: jnp.ndarray  # (3,)
    horizontal: jnp.ndarray  # (3,)
    vertical: jnp.ndarray  # (3,)
    u: jnp.ndarray  # (3,)
    v: jnp.ndarray  # (3,)
    w: jnp.ndarray  # (3,)
    lens_radius: jnp.ndarray  # ()
    time0: jnp.ndarray  # ()
    time1: jnp.ndarray  # ()


def make_camera(
    lookfrom,
    lookat,
    vup,
    vfov_degrees: float,
    aspect: float,
    aperture: float = 0.0,
    focus_dist: float | None = None,
    time0: float = 0.0,
    time1: float = 0.0,
) -> Camera:
    """Build the camera basis exactly as the reference init (src/camera.cuh:59-78)."""
    lookfrom = jnp.asarray(lookfrom, jnp.float32)
    lookat = jnp.asarray(lookat, jnp.float32)
    vup = jnp.asarray(vup, jnp.float32)
    if focus_dist is None:
        focus_dist = float(jnp.linalg.norm(lookfrom - lookat))

    lens_radius = jnp.float32(aperture * 0.5)
    theta = vfov_degrees * math.pi / 180.0
    half_height = math.tan(theta * 0.5)
    half_width = aspect * half_height

    origin = lookfrom
    w = unit_vector(lookfrom - lookat)
    u = unit_vector(cross(vup, w))
    v = cross(w, u)

    lower_left_corner = (
        origin
        - half_width * focus_dist * u
        - half_height * focus_dist * v
        - focus_dist * w
    )
    horizontal = 2.0 * half_width * focus_dist * u
    vertical = 2.0 * half_height * focus_dist * v

    return Camera(
        origin=origin,
        lower_left_corner=lower_left_corner,
        horizontal=horizontal,
        vertical=vertical,
        u=u,
        v=v,
        w=w,
        lens_radius=lens_radius,
        time0=jnp.float32(time0),
        time1=jnp.float32(time1),
    )


def rays_from_uniforms_p(
    cam: Camera,
    s: jnp.ndarray,
    t: jnp.ndarray,
    u_lens0: jnp.ndarray,  # (R,)
    u_lens1: jnp.ndarray,  # (R,)
    u_time: jnp.ndarray,  # (R,)
):
    """Batched get_ray (reference src/camera.cuh:35-47), component-planar.

    ``s``/``t`` are (R,) viewport coordinates in [0,1] (already jittered).
    Returns (o 3-tuple, d 3-tuple, times).  Directions are *not* normalized,
    matching the reference.
    """
    r = cam.lens_radius * jnp.sqrt(u_lens0)
    phi = (2.0 * jnp.pi) * u_lens1
    rdx = r * jnp.cos(phi)
    rdy = r * jnp.sin(phi)
    times = cam.time0 + u_time * (cam.time1 - cam.time0)

    o = tuple(cam.origin[c] + rdx * cam.u[c] + rdy * cam.v[c] for c in range(3))
    d = tuple(
        cam.lower_left_corner[c]
        + s * cam.horizontal[c]
        + t * cam.vertical[c]
        - o[c]
        for c in range(3)
    )
    return o, d, times


def rays_from_uniforms(
    cam: Camera,
    s: jnp.ndarray,
    t: jnp.ndarray,
    u_lens: jnp.ndarray,  # (R,2)
    u_time: jnp.ndarray,  # (R,)
):
    """(R,3) wrapper over rays_from_uniforms_p."""
    o, d, times = rays_from_uniforms_p(cam, s, t, u_lens[:, 0], u_lens[:, 1], u_time)
    return jnp.stack(o, axis=-1), jnp.stack(d, axis=-1), times


def generate_rays(cam: Camera, s: jnp.ndarray, t: jnp.ndarray, key: jax.Array):
    """Key-based convenience wrapper over rays_from_uniforms."""
    n = s.shape[0]
    u_lens = artrng.uniform(artrng.fold(key, artrng.SITE_LENS), (n, 2))
    u_time = artrng.uniform(artrng.fold(key, artrng.SITE_TIME), (n,))
    return rays_from_uniforms(cam, s, t, u_lens, u_time)
