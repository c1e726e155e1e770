"""Masked material shading — emission + scatter for the whole wavefront.

Replaces the reference's virtual ``material::scatter/emitted`` dispatch
(reference src/material.cuh:46-201) with type-tag masking over
component-planar ray batches: every material family present is evaluated
for the full batch and blended by mask.  Random draws come from raw uniform
columns (see the integrator's per-iteration block), with the rejection
loops replaced by equal-distribution analytic samplers.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from art_tpu.core.vecmath import (
    p_dot,
    p_length,
    p_reflect,
    p_refract,
    p_scale,
    p_stack,
    p_sub,
    p_unit,
    p_unstack,
    p_where,
    schlick,
)
from art_tpu.ops.intersect import HitRecord, HitRecordP
from art_tpu.ops.texture_eval import eval_texture_p
from art_tpu.scene.tables import MatType, SceneTables


class ScatterResultP(NamedTuple):
    emitted: tuple  # 3 x (R,) emission at the hit
    attenuation: tuple  # 3 x (R,)
    direction: tuple  # 3 x (R,) new ray direction (unnormalized, as in reference)
    scattered: jnp.ndarray  # (R,) bool — False = absorbed (light / fuzzy-metal graze)


def _ball_from_uniforms_p(u0, u1, u2):
    """Uniform-in-ball sample from three U[0,1) planes (see core.rng)."""
    z = 2.0 * u0 - 1.0
    phi = (2.0 * jnp.pi) * u1
    s = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    r = jnp.cbrt(u2)
    return (r * s * jnp.cos(phi), r * s * jnp.sin(phi), r * z)


def shade_params_p(tables: SceneTables, rec: HitRecordP):
    """Per-ray material/texture parameter fetch: one packed row fetch for
    all material parameters (ops/gather.py layout
    [type, tex, fuzz, ref_idx, r, g, b, _]) plus one texture evaluation
    (serves lambertian/isotropic attenuation and diffuse_light emission —
    all are texture-backed rows).

    Returns (mtype f32, fuzz, ref_idx, metal_albedo 3-tuple,
    tex_val 3-tuple)."""
    from art_tpu.ops.gather import take_rows

    mrow = take_rows(tables.mat_packed, rec.mat)
    tex_id = mrow[:, 1].astype(jnp.int32)
    tex_val = eval_texture_p(tables, tex_id, rec.u, rec.v, rec.p)
    return (mrow[:, 0], mrow[:, 2], mrow[:, 3],
            (mrow[:, 4], mrow[:, 5], mrow[:, 6]), tex_val)


def shade_p(
    tables: SceneTables,
    d,  # 3-tuple of (R,) planes: incoming ray direction
    rec: HitRecordP,
    u_ball,  # 3-tuple of (R,) uniforms
    u_choice: jnp.ndarray,  # (R,)
) -> ScatterResultP:
    mtype_f, fuzz, ref_idx, metal_albedo, tex_val = shade_params_p(tables, rec)
    mtype = mtype_f.astype(jnp.int32)
    n = rec.normal

    is_metal = mtype == MatType.METAL
    is_dielectric = mtype == MatType.DIELECTRIC
    is_light = mtype == MatType.DIFFUSE_LIGHT
    is_isotropic = mtype == MatType.ISOTROPIC

    # ---- emission (src/material.cuh:169-172): lights only ----
    zero = jnp.zeros_like(u_choice)
    emitted = p_where(is_light, tex_val, (zero, zero, zero))

    # ---- shared samples ----
    ball = _ball_from_uniforms_p(*u_ball)

    # ---- lambertian (src/material.cuh:75-87): dir = n + ball ----
    lambert_dir = (n[0] + ball[0], n[1] + ball[1], n[2] + ball[2])

    # ---- metal (src/material.cuh:90-110) ----
    metal_refl = p_reflect(p_unit(d), n)
    metal_dir = (
        metal_refl[0] + fuzz * ball[0],
        metal_refl[1] + fuzz * ball[1],
        metal_refl[2] + fuzz * ball[2],
    )
    metal_alive = p_dot(metal_dir, n) > 0.0

    # ---- dielectric (src/material.cuh:113-159), book-1 form ----
    d_dot_n = p_dot(d, n)
    inside = d_dot_n > 0.0
    outward_n = p_where(inside, (-n[0], -n[1], -n[2]), n)
    ni_over_nt = jnp.where(inside, ref_idx, 1.0 / ref_idx)
    dlen = p_length(d)
    cos_raw = d_dot_n / dlen
    cos_inside = jnp.sqrt(
        jnp.maximum(0.0, 1.0 - ref_idx * ref_idx * (1.0 - cos_raw * cos_raw))
    )
    cosine = jnp.where(inside, cos_inside, -cos_raw)
    can_refract, refracted = p_refract(d, outward_n, ni_over_nt)
    reflect_prob = jnp.where(can_refract, schlick(cosine, ref_idx), 1.0)
    diel_reflect = u_choice < reflect_prob
    diel_dir = p_where(diel_reflect, p_reflect(d, n), refracted)

    # ---- blend by material tag ----
    direction = lambert_dir
    direction = p_where(is_metal, metal_dir, direction)
    direction = p_where(is_dielectric, diel_dir, direction)
    direction = p_where(is_isotropic, ball, direction)

    attenuation = tex_val  # lambertian / isotropic
    attenuation = p_where(is_metal, metal_albedo, attenuation)
    one = jnp.ones_like(u_choice)
    attenuation = p_where(is_dielectric, (one, one, one), attenuation)

    scattered = ~is_light & (~is_metal | metal_alive)
    return ScatterResultP(
        emitted=emitted,
        attenuation=attenuation,
        direction=direction,
        scattered=scattered,
    )


class ScatterResult(NamedTuple):
    """Array-of-struct result (portable API, used by tests)."""

    emitted: jnp.ndarray
    attenuation: jnp.ndarray
    direction: jnp.ndarray
    scattered: jnp.ndarray


def shade(
    tables: SceneTables,
    d: jnp.ndarray,  # (R,3)
    rec: HitRecord,
    u_ball: jnp.ndarray,  # (R,3)
    u_choice: jnp.ndarray,  # (R,)
) -> ScatterResult:
    out = shade_p(
        tables, p_unstack(d), rec.to_planar(), p_unstack(u_ball), u_choice
    )
    return ScatterResult(
        emitted=p_stack(out.emitted),
        attenuation=p_stack(out.attenuation),
        direction=p_stack(out.direction),
        scattered=out.scattered,
    )
