"""Flat SoA scene tables — the wavefront's scene representation.

The reference builds a device-side object graph with virtual dispatch
(``hittable**`` lists + ``bvh_node`` built by a <<<1,1>>> kernel,
reference src/main.cu:160-635).  A wavefront intersects each primitive
type for the whole ray batch at once, so the whole scene compiles
host-side into type-segmented flat tables:

* spheres   — center0/velocity/signed-radius/material (src/sphere.cuh:21-38);
* quads     — Q/u/v/w/normal/D/material with instancing *baked in* at build
  time: a ``translate(rotate_y(quad))`` is exactly an affinely transformed
  quad, so no per-ray transform work remains (src/hittable.cuh:40-149);
* boxes     — oriented boxes (object-space AABB + y-rotation + offset),
  a redesign of the reference ``compound6`` 6-quad container
  (src/quad.cuh:94-162): one slab test replaces six quad tests;
* media     — constant-density participating media keyed by a convex
  boundary (sphere or oriented box), replacing the reference
  ``constant_medium`` double-traversal (src/constant_medium.cuh:36-64);
* materials — integer-tagged rows replacing the material vtable
  (src/material.cuh:46-201);
* textures  — integer-tagged rows with child links replacing the texture
  vtable (src/texture.cuh:9-164).

Counts are static pytree metadata so per-scene jit specializes away empty
segments.
"""

from __future__ import annotations

import dataclasses
from dataclasses import field
from enum import IntEnum

import jax
import jax.numpy as jnp

from art_tpu.utils.images import ImageAtlas


class MatType(IntEnum):
    """Material tags (replaces the material vtable, src/material.cuh:46-201)."""

    LAMBERTIAN = 0
    METAL = 1
    DIELECTRIC = 2
    DIFFUSE_LIGHT = 3
    ISOTROPIC = 4


class TexType(IntEnum):
    """Texture tags (replaces the texture vtable, src/texture.cuh:9-164)."""

    SOLID = 0
    CHECKER = 1
    IMAGE = 2
    NOISE = 3
    NOODLE = 4
    FELT = 5
    UV_OFFSET = 6


def _static():
    return field(metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SceneTables:
    # ---- spheres (reference src/sphere.cuh) ----
    sph_center: jnp.ndarray  # (S,3) center at t=0
    sph_vel: jnp.ndarray  # (S,3) center(t) = center + t*vel
    sph_radius: jnp.ndarray  # (S,) SIGNED (negative radius = inward normals, src/main.cu:439)
    sph_mat: jnp.ndarray  # (S,) int32

    # ---- quads (reference src/quad.cuh; instancing baked in) ----
    quad_q: jnp.ndarray  # (Q,3)
    quad_u: jnp.ndarray  # (Q,3)
    quad_v: jnp.ndarray  # (Q,3)
    quad_w: jnp.ndarray  # (Q,3)  n / dot(n,n)
    quad_n: jnp.ndarray  # (Q,3)  unit normal, inward flip applied
    quad_d: jnp.ndarray  # (Q,)   plane constant dot(n, Q)
    quad_mat: jnp.ndarray  # (Q,) int32
    # Precomputed triple-product vectors so the (alpha, beta) interior test
    # (src/quad.cuh:73-75) becomes pure (R,3)@(3,Q) matmuls:
    #   alpha = dot(w, cross(p-Q, v)) = dot(v x w, p) - dot(v x w, Q)
    #   beta  = dot(w, cross(u, p-Q)) = dot(w x u, p) - dot(w x u, Q)
    quad_avec: jnp.ndarray  # (Q,3)  v x w
    quad_bvec: jnp.ndarray  # (Q,3)  w x u
    quad_ca: jnp.ndarray  # (Q,)   dot(v x w, Q)
    quad_cb: jnp.ndarray  # (Q,)   dot(w x u, Q)

    # ---- oriented boxes (redesign of compound6, src/quad.cuh:94-162) ----
    box_min: jnp.ndarray  # (B,3) object-space AABB min
    box_max: jnp.ndarray  # (B,3)
    box_cos: jnp.ndarray  # (B,)  y-rotation cos (1 for axis-aligned)
    box_sin: jnp.ndarray  # (B,)  y-rotation sin (0 for axis-aligned)
    box_off: jnp.ndarray  # (B,3) world offset
    box_mat: jnp.ndarray  # (B,) int32

    # ---- constant media (reference src/constant_medium.cuh) ----
    med_kind: jnp.ndarray  # (C,) int32: 0=sphere boundary, 1=box boundary,
    #                         2=general boundary (gb_* tables; see med_kinds)
    med_center: jnp.ndarray  # (C,3) sphere center
    med_radius: jnp.ndarray  # (C,)
    med_min: jnp.ndarray  # (C,3) box bounds
    med_max: jnp.ndarray  # (C,3)
    med_cos: jnp.ndarray  # (C,)
    med_sin: jnp.ndarray  # (C,)
    med_off: jnp.ndarray  # (C,3)
    med_neg_inv_density: jnp.ndarray  # (C,)  -1/density
    med_mat: jnp.ndarray  # (C,) int32 (isotropic phase material)
    # General (kind-2) medium boundaries: the reference accepts ANY
    # hittable as a constant_medium boundary (src/constant_medium.cuh:16-34).
    # Media whose boundary does not reduce to one analytic sphere/box
    # compile their boundary subtree into these rows; apply_media_p
    # evaluates first/second closest hits over each medium's subset
    # brute-force (cold jnp path — no reference scene needs one).
    gb_sph: jnp.ndarray  # (Gs, 7)  [cx cy cz vx vy vz radius]
    gb_quad: jnp.ndarray  # (Gq, 16) [q(3) u(3) v(3) w(3) n(3) d]
    gb_box: jnp.ndarray  # (Gb, 11) [min(3) max(3) cos sin off(3)]

    # ---- materials ----
    mat_type: jnp.ndarray  # (M,) int32 MatType
    mat_tex: jnp.ndarray  # (M,) int32 texture id (lambertian/light/isotropic)
    mat_rgb: jnp.ndarray  # (M,3) metal albedo
    mat_fuzz: jnp.ndarray  # (M,) metal fuzz (clamped <= 1 at build)
    mat_ref_idx: jnp.ndarray  # (M,) dielectric index

    # ---- textures ----
    tex_type: jnp.ndarray  # (T,) int32 TexType
    tex_rgb: jnp.ndarray  # (T,3) solid color / felt base / noodle color
    tex_rgb2: jnp.ndarray  # (T,3) noodle gap color
    tex_params: jnp.ndarray  # (T,8) per-type scalar params
    tex_child: jnp.ndarray  # (T,2) int32 child texture ids (checker even/odd; uv_offset base)
    tex_img: jnp.ndarray  # (T,) int32 atlas image id
    atlas: ImageAtlas

    # ---- row-packed lookup tables (one fetch per bounce; see ops/gather) ----
    mat_packed: jnp.ndarray  # (M, 8)  [type tex fuzz ref_idx r g b mat?]
    tex_packed: jnp.ndarray  # (T, 18) [type p0..p7 child0 child1 img rgb(3) rgb2(3)]
    quad_attr_packed: jnp.ndarray  # (Q, 16) [q(3) u(3) v(3) w(3) n(3) mat]
    # (B, 12) [min(3) max(3) cos sin off(3) mat]; scenes without rotated
    # boxes fold the offset into min/max (off = 0)
    box_packed: jnp.ndarray
    # Flattened escape-link sphere BVH (ops/bvh.pack_bvh rows
    # [min(3) max(3) escape prim]) for the opt-in per-ray descent path
    # (ART_TPU_BVH=1, ops/intersect.bvh_sphere_candidates_p) — the direct
    # analog of the reference's bvh_node::hit (src/bvh.cuh:95-106).
    sph_bvh: jnp.ndarray  # (Mn, 8)

    # ---- static metadata (specializes the compiled trace per scene) ----
    n_spheres: int = _static()
    n_quads: int = _static()
    n_boxes: int = _static()
    n_media: int = _static()
    n_sph_bvh_nodes: int = _static()  # 0 = no sphere BVH built
    med_kinds: tuple = _static()  # per-medium boundary kind: 0=sphere, 1=box, 2=general
    # Per-primitive owning-medium ids of the kind-2 boundary tables (static
    # so the trace only visits each medium's own subset).
    gb_sph_meds: tuple = _static()
    gb_quad_meds: tuple = _static()
    gb_box_meds: tuple = _static()
    has_moving: bool = _static()
    has_rotated_boxes: bool = _static()
    tex_types_present: tuple = _static()  # sorted tuple of TexType ints present


def _z(shape, dtype=jnp.float32):
    return jnp.zeros(shape, dtype)


def empty_tables() -> dict:
    """One-row dummy segments; static counts of 0 gate them out of the trace."""
    return dict(
        sph_center=_z((1, 3)),
        sph_vel=_z((1, 3)),
        sph_radius=jnp.ones((1,), jnp.float32),
        sph_mat=_z((1,), jnp.int32),
        quad_q=_z((1, 3)),
        quad_u=jnp.asarray([[1.0, 0, 0]], jnp.float32),
        quad_v=jnp.asarray([[0, 1.0, 0]], jnp.float32),
        quad_w=jnp.asarray([[0, 0, 1.0]], jnp.float32),
        quad_n=jnp.asarray([[0, 0, 1.0]], jnp.float32),
        quad_d=_z((1,)),
        quad_mat=_z((1,), jnp.int32),
        quad_avec=jnp.asarray([[1.0, 0, 0]], jnp.float32),
        quad_bvec=jnp.asarray([[0, 1.0, 0]], jnp.float32),
        quad_ca=_z((1,)),
        quad_cb=_z((1,)),
        box_min=_z((1, 3)),
        box_max=jnp.ones((1, 3), jnp.float32),
        box_cos=jnp.ones((1,), jnp.float32),
        box_sin=_z((1,)),
        box_off=_z((1, 3)),
        box_mat=_z((1,), jnp.int32),
        med_kind=_z((1,), jnp.int32),
        med_center=_z((1, 3)),
        med_radius=jnp.ones((1,), jnp.float32),
        med_min=_z((1, 3)),
        med_max=jnp.ones((1, 3), jnp.float32),
        med_cos=jnp.ones((1,), jnp.float32),
        med_sin=_z((1,)),
        med_off=_z((1, 3)),
        med_neg_inv_density=-jnp.ones((1,), jnp.float32),
        med_mat=_z((1,), jnp.int32),
        gb_sph=_z((1, 7)),
        gb_quad=_z((1, 16)),
        gb_box=_z((1, 11)),
        mat_type=_z((1,), jnp.int32),
        mat_tex=_z((1,), jnp.int32),
        mat_rgb=jnp.ones((1, 3), jnp.float32),
        mat_fuzz=_z((1,)),
        mat_ref_idx=jnp.ones((1,), jnp.float32),
        tex_type=_z((1,), jnp.int32),
        tex_rgb=jnp.ones((1, 3), jnp.float32),
        tex_rgb2=_z((1, 3)),
        tex_params=_z((1, 8)),
        tex_child=_z((1, 2), jnp.int32),
        tex_img=_z((1,), jnp.int32),
        atlas=ImageAtlas.empty(),
        mat_packed=_z((1, 8)),
        tex_packed=_z((1, 18)),
        quad_attr_packed=_z((1, 16)),
        box_packed=_z((1, 12)),
        sph_bvh=_z((1, 8)),
        n_spheres=0,
        n_quads=0,
        n_boxes=0,
        n_media=0,
        n_sph_bvh_nodes=0,
        med_kinds=(),
        gb_sph_meds=(),
        gb_quad_meds=(),
        gb_box_meds=(),
        has_moving=False,
        has_rotated_boxes=False,
        tex_types_present=(),
    )
