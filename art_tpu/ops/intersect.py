"""Type-segmented batched intersection — the hot path of the tracer.

A wavefront inversion of the reference's virtual ``hit()`` dispatch
through a recursive BVH (reference src/bvh.cuh:95-106): each primitive type
is intersected for the *whole wavefront at once*, and the closest hit is a
masked min-reduction.  The layers:

* plain candidate passes per primitive family (``*_candidates_p``), left
  to XLA to fuse;
* winner attribute reconstruction (``*_attributes_p``) and the component-
  planar core (``closest_surface_p`` / ``apply_media_p``) on 3-tuples of
  (R,) planes, with array-of-struct wrappers (``closest_surface`` /
  ``apply_media``) keeping the portable (R, 3) API for tests.

Participating media (reference src/constant_medium.cuh:36-64) are resolved
after the surface pass: each medium's convex boundary yields an analytic
[entry, exit] interval — equivalent to the reference's two boundary
traversals — followed by masked exponential free-flight sampling.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp

from art_tpu.core.vecmath import (
    BIG,
    p_cross,
    p_dot,
    p_ray_at,
    p_rotate_y,
    p_rotate_y_inv,
    p_stack,
    p_unstack,
    p_where,
)
from art_tpu.scene.tables import SceneTables

_PARALLEL_EPS = 1e-8  # quad parallel-plane epsilon (src/quad.cuh:64)
_DIR_EPS = 1e-12  # slab-test division guard


class HitRecordP(NamedTuple):
    """Planar SoA hit record (reference src/hittable.cuh:13-21)."""

    hit: jnp.ndarray  # (R,) bool
    t: jnp.ndarray  # (R,)
    p: tuple  # 3 x (R,)
    normal: tuple  # 3 x (R,) shading normal
    u: jnp.ndarray  # (R,)
    v: jnp.ndarray  # (R,)
    mat: jnp.ndarray  # (R,) int32


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HitRecord:
    """Array-of-struct hit record (portable API)."""

    hit: jnp.ndarray
    t: jnp.ndarray
    p: jnp.ndarray  # (R,3)
    normal: jnp.ndarray  # (R,3)
    u: jnp.ndarray
    v: jnp.ndarray
    mat: jnp.ndarray

    def to_planar(self) -> HitRecordP:
        return HitRecordP(
            self.hit, self.t, p_unstack(self.p), p_unstack(self.normal),
            self.u, self.v, self.mat,
        )


def _to_aos(rec: HitRecordP) -> HitRecord:
    return HitRecord(
        rec.hit, rec.t, p_stack(rec.p), p_stack(rec.normal), rec.u, rec.v, rec.mat
    )


def _safe_dir(d: jnp.ndarray) -> jnp.ndarray:
    """Clamp direction components away from zero for slab division.

    Equivalent to the reference quad parallel-miss (src/quad.cuh:64): an
    exactly-parallel ray cannot enter/exit through that slab axis."""
    mag = jnp.abs(d)
    sign = jnp.where(d >= 0.0, 1.0, -1.0)
    return jnp.where(mag < _DIR_EPS, sign * _DIR_EPS, d)


# Per-ray BVH descent for spheres (opt-in, ART_TPU_BVH=1): the direct analog
# of the reference's log-n bvh_node::hit (src/bvh.cuh:95-106), kept wired
# through the render path to measure it against the brute passes.  Read
# once at import: it selects a trace-time code path.
_BVH_ENV = bool(os.environ.get("ART_TPU_BVH"))
# Per-primitive perf-debug ablation stubs (ART_TPU_DBG=fake_spheres /
# fake_boxes / fake_quads / fake_media): replace one candidate pass with
# cheap dependency-preserving arithmetic so the remaining passes' in-loop
# cost can be read off a per-iteration A/B.  Wrong image, measurement
# only — same contract as integrator's fake_intersect/fake_shade.
_DBG = os.environ.get("ART_TPU_DBG", "")


def _fake_candidates(o, d, tm):
    """Dependency-preserving stub pass: (t, normal, u, v, mat) from cheap
    arithmetic that XLA cannot fold away (depends on o, d, tm)."""
    t = jnp.abs(o[0] * 1e-6 + d[0]) + 5.0 + tm * 0.0
    z = jnp.zeros_like(t)
    return t, (z + 1.0, z, z), z, z, jnp.zeros(t.shape, jnp.int32)


# --------------------------------------------------------------------------
# Candidate passes (jnp reference implementations, planar inputs)
# --------------------------------------------------------------------------

def sphere_candidates_p(tables: SceneTables, o, d, time, t_min):
    """Best sphere hit per ray: (t_best (R,), idx (R,)).

    Half-b quadratic with the center evaluated at the ray's shutter time
    (reference src/sphere.cuh:51-89), expanded over (R,1)x(1,S) broadcasts.
    """
    c0 = tables.sph_center  # (S,3)
    r = tables.sph_radius  # (S,)
    ox, oy, oz = (c[:, None] for c in o)
    dx, dy, dz = (c[:, None] for c in d)
    a = dx * dx + dy * dy + dz * dz

    cx = c0[None, :, 0]
    cy = c0[None, :, 1]
    cz = c0[None, :, 2]
    if tables.has_moving:
        vel = tables.sph_vel
        tcol = time[:, None]
        cx = cx + tcol * vel[None, :, 0]
        cy = cy + tcol * vel[None, :, 1]
        cz = cz + tcol * vel[None, :, 2]

    ocx = ox - cx
    ocy = oy - cy
    ocz = oz - cz
    b = ocx * dx + ocy * dy + ocz * dz
    csq = ocx * ocx + ocy * ocy + ocz * ocz - (r * r)[None, :]
    disc = b * b - a * csq
    s = jnp.sqrt(jnp.maximum(disc, 0.0))
    inv_a = 1.0 / a
    t1 = (-b - s) * inv_a
    t2 = (-b + s) * inv_a
    valid = disc > 0.0  # strict, as in the reference (src/sphere.cuh:61)
    t = jnp.where(valid & (t1 > t_min), t1, jnp.where(valid & (t2 > t_min), t2, BIG))
    idx = jnp.argmin(t, axis=1).astype(jnp.int32)
    t_best = jnp.min(t, axis=1)
    return t_best, idx


def bvh_sphere_candidates_p(tables: SceneTables, o, d, time, t_min):
    """Best sphere hit per ray via per-ray escape-link BVH descent
    (reference src/bvh.cuh:95-106): (t_best (R,), idx (R,)).

    Same candidate semantics as ``sphere_candidates_p`` (strict disc > 0,
    near root if > t_min else far root, src/sphere.cuh:51-89), but each ray
    tests only the leaves its walk reaches, with the running closest t
    shrinking the slab-test window.
    """
    from art_tpu.ops.bvh import traverse_closest_packed

    ox, oy, oz = o
    dx, dy, dz = d
    a = dx * dx + dy * dy + dz * dz

    def prim_t_fn(idx, active):
        c = tables.sph_center[idx]  # (R,3) per-lane gather
        r = tables.sph_radius[idx]
        cx, cy, cz = c[:, 0], c[:, 1], c[:, 2]
        if tables.has_moving:
            v = tables.sph_vel[idx]
            cx = cx + time * v[:, 0]
            cy = cy + time * v[:, 1]
            cz = cz + time * v[:, 2]
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        b = ocx * dx + ocy * dy + ocz * dz
        csq = ocx * ocx + ocy * ocy + ocz * ocz - r * r
        disc = b * b - a * csq
        s = jnp.sqrt(jnp.maximum(disc, 0.0))
        inv_a = 1.0 / a
        t1 = (-b - s) * inv_a
        t2 = (-b + s) * inv_a
        valid = active & (disc > 0.0)
        return jnp.where(
            valid & (t1 > t_min), t1,
            jnp.where(valid & (t2 > t_min), t2, BIG),
        )

    o_rows = jnp.stack(o, axis=-1)
    d_rows = jnp.stack(d, axis=-1)
    t_best, prim_best = traverse_closest_packed(
        tables.sph_bvh, tables.n_sph_bvh_nodes, prim_t_fn,
        o_rows, d_rows, t_min, t_max=BIG,
    )
    return t_best, jnp.maximum(prim_best, 0).astype(jnp.int32)


def quad_candidates_p(tables: SceneTables, o, d, t_min):
    """Best quad hit per ray (plane hit + interior test, src/quad.cuh:60-90)."""
    n = tables.quad_n  # (Q,3)
    ox, oy, oz = (c[:, None] for c in o)
    dx, dy, dz = (c[:, None] for c in d)

    def bdot(tab):
        return ox * tab[None, :, 0] + oy * tab[None, :, 1] + oz * tab[None, :, 2]

    def bdot_d(tab):
        return dx * tab[None, :, 0] + dy * tab[None, :, 1] + dz * tab[None, :, 2]

    nd = bdot_d(n)
    no = bdot(n)
    t = (tables.quad_d[None, :] - no) / nd
    alpha = bdot(tables.quad_avec) + t * bdot_d(tables.quad_avec) - tables.quad_ca[None, :]
    beta = bdot(tables.quad_bvec) + t * bdot_d(tables.quad_bvec) - tables.quad_cb[None, :]
    valid = (
        (jnp.abs(nd) >= _PARALLEL_EPS)
        & (t > t_min)
        & (alpha >= 0.0) & (alpha <= 1.0)
        & (beta >= 0.0) & (beta <= 1.0)
    )
    t = jnp.where(valid, t, BIG)
    idx = jnp.argmin(t, axis=1).astype(jnp.int32)
    t_best = jnp.min(t, axis=1)
    return t_best, idx


def box_candidates_p(tables: SceneTables, o, d, t_min):
    """Best box hit per ray (slab test, replaces compound6 six-quad scan)."""
    off = tables.box_off  # (B,3)
    ox = o[0][:, None] - off[None, :, 0]
    oy = o[1][:, None] - off[None, :, 1]
    oz = o[2][:, None] - off[None, :, 2]
    dx = jnp.broadcast_to(d[0][:, None], ox.shape)
    dy = jnp.broadcast_to(d[1][:, None], ox.shape)
    dz = jnp.broadcast_to(d[2][:, None], ox.shape)
    if tables.has_rotated_boxes:
        # local = R(-theta) * world (src/hittable.cuh:118-127)
        ct = tables.box_cos[None, :]
        st = tables.box_sin[None, :]
        ox, oz = ct * ox - st * oz, st * ox + ct * oz
        dx, dz = ct * dx - st * dz, st * dx + ct * dz

    t_entry = jnp.full_like(ox, -BIG)
    t_exit = jnp.full_like(ox, BIG)
    for axis, (oc, dc) in enumerate(((ox, dx), (oy, dy), (oz, dz))):
        inv = 1.0 / _safe_dir(dc)
        ta = (tables.box_min[None, :, axis] - oc) * inv
        tb = (tables.box_max[None, :, axis] - oc) * inv
        t_entry = jnp.maximum(t_entry, jnp.minimum(ta, tb))
        t_exit = jnp.minimum(t_exit, jnp.maximum(ta, tb))

    through = t_entry < t_exit
    t = jnp.where(
        through & (t_entry > t_min),
        t_entry,
        jnp.where(through & (t_exit > t_min), t_exit, BIG),
    )
    idx = jnp.argmin(t, axis=1).astype(jnp.int32)
    t_best = jnp.min(t, axis=1)
    return t_best, idx


# --------------------------------------------------------------------------
# Winner attribute reconstruction (planar)
# --------------------------------------------------------------------------

def sphere_attributes_p(tables: SceneTables, o, d, time, t, idx, needs_uv: bool):
    """Normal/uv for the winning sphere (src/sphere.cuh:69-86).

    One packed-row fetch supplies center/velocity/radius/material."""
    from art_tpu.ops.gather import take_rows

    tab = jnp.concatenate(
        [
            tables.sph_center,
            tables.sph_vel,
            tables.sph_radius[:, None],
            tables.sph_mat.astype(jnp.float32)[:, None],
        ],
        axis=1,
    )
    row = take_rows(tab, idx)  # (R,8)
    cx, cy, cz = row[:, 0], row[:, 1], row[:, 2]
    r = row[:, 6]
    mat = row[:, 7].astype(jnp.int32)
    if tables.has_moving:
        cx = cx + time * row[:, 3]
        cy = cy + time * row[:, 4]
        cz = cz + time * row[:, 5]
    p = p_ray_at(o, d, t)
    inv_r = 1.0 / r
    normal = ((p[0] - cx) * inv_r, (p[1] - cy) * inv_r, (p[2] - cz) * inv_r)
    if needs_uv:
        # spherical uv from the (signed) normal (src/sphere.cuh:42-49)
        theta = jnp.arccos(jnp.clip(-normal[1], -1.0, 1.0))
        phi = jnp.arctan2(-normal[2], normal[0]) + jnp.pi
        u = phi / (2.0 * jnp.pi)
        v = theta / jnp.pi
    else:
        u = v = jnp.zeros_like(t)
    return normal, u, v, mat


def quad_attributes_p(tables: SceneTables, o, d, t, idx):
    """(alpha, beta) + ray-facing normal for the winning quad."""
    from art_tpu.ops.gather import take_rows

    row = take_rows(tables.quad_attr_packed, idx)  # (R,16)
    p = p_ray_at(o, d, t)
    pl = (p[0] - row[:, 0], p[1] - row[:, 1], p[2] - row[:, 2])
    uu = (row[:, 3], row[:, 4], row[:, 5])
    vv = (row[:, 6], row[:, 7], row[:, 8])
    ww = (row[:, 9], row[:, 10], row[:, 11])
    alpha = p_dot(ww, p_cross(pl, vv))
    beta = p_dot(ww, p_cross(uu, pl))
    nt = (row[:, 12], row[:, 13], row[:, 14])
    # shading normal faces against the ray (src/quad.cuh:84-86)
    flip = p_dot(nt, d) > 0.0
    normal = p_where(flip, (-nt[0], -nt[1], -nt[2]), nt)
    return normal, alpha, beta, row[:, 15].astype(jnp.int32)


def box_attributes_p(tables: SceneTables, o, d, t, idx):
    """Face normal + the reference's per-face UV (make_box, src/quad.cuh:145-162)."""
    from art_tpu.ops.gather import take_rows

    row = take_rows(tables.box_packed, idx)  # (R,12)
    mnx, mny, mnz = row[:, 0], row[:, 1], row[:, 2]
    mxx, mxy, mxz = row[:, 3], row[:, 4], row[:, 5]
    cos_t, sin_t = row[:, 6], row[:, 7]
    offx, offy, offz = row[:, 8], row[:, 9], row[:, 10]
    mat = row[:, 11].astype(jnp.int32)

    o_obj = p_rotate_y_inv((o[0] - offx, o[1] - offy, o[2] - offz), cos_t, sin_t)
    d_obj = p_rotate_y_inv(d, cos_t, sin_t)

    # Re-run the per-axis slab to identify entry/exit face.
    mins = (mnx, mny, mnz)
    maxs = (mxx, mxy, mxz)
    t0s, t1s = [], []
    for axis in range(3):
        inv = 1.0 / _safe_dir(d_obj[axis])
        ta = (mins[axis] - o_obj[axis]) * inv
        tb = (maxs[axis] - o_obj[axis]) * inv
        t0s.append(jnp.minimum(ta, tb))
        t1s.append(jnp.maximum(ta, tb))
    t_entry = jnp.maximum(jnp.maximum(t0s[0], t0s[1]), t0s[2])
    t_exit = jnp.minimum(jnp.minimum(t1s[0], t1s[1]), t1s[2])
    # argmax over the 3 entry candidates, planar
    axis_entry = jnp.where(
        t0s[0] >= jnp.maximum(t0s[1], t0s[2]), 0,
        jnp.where(t0s[1] >= t0s[2], 1, 2),
    )
    axis_exit = jnp.where(
        t1s[0] <= jnp.minimum(t1s[1], t1s[2]), 0,
        jnp.where(t1s[1] <= t1s[2], 1, 2),
    )
    is_entry = jnp.abs(t - t_entry) <= jnp.abs(t - t_exit)
    axis = jnp.where(is_entry, axis_entry, axis_exit)

    ax = axis == 0
    ay = axis == 1
    az = axis == 2
    d_axis = jnp.where(ax, d_obj[0], jnp.where(ay, d_obj[1], d_obj[2]))
    sgn = jnp.where(d_axis >= 0.0, 1.0, -1.0)
    n_val = -sgn  # shading normal faces against the ray
    outward_sgn = jnp.where(is_entry, -sgn, sgn)

    normal_obj = (
        jnp.where(ax, n_val, 0.0),
        jnp.where(ay, n_val, 0.0),
        jnp.where(az, n_val, 0.0),
    )
    normal = p_rotate_y(normal_obj, cos_t, sin_t)

    x, y, z = p_ray_at(o_obj, d_obj, t)
    wx = mxx - mnx
    wy = mxy - mny
    wz = mxz - mnz
    pos_face = outward_sgn > 0.0

    # Face UV per make_box parameterization (src/quad.cuh:154-159).
    ua = jnp.where(
        ax,
        jnp.where(pos_face, (mxz - z) / wz, (z - mnz) / wz),
        jnp.where(
            ay,
            (x - mnx) / wx,
            jnp.where(pos_face, (x - mnx) / wx, (mxx - x) / wx),
        ),
    )
    va = jnp.where(
        ax,
        (y - mny) / wy,
        jnp.where(
            ay,
            jnp.where(pos_face, (mxz - z) / wz, (z - mnz) / wz),
            (y - mny) / wy,
        ),
    )

    return normal, ua, va, mat


# --------------------------------------------------------------------------
# Closest surface hit across all segments (planar core)
# --------------------------------------------------------------------------

def closest_candidates_p(tables: SceneTables, o, d, time, t_min):
    """(t_best, winner, idx_s, idx_q, idx_b) from the candidate passes.

    Families merge quads -> boxes -> spheres with strict ``<``, so an exact
    tie keeps the earlier family (coplanar Cornell floor/box faces resolve
    to the quad); within a family argmin keeps the lower row.  ``winner``
    is -1 on a miss, 0 sphere, 1 quad, 2 box."""
    R = o[0].shape[0]
    t_best = jnp.full((R,), BIG, jnp.float32)
    winner = jnp.full((R,), -1, jnp.int32)
    idx_s = idx_q = idx_b = jnp.zeros((R,), jnp.int32)

    def merge(t, family, t_best, winner):
        better = t < t_best
        return jnp.where(better, t, t_best), jnp.where(better, family, winner)

    if tables.n_quads:
        if "fake_quads" in _DBG:
            t_q, *_ = _fake_candidates(o, d, time)
        else:
            t_q, idx_q = quad_candidates_p(tables, o, d, t_min)
        t_best, winner = merge(t_q, 1, t_best, winner)
    if tables.n_boxes:
        if "fake_boxes" in _DBG:
            t_b, *_ = _fake_candidates(o, d, time)
        else:
            t_b, idx_b = box_candidates_p(tables, o, d, t_min)
        t_best, winner = merge(t_b, 2, t_best, winner)
    if tables.n_spheres:
        if "fake_spheres" in _DBG:
            t_s, *_ = _fake_candidates(o, d, time)
        elif _BVH_ENV and tables.n_sph_bvh_nodes:
            t_s, idx_s = bvh_sphere_candidates_p(tables, o, d, time, t_min)
        else:
            t_s, idx_s = sphere_candidates_p(tables, o, d, time, t_min)
        t_best, winner = merge(t_s, 0, t_best, winner)
    return t_best, winner, idx_s, idx_q, idx_b


def closest_surface_p(tables: SceneTables, o, d, time, t_min) -> HitRecordP:
    R = o[0].shape[0]
    # UV coordinates only feed image/uv_offset textures; skip the
    # transcendentals when the scene has none (static specialization).
    needs_uv = bool({2, 6} & set(tables.tex_types_present))
    if time is None:
        time = jnp.zeros((R,), jnp.float32)

    t_best, winner, idx_s, idx_q, idx_b = closest_candidates_p(
        tables, o, d, time, t_min
    )

    hit = winner >= 0
    # Hit point is o + t*d for every surface type: computed once.
    p = p_ray_at(o, d, t_best)
    zeros = jnp.zeros((R,), jnp.float32)
    normal = (jnp.ones((R,), jnp.float32), zeros, zeros)
    uu = zeros
    vv = zeros
    mat = jnp.zeros((R,), jnp.int32)

    def blend(sel, attrs, normal, uu, vv, mat):
        n_i, u_i, v_i, m_i = attrs
        return (
            p_where(sel, n_i, normal),
            jnp.where(sel, u_i, uu),
            jnp.where(sel, v_i, vv),
            jnp.where(sel, m_i, mat),
        )

    if tables.n_spheres:
        normal, uu, vv, mat = blend(
            winner == 0,
            sphere_attributes_p(tables, o, d, time, t_best, idx_s, needs_uv),
            normal, uu, vv, mat,
        )
    if tables.n_quads:
        normal, uu, vv, mat = blend(
            winner == 1,
            quad_attributes_p(tables, o, d, t_best, idx_q),
            normal, uu, vv, mat,
        )
    if tables.n_boxes:
        normal, uu, vv, mat = blend(
            winner == 2,
            box_attributes_p(tables, o, d, t_best, idx_b),
            normal, uu, vv, mat,
        )

    return HitRecordP(hit=hit, t=t_best, p=p, normal=normal, u=uu, v=vv, mat=mat)


# --------------------------------------------------------------------------
# Constant media (exponential free-flight in convex boundaries)
# --------------------------------------------------------------------------

def _gb_first_hit(tables: SceneTables, m: int, o, d, time, t_lo):
    """Closest boundary hit with t > t_lo over medium m's kind-2 primitive
    set — the vectorized analog of one ``boundary->hit(r, t_lo, +inf)``
    call (reference src/constant_medium.cuh:38-44 runs it twice).

    Returns ((R,) t, (R,) hit).  Static per-prim loop: gb tables are tiny
    (general boundaries appear in no reference scene) and the med-id
    tuples are compile-time, so other media's prims cost nothing.
    """
    R = o[0].shape[0]
    best = jnp.full((R,), BIG, jnp.float32)
    hit = jnp.zeros((R,), bool)

    def consider(t_c, ok):
        nonlocal best, hit
        ok = ok & (t_c > t_lo) & (t_c < best)
        best = jnp.where(ok, t_c, best)
        hit = hit | ok

    for i, mi in enumerate(tables.gb_sph_meds):
        if mi != m:
            continue
        row = tables.gb_sph[i]
        c = (row[0] + time * row[3], row[1] + time * row[4],
             row[2] + time * row[5])
        r = row[6]
        oc = (o[0] - c[0], o[1] - c[1], o[2] - c[2])
        a = p_dot(d, d)
        b = p_dot(oc, d)
        csq = p_dot(oc, oc) - r * r
        disc = b * b - a * csq
        s = jnp.sqrt(jnp.maximum(disc, 0.0))
        t1 = (-b - s) / a
        t2 = (-b + s) / a
        # smaller root if beyond t_lo, else the far root (src/sphere.cuh:51-89)
        t_c = jnp.where(t1 > t_lo, t1, t2)
        consider(t_c, disc > 0.0)

    for i, mi in enumerate(tables.gb_quad_meds):
        if mi != m:
            continue
        row = tables.gb_quad[i]
        q, u, v = row[0:3], row[3:6], row[6:9]
        w, n = row[9:12], row[12:15]
        dd = row[15]
        denom = n[0] * d[0] + n[1] * d[1] + n[2] * d[2]
        ok = jnp.abs(denom) > 1e-8  # src/quad.cuh:63-65
        t_c = (dd - (n[0] * o[0] + n[1] * o[1] + n[2] * o[2])) / jnp.where(
            ok, denom, 1.0
        )
        p = p_ray_at(o, d, t_c)
        pl = (p[0] - q[0], p[1] - q[1], p[2] - q[2])
        # alpha = dot(w, cross(planar, v)); beta = dot(w, cross(u, planar))
        cx = (pl[1] * v[2] - pl[2] * v[1], pl[2] * v[0] - pl[0] * v[2],
              pl[0] * v[1] - pl[1] * v[0])
        alpha = w[0] * cx[0] + w[1] * cx[1] + w[2] * cx[2]
        cu = (u[1] * pl[2] - u[2] * pl[1], u[2] * pl[0] - u[0] * pl[2],
              u[0] * pl[1] - u[1] * pl[0])
        beta = w[0] * cu[0] + w[1] * cu[1] + w[2] * cu[2]
        interior = (alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0) & (beta <= 1.0)
        consider(t_c, ok & interior)

    for i, mi in enumerate(tables.gb_box_meds):
        if mi != m:
            continue
        row = tables.gb_box[i]
        cos_t, sin_t = row[6], row[7]
        off = row[8:11]
        o_obj = p_rotate_y_inv(
            (o[0] - off[0], o[1] - off[1], o[2] - off[2]), cos_t, sin_t
        )
        d_obj = p_rotate_y_inv(d, cos_t, sin_t)
        entry = jnp.full((R,), -BIG, jnp.float32)
        exit_ = jnp.full((R,), BIG, jnp.float32)
        for axis in range(3):
            inv = 1.0 / _safe_dir(d_obj[axis])
            ta = (row[axis] - o_obj[axis]) * inv
            tb = (row[3 + axis] - o_obj[axis]) * inv
            entry = jnp.maximum(entry, jnp.minimum(ta, tb))
            exit_ = jnp.minimum(exit_, jnp.maximum(ta, tb))
        t_c = jnp.where(entry > t_lo, entry, exit_)
        consider(t_c, entry < exit_)

    return best, hit


def apply_media_p(
    tables: SceneTables, o, d, t_min, surf: HitRecordP, u_media: jnp.ndarray,
    time=None,
) -> HitRecordP:
    """Overlay medium scatter events on the surface hit record.

    Statistically equivalent to the reference's in-traversal medium sampling
    (src/constant_medium.cuh:36-64): for each medium, the boundary interval
    over (-inf, inf) is clipped to [t_min, t_surface], an exponential
    free-flight distance is drawn, and the closest accepted scatter wins.
    ``u_media`` is a (>=n_media, R) block of U[0,1) samples (row-planar).
    ``time`` (the per-ray shutter time) only matters for kind-2 general
    boundaries containing moving spheres.
    """
    if not tables.n_media:
        return surf
    if "fake_media" in _DBG:  # perf-debug: dependency-preserving stub
        t_f = surf.t + jnp.abs(u_media[0]) * 1e-7
        return surf._replace(t=t_f)

    R = o[0].shape[0]
    if time is None:
        time = jnp.zeros((R,), jnp.float32)
    ray_len = jnp.sqrt(p_dot(d, d))
    len_ok = (ray_len > 0.0) & jnp.isfinite(ray_len)

    best_t = surf.t
    best_med = jnp.full((R,), -1, jnp.int32)

    # Static per-medium unroll: every reference scene has <= 2 media
    # (src/main.cu cornell_smoke/final), so a Python loop traces a small
    # fixed chain.  A many-media scene would bloat the program linearly —
    # surface that at build time instead of compiling for minutes.
    if tables.n_media > 8:
        import warnings

        warnings.warn(
            f"apply_media_p unrolls per medium: {tables.n_media} media "
            "will trace a very large program (reference scenes use <= 2); "
            "consider a table-driven media pass",
            stacklevel=2,
        )
    for m in range(tables.n_media):
        kind = tables.med_kinds[m]  # static per scene build
        if kind == 0:
            c = tables.med_center[m]
            r = tables.med_radius[m]
            oc = (o[0] - c[0], o[1] - c[1], o[2] - c[2])
            a = p_dot(d, d)
            b = p_dot(oc, d)
            csq = p_dot(oc, oc) - r * r
            disc = b * b - a * csq
            s = jnp.sqrt(jnp.maximum(disc, 0.0))
            entry = (-b - s) / a
            exit_ = (-b + s) / a
            bnd_ok = disc > 0.0
        elif kind == 1:
            cos_t = tables.med_cos[m]
            sin_t = tables.med_sin[m]
            off = tables.med_off[m]
            o_obj = p_rotate_y_inv(
                (o[0] - off[0], o[1] - off[1], o[2] - off[2]), cos_t, sin_t
            )
            d_obj = p_rotate_y_inv(d, cos_t, sin_t)
            entry = jnp.full((R,), -BIG, jnp.float32)
            exit_ = jnp.full((R,), BIG, jnp.float32)
            for axis in range(3):
                inv = 1.0 / _safe_dir(d_obj[axis])
                ta = (tables.med_min[m, axis] - o_obj[axis]) * inv
                tb = (tables.med_max[m, axis] - o_obj[axis]) * inv
                entry = jnp.maximum(entry, jnp.minimum(ta, tb))
                exit_ = jnp.minimum(exit_, jnp.maximum(ta, tb))
            bnd_ok = entry < exit_
        else:  # kind == 2: general boundary, two traversals of its prim set
            entry, hit1 = _gb_first_hit(
                tables, m, o, d, time, jnp.full((R,), -BIG, jnp.float32)
            )
            # second hit searched from rec1.t + 1e-4 (src/constant_medium.cuh:40)
            exit_, hit2 = _gb_first_hit(tables, m, o, d, time, entry + 1e-4)
            bnd_ok = hit1 & hit2

        if kind != 2:
            # analytic-interval emulation of the reference's "second hit must
            # lie beyond rec1.t + 1e-4" rule (src/constant_medium.cuh:40);
            # the general path applies it directly via t_lo above
            bnd_ok = bnd_ok & ((exit_ - entry) > 1e-4)
        rec1 = jnp.maximum(entry, t_min)
        rec2 = jnp.minimum(exit_, best_t)
        ok = bnd_ok & (rec1 < rec2) & len_ok
        distance_inside = (rec2 - rec1) * ray_len

        u01 = jnp.maximum(1e-6, u_media[m])
        hit_distance = tables.med_neg_inv_density[m] * jnp.log(u01)
        scatter = ok & (hit_distance <= distance_inside)
        t_m = rec1 + hit_distance / ray_len

        accept = scatter & (t_m < best_t)
        best_t = jnp.where(accept, t_m, best_t)
        best_med = jnp.where(accept, m, best_med)

    in_medium = best_med >= 0
    p = p_where(in_medium, p_ray_at(o, d, best_t), surf.p)
    ones = jnp.ones((R,), jnp.float32)
    zeros = jnp.zeros((R,), jnp.float32)
    normal = p_where(in_medium, (ones, zeros, zeros), surf.normal)
    mat = jnp.where(in_medium, tables.med_mat[jnp.maximum(best_med, 0)], surf.mat)
    return HitRecordP(
        hit=surf.hit | in_medium,
        t=best_t,
        p=p,
        normal=normal,
        u=jnp.where(in_medium, 0.0, surf.u),
        v=jnp.where(in_medium, 0.0, surf.v),
        mat=mat,
    )


# --------------------------------------------------------------------------
# Array-of-struct wrappers (portable API, used by tests)
# --------------------------------------------------------------------------

def closest_surface(tables: SceneTables, o, d, time, t_min) -> HitRecord:
    rec = closest_surface_p(tables, p_unstack(o), p_unstack(d), time, t_min)
    return _to_aos(rec)


def apply_media(
    tables: SceneTables, o, d, t_min, surf: HitRecord, u_media, time=None
) -> HitRecord:
    rec = apply_media_p(
        tables, p_unstack(o), p_unstack(d), t_min, surf.to_planar(), u_media,
        time=time,
    )
    return _to_aos(rec)


# Back-compat aliases for the AoS candidate/attribute helpers used in tests.
def sphere_candidates(tables, o, d, time, t_min):
    return sphere_candidates_p(tables, p_unstack(o), p_unstack(d), time, t_min)


def quad_candidates(tables, o, d, t_min):
    return quad_candidates_p(tables, p_unstack(o), p_unstack(d), t_min)


def box_candidates(tables, o, d, t_min):
    return box_candidates_p(tables, p_unstack(o), p_unstack(d), t_min)


def sphere_attributes(tables, o, d, time, t, idx, needs_uv: bool = True):
    op, dp = p_unstack(o), p_unstack(d)
    n, u, v, m = sphere_attributes_p(tables, op, dp, time, t, idx, needs_uv)
    return p_stack(p_ray_at(op, dp, t)), p_stack(n), u, v, m
