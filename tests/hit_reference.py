"""Float64 NumPy reference of the closest surface hit, and the ray batches
the intersection tests run it on.

The reference follows the reference tracer's hit routines in float64 on
the scene tables' own float32 values: the half-b sphere quadratic at the
ray's shutter time (src/sphere.cuh:51-89), the quad plane and interior test
from the quad's Q, u, v (src/quad.cuh:60-90), and the slab test in each
box's local frame.  Families merge quads, boxes, spheres with a strict
``<``, and within a family the lowest row wins a tie, as in
``intersect.closest_candidates_p``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from art_tpu.core.camera import generate_rays
from art_tpu.core.vecmath import BIG, T_MIN
from art_tpu.ops import intersect

RTOL = 1e-3
# Largest share of rays whose closest t differs by more than RTOL of
# max(|t|, 1), per ray family.  Origins on a large sphere leave its near
# root at the f32 noise of |oc|^2 - r^2 (~0.06 for the r = 1000 ground
# spheres), around t_min, so one rounding can flip which root is taken.
MAX_MISMATCH = {"camera": 1e-3, "surface": 1e-2, "random": 1e-3,
                "parallel": 1e-3}
_PARALLEL_EPS = 1e-8
_DIR_EPS = 1e-12


def _f64(x, n=None):
    a = np.asarray(x, np.float64)
    return a if n is None else a[:n]


def _spheres(tables, o, d, tm, t_min):
    n = tables.n_spheres
    c = _f64(tables.sph_center, n)[None] + tm[:, None, None] * _f64(tables.sph_vel, n)[None]
    r = _f64(tables.sph_radius, n)
    oc = o[:, None] - c
    a = (d * d).sum(1)[:, None]
    b = (oc * d[:, None]).sum(2)
    disc = b * b - a * ((oc * oc).sum(2) - r * r)
    s = np.sqrt(np.maximum(disc, 0.0))
    t1, t2 = (-b - s) / a, (-b + s) / a
    ok = disc > 0.0
    return np.where(ok & (t1 > t_min), t1, np.where(ok & (t2 > t_min), t2, BIG))


def _quads(tables, o, d, t_min):
    n = tables.n_quads
    q, u, v = (_f64(x, n) for x in (tables.quad_q, tables.quad_u, tables.quad_v))
    nrm = np.cross(u, v)
    w = nrm / (nrm * nrm).sum(1, keepdims=True)
    unit = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
    denom = d @ unit.T
    with np.errstate(divide="ignore", invalid="ignore"):
        t = ((q * unit).sum(1)[None] - o @ unit.T) / denom
        rel = o[:, None] + t[..., None] * d[:, None] - q[None]  # (R, n, 3)
        alpha = (w[None] * np.cross(rel, v[None])).sum(2)
        beta = (w[None] * np.cross(u[None], rel)).sum(2)
        ok = ((np.abs(denom) >= _PARALLEL_EPS) & (t > t_min)
              & (alpha >= 0) & (alpha <= 1) & (beta >= 0) & (beta <= 1))
    return np.where(ok, t, BIG)


def _boxes(tables, o, d, t_min):
    n = tables.n_boxes
    lo, hi, off = (_f64(x, n) for x in (tables.box_min, tables.box_max, tables.box_off))
    cs, sn = _f64(tables.box_cos, n)[None], _f64(tables.box_sin, n)[None]
    ox, oy, oz = (o[:, None, k] - off[None, :, k] for k in range(3))
    dx, dy, dz = (np.broadcast_to(d[:, None, k], ox.shape) for k in range(3))
    # world -> local: rotate by -theta about y (src/hittable.cuh:118-127)
    ox, oz = cs * ox - sn * oz, sn * ox + cs * oz
    dx, dz = cs * dx - sn * dz, sn * dx + cs * dz
    t_in = np.full(ox.shape, -BIG)
    t_out = np.full(ox.shape, BIG)
    for k, (oc, dc) in enumerate(((ox, dx), (oy, dy), (oz, dz))):
        # an exactly parallel ray cannot enter or leave through this slab
        dc = np.where(np.abs(dc) < _DIR_EPS, np.where(dc >= 0, _DIR_EPS, -_DIR_EPS), dc)
        ta, tb = (lo[None, :, k] - oc) / dc, (hi[None, :, k] - oc) / dc
        t_in = np.maximum(t_in, np.minimum(ta, tb))
        t_out = np.minimum(t_out, np.maximum(ta, tb))
    through = t_in < t_out
    return np.where(through & (t_in > t_min), t_in,
                    np.where(through & (t_out > t_min), t_out, BIG))


def reference_hits(tables, o, d, tm, t_min: float = T_MIN):
    """(t, kind, idx) in float64: kind -1 miss, 0 sphere, 1 quad, 2 box."""
    o = np.stack([_f64(c) for c in o], 1)
    d = np.stack([_f64(c) for c in d], 1)
    tm = _f64(tm)
    rows = np.arange(len(o))
    t_best = np.full(len(o), BIG)
    kind = np.full(len(o), -1)
    idx = np.zeros(len(o), np.int64)
    passes = ((1, tables.n_quads, lambda: _quads(tables, o, d, t_min)),
              (2, tables.n_boxes, lambda: _boxes(tables, o, d, t_min)),
              (0, tables.n_spheres, lambda: _spheres(tables, o, d, tm, t_min)))
    for family, n, candidates in passes:
        if not n:
            continue
        t = candidates()
        i = np.argmin(t, axis=1)
        better = t[rows, i] < t_best
        t_best = np.where(better, t[rows, i], t_best)
        kind = np.where(better, family, kind)
        idx = np.where(better, i, idx)
    return t_best, kind, idx


def plain_hits(tables, o, d, tm, t_min: float = T_MIN):
    """(t, kind, idx) from the plain candidate passes; idx 0 on a miss."""
    t, kind, idx_s, idx_q, idx_b = intersect.closest_candidates_p(
        tables, o, d, tm, t_min
    )
    idx = jnp.where(kind == 0, idx_s, jnp.where(kind == 1, idx_q, idx_b))
    return t, kind, jnp.where(kind >= 0, idx, 0)


def t_mismatch(ref, got, rtol: float = RTOL) -> float:
    """Share of rays whose closest t differs by more than ``rtol`` of
    max(|t|, 1).  A differing winner at an equal t is a tie: either answer
    is right."""
    t_r, t_g = np.asarray(ref[0], np.float64), np.asarray(got[0], np.float64)
    return float((np.abs(t_r - t_g) / np.maximum(np.abs(t_r), 1.0) > rtol).mean())


def scene_bounds(tables) -> tuple[np.ndarray, np.ndarray]:
    """A box around the bulk of the scene's primitives (5th to 95th
    percentile of their centres, widened by 10%): a huge ground sphere's
    centre would otherwise stretch it far below the scene."""
    pts = []
    if tables.n_spheres:
        pts.append(np.asarray(tables.sph_center)[: tables.n_spheres])
    if tables.n_quads:
        pts.append(np.asarray(tables.quad_q)[: tables.n_quads])
    if tables.n_boxes:
        off = np.asarray(tables.box_off)[: tables.n_boxes]
        pts.append(np.asarray(tables.box_min)[: tables.n_boxes] + off)
        pts.append(np.asarray(tables.box_max)[: tables.n_boxes] + off)
    pts = np.concatenate(pts)
    lo, hi = np.percentile(pts, 5, axis=0), np.percentile(pts, 95, axis=0)
    pad = 0.1 * np.maximum(hi - lo, 1.0)
    return lo - pad, hi + pad


def _planar(rows) -> tuple:
    return tuple(jnp.asarray(c, jnp.float32) for c in rows)


def ray_families(scene, n: int, seed: int = 0) -> dict:
    """Planar (o, d, time) ray batches of four kinds for one scene:

    * ``camera`` — primary rays through the whole image;
    * ``surface`` — rays leaving the camera rays' closest hits in random
      directions (origins on surfaces, where ``t_min`` matters);
    * ``random`` — random origins inside ``scene_bounds``, random
      directions;
    * ``parallel`` — random origins, directions exactly along the world
      axes and along the scene's quad edges, so parallel to axis-aligned
      slabs and to quad planes.
    """
    rng = np.random.default_rng(seed)
    s = jnp.asarray(rng.random(n), jnp.float32)
    t = jnp.asarray(rng.random(n), jnp.float32)
    o, d, tm = generate_rays(scene.camera, s, t, jax.random.PRNGKey(seed))
    o = tuple(o[:, c] for c in range(3))
    d = tuple(d[:, c] for c in range(3))
    fam = {"camera": (o, d, tm)}

    tables = scene.tables
    t_hit, kind, _ = reference_hits(tables, o, d, tm)
    t_np = np.where(kind >= 0, t_hit, 0.0)
    o_s = [np.asarray(o[c]) + t_np * np.asarray(d[c]) for c in range(3)]
    fam["surface"] = (_planar(o_s), _planar(rng.normal(size=(3, n))), tm)

    lo, hi = scene_bounds(tables)
    o_r = lo[:, None] + rng.random((3, n)) * (hi - lo)[:, None]
    fam["random"] = (_planar(o_r), _planar(rng.normal(size=(3, n))),
                     jnp.asarray(rng.random(n), jnp.float32))

    dirs = [np.eye(3)[a] * sgn for a in range(3) for sgn in (1.0, -1.0)]
    for q in range(tables.n_quads):
        for e in (np.asarray(tables.quad_u[q]), np.asarray(tables.quad_v[q])):
            dirs += [e, -e]
    dirs = np.asarray(dirs, np.float32)
    d_p = dirs[rng.integers(0, len(dirs), n)].T
    o_p = lo[:, None] + rng.random((3, n)) * (hi - lo)[:, None]
    fam["parallel"] = (_planar(o_p), _planar(d_p),
                       jnp.asarray(rng.random(n), jnp.float32))
    return fam
