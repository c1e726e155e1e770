"""Host-built BVH with a flattened, traversal-friendly layout.

Mirrors the reference's device-built recursive BVH (reference
src/bvh.cuh:29-84) on the host:

* split axis = largest spread of box *minima* (bvh.cuh:45-63);
* objects sorted by box minimum along that axis (the reference uses an
  in-place selection sort, bvh.cuh:65-77 — equivalent ordering);
* midpoint split (bvh.cuh:79-81); single-object ranges become leaves
  (the left==right leaf trick, bvh.cuh:38-43, becomes an explicit leaf
  node here).

The tree is emitted in **preorder** with *escape links*: node i's subtree
occupies [i, escape_i), its left child is i+1, and a miss jumps straight to
escape_i.  That turns traversal into a single monotone node counter — no
per-lane stack — the shape a per-ray traversal kernel wants (SURVEY.md §7
"stackless / fixed-size-stack iterative traversal").  ``traverse_closest``
is the vectorized jnp reference implementation used to validate the
structure against brute force.

The packed node table (``pack_bvh`` -> tables.sph_bvh) drives the opt-in
per-ray descent mode (ART_TPU_BVH=1, ops/intersect.bvh_sphere_candidates_p).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class FlatBVH:
    """Preorder node arrays; leaves reference primitive indices."""

    bbox_min: np.ndarray  # (M, 3)
    bbox_max: np.ndarray  # (M, 3)
    escape: np.ndarray  # (M,) int32: index after node's subtree (miss jump)
    prim: np.ndarray  # (M,) int32: primitive index for leaves, -1 internal

    @property
    def n_nodes(self) -> int:
        return self.bbox_min.shape[0]


def build_bvh(bmin: np.ndarray, bmax: np.ndarray) -> FlatBVH:
    """Build over primitive boxes (N, 3)/(N, 3); returns the flattened tree."""
    bmin = np.asarray(bmin, np.float64)
    bmax = np.asarray(bmax, np.float64)
    n = bmin.shape[0]
    order = np.arange(n)

    nodes_min: list = []
    nodes_max: list = []
    nodes_escape: list = []
    nodes_prim: list = []

    def emit(mn, mx, prim):
        nodes_min.append(mn)
        nodes_max.append(mx)
        nodes_escape.append(-1)  # patched after subtree emission
        nodes_prim.append(prim)
        return len(nodes_min) - 1

    def build(start: int, end: int) -> int:
        count = end - start
        idxs = order[start:end]
        mn = bmin[idxs].min(axis=0)
        mx = bmax[idxs].max(axis=0)
        me = emit(mn, mx, int(idxs[0]) if count == 1 else -1)
        if count > 1:
            # split axis by largest spread of box minima, matching the
            # reference tie rule (bvh.cuh:45-63: `sy > sx && sy >= sz`) —
            # x wins ties against y; y wins ties against z; z needs a
            # strict win over x plus >= y
            mins = bmin[idxs]
            spread = mins.max(axis=0) - mins.min(axis=0)
            axis = 0
            if spread[1] > spread[0] and spread[1] >= spread[2]:
                axis = 1
            elif spread[2] > spread[0] and spread[2] >= spread[1]:
                axis = 2
            # sort segment by box min along axis (bvh.cuh:65-77).  NOTE: a
            # stable argsort; the reference's in-place selection sort is
            # unstable, so layouts can differ when box minima tie — the set
            # of primitives per subtree is identical either way
            seg = order[start:end]
            order[start:end] = seg[np.argsort(bmin[seg, axis], kind="stable")]
            mid = start + (count >> 1)  # midpoint split (bvh.cuh:79)
            build(start, mid)
            build(mid, end)
        nodes_escape[me] = len(nodes_min)
        return me

    if n > 0:
        import sys

        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 2 * n + 100))
        try:
            build(0, n)
        finally:
            sys.setrecursionlimit(old)

    return FlatBVH(
        bbox_min=np.asarray(nodes_min, np.float32).reshape(-1, 3),
        bbox_max=np.asarray(nodes_max, np.float32).reshape(-1, 3),
        escape=np.asarray(nodes_escape, np.int32),
        prim=np.asarray(nodes_prim, np.int32),
    )


def sphere_world_bounds(center, vel, radius):
    """Union of the t=0 and t=1 sphere boxes (src/sphere.cuh:33-37)."""
    c0 = np.asarray(center, np.float64)
    v = np.asarray(vel, np.float64)
    r = np.abs(np.asarray(radius, np.float64))[:, None]
    bmin = np.minimum(c0, c0 + v) - r
    bmax = np.maximum(c0, c0 + v) + r
    return bmin, bmax


def pack_bvh(tree: FlatBVH) -> np.ndarray:
    """(M, 8) rows [min(3), max(3), escape, prim] for kernel consumption."""
    # escape links / prim indices ride f32 columns: exact only below 2^24
    assert tree.n_nodes < (1 << 24), tree.n_nodes
    if tree.prim.size:
        assert int(np.max(tree.prim)) < (1 << 24), "prim index exceeds f32 width"
    out = np.zeros((tree.n_nodes, 8), np.float32)
    out[:, 0:3] = tree.bbox_min
    out[:, 3:6] = tree.bbox_max
    out[:, 6] = tree.escape
    out[:, 7] = tree.prim
    return out


def traverse_closest(tree: FlatBVH, prim_t_fn, o, d, t_min, t_max=1e30):
    """Vectorized escape-link traversal (jnp) over a host FlatBVH."""
    import jax.numpy as jnp

    return traverse_closest_packed(
        jnp.asarray(pack_bvh(tree)), tree.n_nodes, prim_t_fn, o, d,
        t_min, t_max,
    )


def traverse_closest_packed(nodes, n_nodes: int, prim_t_fn, o, d,
                            t_min, t_max=1e30):
    """Vectorized escape-link traversal (jnp) over packed (Mn, 8) node rows
    ([min(3) max(3) escape prim], pack_bvh) — the per-ray descent analog of
    the reference's recursive bvh_node::hit (src/bvh.cuh:95-106), with the
    shrinking-tmax closest-hit rule.  Each ray walks its own node counter;
    every step gathers that ray's node row — kept as the opt-in ART_TPU_BVH
    path and as the validation reference for the flattened structure.

    ``prim_t_fn(prim_idx (R,), active (R,))`` must return candidate hit t
    (R,) for each ray against its primitive (BIG on miss).  Returns
    (t_best (R,), prim_best (R,)); prim_best is -1 where no hit.
    """
    import jax
    import jax.numpy as jnp

    R = o.shape[0]
    M = n_nodes
    nb_min = nodes[:, 0:3]
    nb_max = nodes[:, 3:6]
    esc = nodes[:, 6].astype(jnp.int32)
    prim = nodes[:, 7].astype(jnp.int32)

    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-12, jnp.where(d >= 0, 1e-12, -1e-12), d)

    def cond(state):
        node, _, _ = state
        return jnp.any(node < M)

    def body(state):
        node, best_t, best_p = state
        nid = jnp.minimum(node, M - 1)
        mn = nb_min[nid]
        mx = nb_max[nid]
        ta = (mn - o) * inv_d
        tb = (mx - o) * inv_d
        t0 = jnp.max(jnp.minimum(ta, tb), axis=-1)
        t1 = jnp.min(jnp.maximum(ta, tb), axis=-1)
        # slab hit against the running closest (bvh.cuh:97 passes shrinking tmax)
        box_hit = (jnp.maximum(t0, t_min) <= jnp.minimum(t1, best_t)) & (node < M)

        p = prim[nid]
        is_leaf = p >= 0
        test_prim = box_hit & is_leaf
        cand = prim_t_fn(jnp.maximum(p, 0), test_prim)
        better = test_prim & (cand < best_t) & (cand > t_min)
        best_t = jnp.where(better, cand, best_t)
        best_p = jnp.where(better, p, best_p)

        # hit internal -> descend (node+1); miss or leaf -> escape link
        descend = box_hit & ~is_leaf
        node = jnp.where(descend, nid + 1, esc[nid])
        node = jnp.where(state[0] >= M, M, node)  # finished lanes stay done
        return node, best_t, best_p

    node0 = jnp.zeros((R,), jnp.int32)
    t0 = jnp.full((R,), jnp.float32(t_max))
    p0 = jnp.full((R,), -1, jnp.int32)
    _, best_t, best_p = jax.lax.while_loop(cond, body, (node0, t0, p0))
    return best_t, best_p
