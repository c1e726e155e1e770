"""The closest surface hit of the plain candidate passes
(``intersect.closest_candidates_p``) against a float64 NumPy reference
(tests/hit_reference.py) and closed-form cases.

On the card the same passes run inside every render of chip_smoke.py,
whose parity phase compares them with this host's CPU backend.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from art_tpu.core.vecmath import BIG
from art_tpu.models import SCENES, build_scene
from art_tpu.scene.builder import SceneBuilder
from art_tpu.scene.materials import Dielectric, Lambertian
from art_tpu.scene.objects import Box, Quad, RotateY, Sphere, Translate
from hit_reference import (
    MAX_MISMATCH,
    plain_hits,
    ray_families,
    reference_hits,
    t_mismatch,
)

FAMILIES = ["camera", "surface", "random", "parallel"]
N_RAYS = 600
MAT = Lambertian((0.5, 0.5, 0.5))


def assert_agrees(tables, o, d, tm, max_mismatch=0.0):
    ref = reference_hits(tables, o, d, tm)
    got = plain_hits(tables, o, d, tm)
    bad = t_mismatch(ref, got)
    assert bad <= max_mismatch, bad
    return ref, got


_FAMILY_CACHE = {}


def families(name):
    if name not in _FAMILY_CACHE:
        _FAMILY_CACHE[name] = ray_families(build_scene(name, 32, 24), N_RAYS)
    return _FAMILY_CACHE[name]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("name", sorted(SCENES))
def test_plain_passes_match_float64_reference(name, family):
    tables = build_scene(name, 32, 24).tables
    o, d, tm = families(name)[family]
    assert_agrees(tables, o, d, tm, max_mismatch=MAX_MISMATCH[family])


def _scene(*objs):
    b = SceneBuilder()
    b.add(*objs)
    b.set_camera(lookfrom=(0, 0, 5), lookat=(0, 0, 0), vup=(0, 1, 0),
                 vfov_degrees=40.0, aspect=1.0)
    return b.compile()


def _planar(o, d, tm=None):
    o = np.asarray(o, np.float32)
    d = np.asarray(d, np.float32)
    tm = np.zeros(len(o), np.float32) if tm is None else np.asarray(tm, np.float32)
    return (tuple(jnp.asarray(o[:, c]) for c in range(3)),
            tuple(jnp.asarray(d[:, c]) for c in range(3)), jnp.asarray(tm))


def _np(hits):
    return tuple(np.asarray(x) for x in hits)


def test_inside_hit_takes_far_root():
    sc = _scene(Sphere((0, 0, 0), 2.0, MAT))
    o, d, tm = _planar([[0, 0, 0], [0.5, 0, 0]], [[0, 0, 2], [1, 0, 0]])
    t, kind, _ = _np(plain_hits(sc.tables, o, d, tm))
    np.testing.assert_allclose(t, [1.0, 1.5], rtol=1e-6)
    assert list(kind) == [0, 0]
    assert_agrees(sc.tables, o, d, tm)


def test_negative_radius_hollow_glass():
    """A hollow glass shell (outer r, inner -r') is hit at the outer
    surface from outside and at the inner surface from the hollow."""
    glass = Dielectric(1.5)
    sc = _scene(Sphere((0, 0, 0), 1.0, glass), Sphere((0, 0, 0), -0.8, glass))
    o, d, tm = _planar([[0, 0, 5], [0, 0, 0]], [[0, 0, -1], [0, 0, -1]])
    t, _, idx = _np(plain_hits(sc.tables, o, d, tm))
    np.testing.assert_allclose(t, [4.0, 0.8], rtol=1e-6)
    assert list(idx) == [0, 1]
    assert_agrees(sc.tables, o, d, tm)


@pytest.mark.parametrize("time", [0.0, 1.0])
def test_moving_sphere_at_shutter_ends(time):
    sc = _scene(Sphere((0, 0, 0), 0.5, MAT, center2=(2, 0, 0)))
    o, d, tm = _planar([[0, 0, 5], [2, 0, 5]], [[0, 0, -1], [0, 0, -1]],
                       [time, time])
    t, kind, _ = _np(plain_hits(sc.tables, o, d, tm))
    want_kind = [0, -1] if time == 0.0 else [-1, 0]
    assert list(kind) == want_kind
    np.testing.assert_allclose(t[want_kind.index(0)], 4.5, rtol=1e-6)
    assert_agrees(sc.tables, o, d, tm)


@pytest.mark.parametrize("rotated", [False, True])
def test_boxes_axis_aligned_and_rotated(rotated):
    box = Box((-1, -1, -1), (1, 1, 1), MAT)
    obj = Translate(RotateY(box, 45.0), (0, 0, 0)) if rotated else box
    sc = _scene(obj)
    o, d, tm = _planar([[0, 0, 5], [5, 0.5, 0], [0, 3, 0]],
                       [[0, 0, -1], [-1, 0, 0], [0, 0, 1]])
    t, kind, _ = _np(plain_hits(sc.tables, o, d, tm))
    face = np.sqrt(2.0) if rotated else 1.0
    np.testing.assert_allclose(t[:2], [5 - face, 5 - face], rtol=1e-5)
    assert list(kind) == [2, 2, -1]
    assert t[2] == BIG
    assert_agrees(sc.tables, o, d, tm)


def test_final_scene_box_lattice():
    """Camera rays over final_scene's 20x20 ground-box lattice."""
    sc = build_scene("final_scene", 32, 24)
    assert sc.tables.n_boxes >= 400
    o, d, tm = families("final_scene")["camera"]
    _, got = assert_agrees(sc.tables, o, d, tm)
    assert (np.asarray(got[1]) == 2).any()


@pytest.mark.parametrize("n", [1, 7, 129, 389])
def test_any_ray_count(n):
    sc = build_scene("cornell_box", 32, 24)
    o, d, tm = families("cornell_box")["camera"]
    o, d = tuple(c[:n] for c in o), tuple(c[:n] for c in d)
    _, got = assert_agrees(sc.tables, o, d, tm[:n])
    assert got[0].shape == (n,) and np.isfinite(np.asarray(got[0])).all()


def test_coplanar_tie_keeps_the_quad():
    """A floor quad and a box standing on it share the plane y = 0.  A ray
    from below reaches both at the same t; the earlier family, quads,
    keeps the hit."""
    floor = Quad((-5, 0, -5), (10, 0, 0), (0, 0, 10), MAT)
    box = Box((-1, 0, -1), (1, 2, 1), MAT)
    sc = _scene(floor, box)
    o, d, tm = _planar([[0.5, -3, 0.5]], [[0, 1, 0]])
    t, kind, _ = _np(plain_hits(sc.tables, o, d, tm))
    assert t[0] == 3.0 and kind[0] == 1
    ref = reference_hits(sc.tables, o, d, tm)
    assert ref[0][0] == 3.0 and ref[1][0] == 1


@pytest.mark.parametrize("family", ["sphere", "quad", "box"])
def test_t_min_skips_the_surface_a_ray_leaves(family):
    """A ray that starts on a surface is not hit by it at t = 0: it
    reaches the sphere's far side, the quad behind, the box's exit face."""
    obj = {
        "sphere": [Sphere((0, 0, 0), 1.0, MAT)],
        "quad": [Quad((-1, -1, 1), (2, 0, 0), (0, 2, 0), MAT),
                 Quad((-1, -1, -1), (2, 0, 0), (0, 2, 0), MAT)],
        "box": [Box((-1, -1, -1), (1, 1, 1), MAT)],
    }[family]
    sc = _scene(*obj)
    o, d, tm = _planar([[0, 0, 1]], [[0, 0, -1]])
    t, kind, idx = _np(plain_hits(sc.tables, o, d, tm))
    np.testing.assert_allclose(t, [2.0], rtol=1e-6)
    assert kind[0] == {"sphere": 0, "quad": 1, "box": 2}[family]
    assert idx[0] == (1 if family == "quad" else 0)
    assert_agrees(sc.tables, o, d, tm)


def test_miss_gives_big_and_no_winner():
    sc = _scene(Sphere((0, 0, 0), 1.0, MAT), Box((2, 2, 2), (3, 3, 3), MAT),
                Quad((-1, -1, -3), (2, 0, 0), (0, 2, 0), MAT))
    o, d, tm = _planar([[0, 0, 5], [0, 5, 0]], [[0, 0, 1], [0, 1, 0]])
    t, kind, idx = _np(plain_hits(sc.tables, o, d, tm))
    assert list(kind) == [-1, -1] and list(idx) == [0, 0]
    assert (t == BIG).all()
    assert_agrees(sc.tables, o, d, tm)


@pytest.mark.parametrize("family", ["spheres", "quads", "boxes"])
def test_single_family_scenes(family):
    objs = {
        "spheres": [Sphere((0, 0, 0), 1.0, MAT), Sphere((0, 0, -3), 1.0, MAT)],
        "quads": [Quad((-1, -1, 0), (2, 0, 0), (0, 2, 0), MAT),
                  Quad((-1, -1, -2), (2, 0, 0), (0, 2, 0), MAT)],
        "boxes": [Box((-1, -1, -1), (1, 1, 1), MAT),
                  Box((-1, -1, -4), (1, 1, -3), MAT)],
    }[family]
    sc = _scene(*objs)
    for o, d, tm in ray_families(sc, 200).values():
        assert_agrees(sc.tables, o, d, tm, max_mismatch=1e-2)
