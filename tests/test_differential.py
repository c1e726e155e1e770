"""Randomized scene-level differential test.

``closest_surface_p`` must match a float64 NumPy reference
(tests/hit_reference.py) on scenes *generated at random*, not just the
registered scenes.  This covers combinations the fixed scenes never
exercise together: a 200-sphere (radius, material)-uniform cluster next to
a hollow (negative-radius) shell, moving and static spheres in one small
pool, rotated and axis-aligned boxes in one table, arbitrary
Translate/RotateY chains — winner selection across primitive families and
the winner's material and sphere normal included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from art_tpu.core.vecmath import T_MIN
from art_tpu.ops import intersect
from art_tpu.scene.builder import SceneBuilder
from art_tpu.scene.materials import Dielectric, DiffuseLight, Lambertian, Metal
from art_tpu.scene.objects import Box, Quad, RotateY, Sphere, Translate
from art_tpu.scene.textures import Checker, SolidColor
from hit_reference import reference_hits

N_RAYS = 4096


def _random_scene(seed: int):
    rng = np.random.default_rng(seed)

    def vec(lo, hi, n=3):
        return tuple(float(x) for x in rng.uniform(lo, hi, n))

    mats = [
        Lambertian(vec(0.1, 0.9)),
        Lambertian(Checker(0.5, SolidColor(vec(0, 1)), SolidColor(vec(0, 1)))),
        Metal(vec(0.5, 1.0), float(rng.uniform(0, 1))),
        Dielectric(1.5),
        DiffuseLight(vec(1, 6)),
    ]

    b = SceneBuilder()
    b.add(Sphere((0.0, -1000.0, 0.0), 1000.0, mats[1]))  # ground

    # mixed static spheres
    for _ in range(int(rng.integers(4, 12))):
        b.add(Sphere(vec(-8, 8), float(rng.uniform(0.3, 1.5)),
                     mats[int(rng.integers(len(mats)))]))
    # moving spheres
    for _ in range(int(rng.integers(2, 5))):
        c = vec(-8, 8)
        b.add(Sphere(c, float(rng.uniform(0.2, 0.8)),
                     mats[int(rng.integers(len(mats)))],
                     center2=tuple(c[i] + rng.uniform(-0.5, 0.5)
                                   for i in range(3))))
    # hollow shell: negative radius => builder pos_r gate False
    b.add(Sphere((3.0, 1.0, 3.0), 1.0, Dielectric(1.5)))
    b.add(Sphere((3.0, 1.0, 3.0), -0.9, Dielectric(1.5)))

    # (radius, material)-uniform cluster big enough to trigger the
    # constant-attribute tail loop (pack_spheres _TAIL_MIN = 192)
    tail_mat = mats[0]
    for _ in range(200):
        b.add(Sphere(vec(-30, 30), 0.5, tail_mat))

    # quads (random parallelograms)
    for _ in range(int(rng.integers(2, 5))):
        b.add(Quad(vec(-8, 8), vec(-3, 3), vec(-3, 3),
                   mats[int(rng.integers(len(mats)))]))

    # boxes: axis-aligned + transformed
    for _ in range(2):
        a = np.array(vec(-8, 8))
        b.add(Box(tuple(a), tuple(a + rng.uniform(0.5, 3.0, 3)),
                  mats[int(rng.integers(len(mats)))]))
    for _ in range(2):
        a = np.array(vec(-8, 8))
        box = Box(tuple(a), tuple(a + rng.uniform(0.5, 3.0, 3)),
                  mats[int(rng.integers(len(mats)))])
        b.add(Translate(RotateY(box, float(rng.uniform(-80, 80))),
                        vec(-2, 2)))

    b.set_camera(lookfrom=(13, 2, 3), lookat=(0, 0, 0), vup=(0, 1, 0),
                 vfov_degrees=30.0, aspect=1.0)
    return b.compile()


def _ray_batch(seed: int, n: int):
    k0, k1, k2 = jax.random.split(jax.random.PRNGKey(seed), 3)
    o = (jax.random.uniform(k0, (n, 3), jnp.float32) - 0.5) * 24.0
    o = o + jnp.asarray([0.0, 4.0, 0.0], jnp.float32)
    d = jax.random.normal(k1, (n, 3), jnp.float32)
    tm = jax.random.uniform(k2, (n,), jnp.float32)
    return (o[:, 0], o[:, 1], o[:, 2]), (d[:, 0], d[:, 1], d[:, 2]), tm


@pytest.mark.parametrize("seed", [11, 23])
def test_random_scene_matches_float64_reference(seed):
    scene = _random_scene(seed)
    tables = scene.tables
    # the generated scene must hold every primitive form
    assert (np.asarray(tables.sph_radius) < 0).any()  # hollow shell
    assert tables.has_moving and tables.has_rotated_boxes
    assert tables.n_boxes >= 4 and tables.n_quads >= 2

    o, d, tm = _ray_batch(seed, N_RAYS)
    rec = intersect.closest_surface_p(tables, o, d, tm, T_MIN)
    t_ref, kind, idx = reference_hits(tables, o, d, tm)

    hit_ref = kind >= 0
    hit = np.asarray(rec.hit)
    assert hit_ref.any() and (~hit_ref).any()
    # hit sets identical up to measure-zero tangents (none expected on
    # random float inputs)
    np.testing.assert_array_equal(hit, hit_ref)

    t = np.asarray(rec.t)
    np.testing.assert_allclose(t[hit_ref], t_ref[hit_ref], rtol=2e-2, atol=1e-2)
    # near-tie winners may swap between equal-t objects, so gate the
    # winner's attributes on tight-t agreement
    tight = np.isclose(t, t_ref, rtol=2e-4, atol=1e-4) & hit_ref
    assert tight.mean() / hit_ref.mean() >= 0.98

    mats = {0: tables.sph_mat, 1: tables.quad_mat, 2: tables.box_mat}
    mat_ref = np.zeros_like(idx)
    for k, col in mats.items():
        mat_ref = np.where(kind == k, np.take(np.asarray(col), idx, mode="clip"),
                           mat_ref)
    mat_match = np.asarray(rec.mat) == mat_ref
    assert (mat_match | ~tight).mean() >= 0.995

    # sphere normals: (p - center(time)) / signed radius, in float64
    sph = tight & mat_match & (kind == 0)
    assert sph.any()
    o64 = np.stack([np.asarray(c, np.float64) for c in o], 1)[sph]
    d64 = np.stack([np.asarray(c, np.float64) for c in d], 1)[sph]
    i = idx[sph]
    center = (np.asarray(tables.sph_center, np.float64)[i]
              + np.asarray(tm, np.float64)[sph, None]
              * np.asarray(tables.sph_vel, np.float64)[i])
    n_ref = ((o64 + t_ref[sph, None] * d64 - center)
             / np.asarray(tables.sph_radius, np.float64)[i, None])
    for c in range(3):
        np.testing.assert_allclose(np.asarray(rec.normal[c])[sph], n_ref[:, c],
                                   rtol=5e-3, atol=5e-3)
