"""End-to-end integrator behavior on tiny renders (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from art_tpu.models import build_scene
from art_tpu.render.integrator import trace
from art_tpu.render.renderer import RenderConfig, render_scene
from art_tpu.scene.builder import SceneBuilder
from art_tpu.scene.materials import DiffuseLight, Lambertian
from art_tpu.scene.objects import Quad, Sphere


def _cfg(nx=32, ny=18, spp=4, **kw):
    return RenderConfig(nx=nx, ny=ny, spp=spp, **kw)


def test_empty_scene_renders_gradient_background():
    b = SceneBuilder()
    # one sphere far behind the camera so tables are non-degenerate
    b.add(Sphere((0, 0, 100), 1.0, Lambertian((0.5, 0.5, 0.5))))
    b.set_camera(
        lookfrom=(0, 0, 0), lookat=(0, 0, -1), vup=(0, 1, 0),
        vfov_degrees=90.0, aspect=2.0, aperture=0.0, focus_dist=1.0,
    )
    b.set_background(gradient=True)
    sc = b.compile()
    fb, _ = render_scene(sc, _cfg(gamma=1.0))
    # top rows bluer than bottom rows (gradient by y)
    top = fb[-1].mean(axis=0)
    bottom = fb[0].mean(axis=0)
    assert top[2] > 0.9  # blue channel saturated in lerp
    assert bottom[0] > top[0]  # bottom whiter (more red)
    assert np.isfinite(fb).all()


def test_emissive_quad_fills_view():
    """A light quad covering the camera view: radiance == emission exactly."""
    b = SceneBuilder()
    b.add(Quad((-50, -50, -2), (100, 0, 0), (0, 100, 0), DiffuseLight((2.0, 3.0, 4.0))))
    b.set_camera(
        lookfrom=(0, 0, 0), lookat=(0, 0, -1), vup=(0, 1, 0),
        vfov_degrees=60.0, aspect=1.0, aperture=0.0, focus_dist=1.0,
    )
    b.set_background((0, 0, 0))
    sc = b.compile()
    fb, _ = render_scene(sc, _cfg(nx=8, ny=8, spp=2, gamma=1.0))
    np.testing.assert_allclose(fb, np.broadcast_to([2.0, 3.0, 4.0], fb.shape), rtol=1e-4)


def test_black_background_no_light_is_black():
    b = SceneBuilder()
    b.add(Sphere((0, 0, -3), 1.0, Lambertian((0.5, 0.5, 0.5))))
    b.set_camera(
        lookfrom=(0, 0, 0), lookat=(0, 0, -1), vup=(0, 1, 0),
        vfov_degrees=60.0, aspect=1.0, aperture=0.0, focus_dist=1.0,
    )
    b.set_background((0, 0, 0))
    sc = b.compile()
    fb, _ = render_scene(sc, _cfg(nx=16, ny=16, spp=2, gamma=1.0))
    np.testing.assert_allclose(fb, 0.0, atol=1e-6)


def test_gamma_application():
    b = SceneBuilder()
    b.add(Quad((-50, -50, -2), (100, 0, 0), (0, 100, 0), DiffuseLight((0.25, 0.25, 0.25))))
    b.set_camera(
        lookfrom=(0, 0, 0), lookat=(0, 0, -1), vup=(0, 1, 0),
        vfov_degrees=60.0, aspect=1.0, aperture=0.0, focus_dist=1.0,
    )
    sc = b.compile()
    fb1, _ = render_scene(sc, _cfg(nx=4, ny=4, spp=1, gamma=1.0))
    fb2, _ = render_scene(sc, _cfg(nx=4, ny=4, spp=1, gamma=2.0))
    np.testing.assert_allclose(fb2, np.sqrt(fb1), rtol=1e-5)


def test_depth_limit_terminates():
    """Mirror-box scene cannot loop forever: max_depth bounds the loop."""
    sc = build_scene("three_spheres", 16, 9)
    fb, stats = render_scene(sc, _cfg(nx=16, ny=9, spp=2, max_depth=3))
    assert np.isfinite(fb).all()
    # ray count bounded by (queue + pool padding) * depth
    from art_tpu.render.renderer import sample_counts

    max_q = sample_counts(stats["tile_pixels"], stats["spp_chunk"], stats["n_slots"]).sum()
    assert stats["rays"] <= max_q * 3 + 1


def test_three_spheres_sanity():
    sc = build_scene("three_spheres", 64, 36)
    fb, stats = render_scene(sc, _cfg(nx=64, ny=36, spp=8))
    assert fb.shape == (36, 64, 3)
    assert np.isfinite(fb).all()
    assert fb.min() >= 0.0
    # sky visible: upper corners close to gradient blue after gamma
    assert fb[-1, 0, 2] > 0.8
    # something darker than sky exists (spheres shade the scene)
    assert fb.mean() < 0.9


def test_determinism_same_seed():
    sc = build_scene("three_spheres", 32, 18)
    fb1, _ = render_scene(sc, _cfg(spp=2, seed=7))
    fb2, _ = render_scene(sc, _cfg(spp=2, seed=7))
    np.testing.assert_array_equal(fb1, fb2)
    fb3, _ = render_scene(sc, _cfg(spp=2, seed=8))
    assert np.any(fb3 != fb1)


def test_trace_direct_call():
    sc = build_scene("three_spheres", 8, 8)
    n = 16
    o = jnp.zeros((n, 3), jnp.float32)
    d = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32), (n, 1))
    t = jnp.zeros((n,), jnp.float32)
    rad, rays = trace(
        sc.tables, o, d, t, jax.random.PRNGKey(0),
        jnp.zeros(3, jnp.float32), True, 10,
    )
    assert rad.shape == (n, 3)
    assert float(rays) >= n  # at least one bounce each


@pytest.mark.parametrize(
    "mode", ["aos4", "planar", "planar_drop", "drop", "subslot"]
)
def test_flush_modes_match_scatter_flush(monkeypatch, mode):
    """Every framebuffer flush mode accumulates the same radiance as the
    default ``aos`` scatter-add (same samples; only the summation order
    differs)."""
    from art_tpu.render import integrator, renderer

    scene = build_scene("three_spheres", 48, 27)
    cfg = RenderConfig(nx=48, ny=27, spp=8, max_depth=8)
    monkeypatch.setattr(integrator, "_FLUSH_ENV", "aos")
    # the flush mode is not part of the jit cache key: force a retrace, or
    # the second render silently reuses the first compiled program
    renderer._wavefront_jit.clear_cache()
    ref, _ = render_scene(scene, cfg)
    renderer._wavefront_jit.clear_cache()
    monkeypatch.setattr(integrator, "_FLUSH_ENV", mode)
    got, _ = render_scene(scene, cfg)
    renderer._wavefront_jit.clear_cache()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_plan_batches_balances_spp_chunks():
    """spp=513 with a 512-cap queue must not render 2x512=1024 samples;
    chunks are balanced (2x257) like tiles are."""
    from art_tpu.render.renderer import RenderConfig, plan_batches

    cfg = RenderConfig(nx=1024, ny=1024, spp=513)
    tile_pixels, spp_chunk, _ = plan_batches(1024 * 1024, 513, 8, cfg)
    n_chunks = -(-513 // spp_chunk)
    assert n_chunks * spp_chunk - 513 < n_chunks  # overshoot < 1/chunk
    assert spp_chunk == 257
