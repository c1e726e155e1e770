"""The plain jnp paths of the wavefront against NumPy references: the
framebuffer flush, the image-texel fetch, Perlin turbulence and the pool's
refill bookkeeping."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from art_tpu.ops import perlin
from art_tpu.render import integrator
from art_tpu.render.integrator import render_wavefront
from art_tpu.scene.builder import SceneBuilder
from art_tpu.scene.materials import DiffuseLight, Lambertian
from art_tpu.scene.objects import Quad, Sphere
from art_tpu.utils.images import ImageAtlas, asset_path, load_image_rgb

TEXTURES = ["8ball.jpg", "earthmap.jpg", "hardwood.jpg", "poolball.jpg",
            "porcelain.jpg"]


# ---------------------------------------------------------------------------
# framebuffer flush
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "mode", ["aos", "aos4", "planar", "planar_drop", "drop", "subslot"]
)
def test_flush_accumulates_colliding_pixels(mode):
    """Many died rays share a pixel: every mode sums them all, and rays
    still alive add nothing (np.add.at semantics)."""
    rng = np.random.default_rng(0)
    n_pixels, n_rays = 13, 257
    pix = rng.integers(0, n_pixels, n_rays).astype(np.int32)
    pix[:40] = 5  # one heavily colliding pixel
    died = rng.random(n_rays) < 0.6
    rad = rng.random((3, n_rays)).astype(np.float32)

    fb = integrator.flush_init(mode, n_pixels)
    for _ in range(2):  # accumulates across iterations
        fb = integrator.flush(
            fb, jnp.asarray(pix), jnp.asarray(died),
            tuple(jnp.asarray(c) for c in rad), mode, n_pixels,
        )
    got = np.asarray(integrator.flush_result(fb, mode, n_pixels))

    want = np.zeros((n_pixels, 3), np.float64)
    np.add.at(want, pix[died], rad[:, died].T.astype(np.float64))
    np.testing.assert_allclose(got, 2 * want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# image texels
# ---------------------------------------------------------------------------


def _texel_reference(img, u, v):
    """Nearest texel with clamp and v-flip (reference src/texture.cuh:51-59)."""
    h, w, _ = img.shape
    u = np.clip(u, 0.0, 1.0)
    v = np.clip(v, 0.0, 1.0)
    i = np.minimum((u * w).astype(np.int64), w - 1)
    j = np.minimum(((1.0 - v) * h).astype(np.int64), h - 1)
    return img[j, i].astype(np.float32) * np.float32(1.0 / 255.0)


@pytest.fixture(scope="module")
def atlas():
    images = [load_image_rgb(asset_path(n)) for n in TEXTURES]
    return images, ImageAtlas.pack(images)


@pytest.mark.parametrize("k", range(len(TEXTURES)), ids=TEXTURES)
def test_texel_fetch_matches_numpy(atlas, k):
    images, packed = atlas
    rng = np.random.default_rng(k)
    u = rng.random(500).astype(np.float32)
    v = rng.random(500).astype(np.float32)
    got = packed.sample(jnp.full((500,), k, jnp.int32), jnp.asarray(u),
                        jnp.asarray(v))
    np.testing.assert_array_equal(np.asarray(got),
                                  _texel_reference(images[k], u, v))


def test_texel_fetch_clamps_out_of_range_uv(atlas):
    images, packed = atlas
    u = np.asarray([-0.5, 1.5, 0.0, 1.0], np.float32)
    v = np.asarray([0.5, 0.5, -2.0, 3.0], np.float32)
    got = packed.sample(jnp.zeros((4,), jnp.int32), jnp.asarray(u),
                        jnp.asarray(v))
    np.testing.assert_array_equal(np.asarray(got),
                                  _texel_reference(images[0], u, v))


def test_texel_fetch_flips_v(atlas):
    """v = 1 is the image's top row, v = 0 its bottom row."""
    images, packed = atlas
    img = images[2]  # hardwood: smaller than the atlas, so padding is skipped
    got = np.asarray(packed.sample(
        jnp.full((2,), 2, jnp.int32), jnp.asarray([0.0, 0.0], jnp.float32),
        jnp.asarray([0.9999, 0.0], jnp.float32),
    ))
    np.testing.assert_array_equal(got[0], img[0, 0] * np.float32(1.0 / 255.0))
    np.testing.assert_array_equal(got[1], img[-1, 0] * np.float32(1.0 / 255.0))


# ---------------------------------------------------------------------------
# Perlin turbulence against a float64 port of the reference hash chain
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _wanghash(x):
    x = x & _M32
    x = (x ^ 61) ^ (x >> 16)
    x = (x * 9) & _M32
    x = x ^ (x >> 4)
    x = (x * 0x27D4EB2D) & _M32
    return x ^ (x >> 15)


def _grad(i, j, k):
    h = _wanghash(((i & _M32) * 73856093 ^ (j & _M32) * 19349663
                   ^ (k & _M32) * 83492791) & _M32)

    def m11(x):
        return ((x >> 8) & 0xFFFFFF).astype(np.float64) / 8388607.5 - 1.0

    g = np.stack([m11(h), m11(_wanghash(h)), m11(_wanghash(h ^ 0x9E3779B9))])
    return g / np.sqrt(np.maximum((g * g).sum(0), 1e-30))


def _noise(p):
    f = np.floor(p)
    frac = p - f
    cell = f.astype(np.int64)
    s = frac * frac * (3.0 - 2.0 * frac)
    acc = np.zeros(p.shape[1])
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                off = np.asarray([di, dj, dk])[:, None]
                g = _grad(*(cell + off))
                wgt = np.prod(np.where(off == 1, s, 1.0 - s), axis=0)
                acc += wgt * (g * (frac - off)).sum(0)
    return acc


def _turb(p, depth):
    acc, w = np.zeros(p.shape[1]), 1.0
    for _ in range(depth):
        acc += w * _noise(p)
        w *= 0.5
        p = p * 2.0
    return np.abs(acc)


@pytest.mark.parametrize("depth", range(1, 8))
def test_turbulence_matches_float64_reference(depth):
    rng = np.random.default_rng(depth)
    p = rng.uniform(-50.0, 50.0, (3, 400)).astype(np.float32)
    got = perlin.turb_p(*(jnp.asarray(c) for c in p), depth)
    np.testing.assert_allclose(np.asarray(got), _turb(p.astype(np.float64), depth),
                               atol=2e-5)


# ---------------------------------------------------------------------------
# refill bookkeeping of the persistent pool
# ---------------------------------------------------------------------------


def _light_box_scene():
    """Every camera ray hits an emissive quad: a sample's radiance is
    exactly the emission."""
    b = SceneBuilder()
    b.add(Quad((-50, -50, -1), (100, 0, 0), (0, 100, 0),
               DiffuseLight((0.25, 0.5, 1.0))))
    b.set_camera(lookfrom=(0, 0, 0), lookat=(0, 0, -1), vup=(0, 1, 0),
                 vfov_degrees=60.0, aspect=1.0)
    return b.compile()


def _wavefront(scene, *, pix_offset, spp, tile, nx, ny, slots, depth=4):
    return render_wavefront(
        scene.tables, scene.camera, jnp.int32(pix_offset), spp,
        jax.random.PRNGKey(3), jnp.asarray(scene.background, jnp.float32),
        tile_pixels=tile, total_pixels=nx * ny, nx=nx, ny=ny,
        max_depth=depth, gradient_bg=scene.gradient_bg, n_slots=slots,
    )


@pytest.mark.parametrize("spp,slots", [(3, 256), (7, 1000)])
def test_every_pixel_gets_exactly_spp_samples(spp, slots):
    """Pool sizes that do not divide the queue: each pixel still sums
    exactly ``spp`` samples, and the pool traces exactly one segment per
    sample (each ray dies on the light)."""
    scene = _light_box_scene()
    fb, rays, iters = _wavefront(scene, pix_offset=40, spp=spp, tile=200,
                                 nx=20, ny=20, slots=slots)
    np.testing.assert_allclose(
        np.asarray(fb), np.tile([0.25, 0.5, 1.0], (200, 1)) * spp, rtol=1e-6
    )
    assert float(rays) == 200 * spp
    assert int(iters) == -(-200 * spp // slots)


def _sky_scene():
    b = SceneBuilder()
    b.add(Sphere((0, 0, 100), 1.0, Lambertian((0.5, 0.5, 0.5))))  # behind
    b.set_camera(lookfrom=(0, 0, 0), lookat=(0, 0, -1), vup=(0, 1, 0),
                 vfov_degrees=90.0, aspect=1.0)
    b.set_background(gradient=True)
    return b.compile()


@pytest.mark.parametrize("tile_index", [0, 1])
def test_tile_offset_maps_queue_rows_to_pixels(tile_index):
    """Row r of a tile's framebuffer is pixel ``pix_offset + r``: under a
    vertical sky gradient each row's red channel must match its pixel's
    scanline."""
    nx = ny = 16
    tile = nx * ny // 2
    scene = _sky_scene()
    spp = 4
    fb, _, _ = _wavefront(scene, pix_offset=tile_index * tile, spp=spp,
                          tile=tile, nx=nx, ny=ny, slots=300)
    red = np.asarray(fb)[:, 0] / spp
    pixel = tile_index * tile + np.arange(tile)
    j = pixel // nx
    # red = 1 - 0.5 * t with t rising with the scanline: each scanline's
    # mean must decrease with j and match the other rows of its scanline
    per_row = np.asarray([red[j == r].mean() for r in np.unique(j)])
    assert np.all(np.diff(per_row) < 0)
    for r in np.unique(j):
        assert np.ptp(red[j == r]) < 0.05
