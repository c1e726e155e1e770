"""Where the program runs and what it needs there: compile-cache placement,
backend selection, chip_smoke.py's refusals and contract line, the parity
statistic, and rendering without Pillow."""

import io
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke
from art_tpu.models import build_scene
from art_tpu.render.renderer import RenderConfig, render_scene
from art_tpu.utils import parity
from art_tpu.utils.device import device_record
from art_tpu.utils.images import ASSET_DIR, DECODED_TEXTURES, load_image_rgb
from art_tpu.utils.ppm import png_bytes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTURES = ["8ball.jpg", "earthmap.jpg", "hardwood.jpg", "poolball.jpg",
            "porcelain.jpg"]


def _run(args, env_extra=None, drop=(), cwd=REPO):
    env = dict(os.environ)
    for k in drop:
        env.pop(k, None)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=600,
    )


# ---------------------------------------------------------------------------
# compile cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("entry", ["art_tpu.cli", "__graft_entry__"])
@pytest.mark.parametrize("env_set", [False, True])
def test_compile_cache_placement(entry, env_set, tmp_path):
    """Importing an entry point points JAX's cache at
    $JAX_COMPILATION_CACHE_DIR, else at <checkout>/.jax_cache — also when
    JAX was imported first (the environment variable alone is read only at
    JAX's own import)."""
    code = (f"import jax, {entry}; "
            "print(jax.config.jax_compilation_cache_dir)")
    if env_set:
        p = _run(["-c", code], {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
        want = str(tmp_path)
    else:
        p = _run(["-c", code], drop=("JAX_COMPILATION_CACHE_DIR",))
        want = os.path.join(REPO, ".jax_cache")
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == want


def test_cli_platform_gpu_without_card_fails_loudly():
    p = _run(["-m", "art_tpu.cli", "--platform", "gpu", "--scene", "three_spheres",
              "--nx", "8", "--ny", "4", "--spp", "1"])
    assert p.returncode == 2
    assert "error: --platform gpu" in p.stderr
    assert p.stdout == ""


# ---------------------------------------------------------------------------
# chip_smoke.py
# ---------------------------------------------------------------------------


def test_smoke_refuses_a_cpu_backend():
    with pytest.raises(chip_smoke.SmokeFailure, match="not gpu"):
        chip_smoke.require_gpu()


def test_smoke_script_fails_on_cpu_without_contract_line():
    p = _run(["chip_smoke.py"])
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "not gpu" in p.stderr


def test_smoke_script_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    p = _run(["chip_smoke.py"], cwd=tmp_path, env_extra={"PYTHONPATH": ""})
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_contract_line_shape():
    line = json.loads(chip_smoke.contract_line(device_record()))
    assert line["ok"] is True
    dev = line["device"]
    assert set(dev) == {"platform", "kind", "count"}
    assert dev["platform"] == jax.devices()[0].platform
    assert dev["kind"] == jax.devices()[0].device_kind
    assert dev["count"] == len(jax.devices())


# ---------------------------------------------------------------------------
# the parity statistic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(800, 1200), (96, 96), (45, 80), (7, 33)])
def test_downsample_matches_pillow(shape):
    from PIL import Image

    rng = np.random.default_rng(shape[0])
    img = (rng.random((*shape, 3)) ** 2 * 255).astype(np.uint8)
    want = np.asarray(
        Image.fromarray(img).resize(parity.GRID, Image.BILINEAR), np.float32
    ) / 255.0
    np.testing.assert_array_equal(parity.downsample(img), want)


def test_compare_identical_and_against_stats():
    rng = np.random.default_rng(1)
    g = parity.downsample(rng.random((40, 60, 3)))
    assert parity.compare(g, g) == pytest.approx((1.0, 0.0))
    stats = json.loads(json.dumps(parity.grid_stats(g)))
    assert parity.compare(g, stats) == pytest.approx(parity.compare(g, g))
    darker = parity.compare(g, g * 0.9)
    assert darker[1] == pytest.approx(0.1 * g.mean((0, 1)).max(), rel=1e-5)


def test_render_grid_puts_the_top_scanline_first():
    fb = np.zeros((16, 32, 3))
    fb[-1] = 1.0  # renderer row -1 is the top scanline
    grid = parity.render_grid(fb)
    assert grid[0].mean() > grid[-1].mean()


# ---------------------------------------------------------------------------
# textures without Pillow
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "name", ["earth", "final_scene", "original_scene", "simple_light"]
)
def test_textured_scenes_build_without_pillow(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    scene = build_scene(name, 8, 4)
    assert scene.tables.atlas.hmax > 1
    if name == "earth":
        fb, _ = render_scene(scene, RenderConfig(nx=8, ny=4, spp=1))
        assert np.isfinite(fb).all() and fb.max() > 0


@pytest.mark.parametrize("name", TEXTURES)
def test_committed_texture_arrays_equal_the_jpeg_decode(name):
    from PIL import Image

    with Image.open(os.path.join(ASSET_DIR, name)) as im:
        want = np.asarray(im.convert("RGB"), np.uint8)
    with np.load(DECODED_TEXTURES) as bundled:
        np.testing.assert_array_equal(bundled[name], want)


def test_other_images_without_pillow_fail_clearly(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        load_image_rgb(str(tmp_path / "user.png"))


def test_png_copy_decodes_to_the_framebuffer():
    from PIL import Image

    fb = np.random.default_rng(2).random((5, 9, 3)) * 1.2
    img = np.asarray(Image.open(io.BytesIO(png_bytes(fb))))
    want = (np.clip(fb[::-1], 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(img, want)
