"""CUDA cross-lowering of the whole wavefront program, on the CPU host.

``jit(f).trace(...).lower(lowering_platforms=("cuda",))`` runs JAX's own
lowering for the GPU without a card.  What only the card's compiler can
refuse shows in ``chip_smoke.py``.

Every matrix product must ask for HIGHEST precision, so none runs in TF32.
"""

import re
from functools import partial

import jax
import jax.numpy as jnp
import pytest

from art_tpu.models import SCENES, build_scene
from art_tpu.parallel.sharding import make_mesh, sharded_render_step
from art_tpu.render.integrator import render_wavefront

NX, NY, SPP, DEPTH = 16, 8, 2, 4
SLOTS = 1 << 16


def _check(text: str) -> None:
    dots = [l for l in text.splitlines() if "stablehlo.dot_general" in l]
    assert dots, "expected the one-hot row fetches"
    for line in dots:
        prec = re.search(r"precision = \[([^\]]*)\]", line)
        assert prec and set(p.strip() for p in prec.group(1).split(",")) == {
            "HIGHEST"
        }, line


@pytest.mark.parametrize("name", sorted(SCENES))
def test_wavefront_lowers_for_cuda(name):
    sc = build_scene(name, NX, NY)
    f = jax.jit(partial(
        render_wavefront, spp=SPP, tile_pixels=NX * NY,
        total_pixels=NX * NY, nx=NX, ny=NY, max_depth=DEPTH,
        gradient_bg=sc.gradient_bg, n_slots=SLOTS,
    ))
    lowered = f.trace(
        sc.tables, sc.camera, jnp.int32(0), key=jax.random.PRNGKey(0),
        background=jnp.asarray(sc.background, jnp.float32),
    ).lower(lowering_platforms=("cuda",))
    _check(lowered.as_text())


@pytest.mark.parametrize("name", sorted(SCENES))
def test_sharded_step_lowers_for_cuda(name):
    """The sharded step on a (2, 2) mesh: the psum over ``spp`` included."""
    mesh = make_mesh((2, 2), devices=jax.devices()[:4])
    sc = build_scene(name, NX, NY)
    f = jax.jit(partial(
        sharded_render_step, mesh, nx=NX, ny=NY, spp_chunk=SPP,
        max_depth=DEPTH, gradient_bg=sc.gradient_bg, n_slots=SLOTS,
    ))
    lowered = f.trace(
        sc.tables, sc.camera, jnp.arange(NX * NY, dtype=jnp.int32),
        jax.random.PRNGKey(0), jnp.asarray(sc.background, jnp.float32),
    ).lower(lowering_platforms=("cuda",))
    text = lowered.as_text()
    _check(text)
    assert "all_reduce" in text
