"""Vectorized texture evaluation over hit batches (component-planar).

Replaces the reference's virtual ``texture::value(u,v,p)`` dispatch
(reference src/texture.cuh:9-164) with a two-phase masked evaluation:

1. *Redirect phase* (static MAX_TEX_DEPTH iterations): wrapper textures
   resolve to a leaf id — ``checker`` picks its even/odd child from the 3-D
   lattice parity (src/texture.cuh:35-42), ``uv_offset`` rotates/clamps the
   UVs and forwards to its base (src/texture.cuh:151-164).
2. *Leaf phase*: each leaf type present in the scene (static metadata) is
   evaluated once for the whole batch and blended by type mask — solid,
   image (nearest texel, v-flip, src/texture.cuh:51-59), perlin marble
   (src/texture.cuh:67-71), noodle stripes (src/texture.cuh:94-100) and
   felt mottling (src/texture.cuh:122-141).

Absent leaf types compile to nothing, so e.g. the Cornell scenes never pay
for Perlin noise.
"""

from __future__ import annotations

import jax.numpy as jnp

from art_tpu.core.vecmath import p_unstack, p_where
from art_tpu.ops import perlin
from art_tpu.scene.tables import SceneTables, TexType

MAX_TEX_DEPTH = 3  # wrapper chains in the reference are depth <= 2
_TURB_MAX = 7  # noise_texture uses turb(p, 7) (src/texture.cuh:69)

# perf-debug ablation stubs (read once at import, like integrator._DBG):
# fake_image replaces the per-ray atlas gather with cheap arithmetic that
# keeps the (img_id, u, v) dependencies alive; fake_turb likewise for the
# 7-octave perlin turbulence.
_DBG = __import__("os").environ.get("ART_TPU_DBG", "")


def _smoothstep(edge0, edge1, x):
    """Cubic Hermite smoothstep (reference src/texture.cuh:78-82)."""
    t = jnp.clip((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def eval_texture_p(
    tables: SceneTables,
    tex_id: jnp.ndarray,  # (R,) int32
    u: jnp.ndarray,  # (R,)
    v: jnp.ndarray,  # (R,)
    p,  # 3-tuple of (R,) planes
):
    """Returns a 3-tuple of (R,) color planes."""
    from art_tpu.ops.gather import take_rows

    present = set(tables.tex_types_present)
    tex_id = jnp.clip(tex_id, 0, tables.tex_type.shape[0] - 1)
    px, py, pz = p

    # Packed texture row: [type, p0..p7, child0, child1, img, rgb(3), rgb2(3)]
    row = take_rows(tables.tex_packed, tex_id)

    # ---- phase 1: resolve wrappers to leaves ----
    if TexType.CHECKER in present or TexType.UV_OFFSET in present:
        for _ in range(MAX_TEX_DEPTH):
            ttype = row[:, 0].astype(jnp.int32)
            new_tex_id = tex_id
            if TexType.CHECKER in present:
                inv_scale = row[:, 1]
                xi = jnp.floor(inv_scale * px).astype(jnp.int32)
                yi = jnp.floor(inv_scale * py).astype(jnp.int32)
                zi = jnp.floor(inv_scale * pz).astype(jnp.int32)
                is_even = ((xi + yi + zi) & 1) == 0
                child = jnp.where(
                    is_even, row[:, 9], row[:, 10]
                ).astype(jnp.int32)
                is_checker = ttype == TexType.CHECKER
                new_tex_id = jnp.where(is_checker, child, new_tex_id)
            if TexType.UV_OFFSET in present:
                du = row[:, 1]
                dv = row[:, 2]
                is_off = ttype == TexType.UV_OFFSET
                uu = u + du
                uu = uu - jnp.floor(uu)  # wrap to [0,1)
                vv = jnp.clip(v + dv, 0.0, 1.0)
                u = jnp.where(is_off, uu, u)
                v = jnp.where(is_off, vv, v)
                new_tex_id = jnp.where(
                    is_off, row[:, 9].astype(jnp.int32), new_tex_id
                )
            tex_id = new_tex_id
            row = take_rows(tables.tex_packed, tex_id)

    # ---- phase 2: leaf evaluation ----
    ttype = row[:, 0].astype(jnp.int32)
    out = (row[:, 12], row[:, 13], row[:, 14])  # SOLID default (rgb)

    if TexType.IMAGE in present:
        img_id = row[:, 11].astype(jnp.int32)
        if "fake_image" in _DBG:  # perf-debug: dependency-preserving stub
            s = img_id.astype(jnp.float32) + u + v
            img_val = jnp.stack([s, s * 0.5, s * 0.25], axis=-1)
        else:
            img_val = tables.atlas.sample(img_id, u, v)
        out = p_where(
            ttype == TexType.IMAGE,
            (img_val[:, 0], img_val[:, 1], img_val[:, 2]),
            out,
        )

    needs_turb = present & {TexType.NOISE, TexType.NOODLE, TexType.FELT}
    if needs_turb:
        if TexType.NOISE in present:
            # marble: 0.5*(1 + sin(scale*z + 10*turb(p,7)))  (src/texture.cuh:67-71)
            scale = row[:, 1]
            if "fake_turb" in _DBG:  # perf-debug: dependency-preserving stub
                tb = 0.1 * (px + py + pz)
            else:
                tb = perlin.turb_p(px, py, pz, _TURB_MAX)
            t = 0.5 * (1.0 + jnp.sin(scale * pz + 10.0 * tb))
            out = p_where(ttype == TexType.NOISE, (t, t, t), out)

        if TexType.NOODLE in present:
            # warped stripes (src/texture.cuh:94-100); params = [k, A, f, oct, dx, dy, dz]
            k, amp, f = row[:, 1], row[:, 2], row[:, 3]
            oct = row[:, 4].astype(jnp.int32)
            un = px * row[:, 5] + py * row[:, 6] + pz * row[:, 7]
            if "fake_turb" in _DBG:  # perf-debug: dependency-preserving stub
                wig = 0.1 * (px + py + pz) * f + 1e-8 * oct.astype(jnp.float32)
            else:
                wig = perlin.turb_p(
                    px * f, py * f, pz * f, _TURB_MAX, depth_mask=oct
                )
            stripes = jnp.abs(jnp.sin(k * un + amp * wig))
            t = _smoothstep(0.75, 0.98, stripes)
            col = (
                (1.0 - t) * row[:, 15] + t * row[:, 12],
                (1.0 - t) * row[:, 16] + t * row[:, 13],
                (1.0 - t) * row[:, 17] + t * row[:, 14],
            )
            out = p_where(ttype == TexType.NOODLE, col, out)

        if TexType.FELT in present:
            # mottling + directional fibers (src/texture.cuh:122-141);
            # params = [m_scale, m_amt, f_scale, f_amt]
            m_scale, m_amt = row[:, 1], row[:, 2]
            f_scale, f_amt = row[:, 3], row[:, 4]
            m = perlin.noise_p(px * m_scale, py * m_scale, pz * m_scale)
            phase = px * f_scale + 2.0 * perlin.turb_p(
                px * 0.5, py * 0.5, pz * 0.5, 2
            )
            fibers = 0.5 * (1.0 + jnp.sin(phase))
            gain = 1.0 + m_amt * (m - 0.5) + f_amt * (fibers - 0.5)
            gain = jnp.clip(gain, 0.7, 1.2)
            col = (row[:, 12] * gain, row[:, 13] * gain, row[:, 14] * gain)
            out = p_where(ttype == TexType.FELT, col, out)

    return out


def eval_texture(
    tables: SceneTables,
    tex_id: jnp.ndarray,
    u: jnp.ndarray,
    v: jnp.ndarray,
    p: jnp.ndarray,  # (R,3)
) -> jnp.ndarray:  # (R,3)
    """Array-of-struct wrapper (portable API, used by tests)."""
    out = eval_texture_p(tables, tex_id, u, v, p_unstack(p))
    return jnp.stack(out, axis=-1)
