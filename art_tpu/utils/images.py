"""Host-side image decode + device image atlas.

Replaces the reference's stb_image + cudaMemcpy path (reference
src/image_io.h:16-46): images are decoded on host (decode is cold-path in
the reference too), forced to 3 channels like ``stbi_load(..., 3)``, and
packed into a padded ``(n, Hmax, Wmax)`` atlas so texture lookups are a
single gather with static shapes.

The bundled textures are stored pre-decoded in ``assets/textures/
decoded.npz`` (regenerate with ``python scripts/decode_textures.py``), so
rendering them needs no image library.  Any other image file is decoded
with Pillow, which is then required.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np

ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "assets", "textures")
DECODED_TEXTURES = os.path.join(ASSET_DIR, "decoded.npz")


def load_image_rgb(path: str) -> np.ndarray:
    """Decode an image to (H, W, 3) uint8 (reference src/image_io.h:24-41 semantics)."""
    name = os.path.basename(path)
    if os.path.dirname(os.path.abspath(path)) == ASSET_DIR:
        with np.load(DECODED_TEXTURES) as bundled:
            if name in bundled.files:
                return bundled[name]
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"decoding {path!r} needs Pillow (PIL), which is not installed; "
            "the bundled textures in assets/textures load without it"
        ) from e
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def asset_path(name: str) -> str:
    return os.path.join(ASSET_DIR, name)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ImageAtlas:
    """Padded stack of images + per-image dims, sampled nearest-neighbor.

    Texels are stored as ONE packed uint32 (R | G<<8 | B<<16) in a flat
    array and unpacked arithmetically after the fetch: a per-ray texture
    lookup is then a single-element 1-D gather (4 bytes per ray) instead
    of a 3-float slice from a 4-D array.  Unpack reproduces ``texel/255.0``
    exactly (reference color_scale, src/texture.cuh:56-59).
    """

    data: jnp.ndarray  # (n*Hmax*Wmax,) uint32 packed RGB8
    heights: jnp.ndarray  # (n,) int32
    widths: jnp.ndarray  # (n,) int32
    hmax: int = dataclasses.field(metadata=dict(static=True), default=1)
    wmax: int = dataclasses.field(metadata=dict(static=True), default=1)

    @staticmethod
    def empty() -> "ImageAtlas":
        return ImageAtlas(
            data=jnp.zeros((1,), jnp.uint32),
            heights=jnp.ones((1,), jnp.int32),
            widths=jnp.ones((1,), jnp.int32),
            hmax=1,
            wmax=1,
        )

    @staticmethod
    def pack(images: list[np.ndarray]) -> "ImageAtlas":
        if not images:
            return ImageAtlas.empty()
        hmax = max(im.shape[0] for im in images)
        wmax = max(im.shape[1] for im in images)
        if len(images) * hmax * wmax >= 1 << 31:
            # sample() computes the flat texel index in int32; past 2^31
            # it would wrap and silently fetch the wrong image's texels.
            raise ValueError(
                f"image atlas too large: {len(images)}x{hmax}x{wmax} texels "
                "overflows the int32 flat index (>= 2^31)"
            )
        data = np.zeros((len(images), hmax, wmax), np.uint32)
        hs, ws = [], []
        for i, im in enumerate(images):
            h, w = im.shape[:2]
            px = im.astype(np.uint32)
            data[i, :h, :w] = px[:, :, 0] | (px[:, :, 1] << 8) | (px[:, :, 2] << 16)
            hs.append(h)
            ws.append(w)
        return ImageAtlas(
            data=jnp.asarray(data.reshape(-1)),
            heights=jnp.asarray(hs, jnp.int32),
            widths=jnp.asarray(ws, jnp.int32),
            hmax=hmax,
            wmax=wmax,
        )

    def sample(
        self,
        img_id: jnp.ndarray,
        u: jnp.ndarray,
        v: jnp.ndarray,
    ) -> jnp.ndarray:
        """Nearest-texel sample with clamp + v-flip (reference src/texture.cuh:51-59)."""
        n = self.heights.shape[0]
        img_id = jnp.clip(img_id, 0, n - 1)
        w = self.widths[img_id]
        h = self.heights[img_id]
        uu = jnp.clip(u, 0.0, 1.0)
        vv = jnp.clip(v, 0.0, 1.0)
        i = jnp.minimum((uu * w.astype(jnp.float32)).astype(jnp.int32), w - 1)
        j = jnp.minimum(((1.0 - vv) * h.astype(jnp.float32)).astype(jnp.int32), h - 1)
        px = self.data[(img_id * self.hmax + j) * self.wmax + i]
        scale = jnp.float32(1.0 / 255.0)
        r = (px & 0xFF).astype(jnp.float32) * scale
        g = ((px >> 8) & 0xFF).astype(jnp.float32) * scale
        b = ((px >> 16) & 0xFF).astype(jnp.float32) * scale
        return jnp.stack([r, g, b], axis=-1)
