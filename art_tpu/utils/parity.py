"""Downsampled image statistics: the repo's statistical parity gate.

A render is compared with a golden image through a coarse 16x8 grid: the
luminance correlation of the two grids and the largest per-channel
difference of their means.  Monte-Carlo noise averages out on that grid,
so two renders of one scene agree at any spp while a wrong shading, a
missing object or a darkened image does not.

``downsample`` reproduces Pillow's ``Image.resize(..., BILINEAR)`` on 8-bit
RGB exactly (separable triangle filter widened by the scale factor,
22-bit fixed-point weights, horizontal pass first, rounded to 8 bits after
each pass), so statistics computed here match those computed with Pillow
and no image library is needed.
"""

from __future__ import annotations

import json
import os

import numpy as np

GRID = (16, 8)  # (width, height), Pillow's size order
_PRECISION_BITS = 32 - 8 - 2
GOLDEN_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tests", "goldens",
)


def _resample_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) int64 fixed-point bilinear weights (Pillow's
    precompute_coeffs + normalize_coeffs_8bpc)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    w = np.zeros((out_size, in_size), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        x = np.arange(xmin, xmax)
        k = np.maximum(0.0, 1.0 - np.abs((x - center + 0.5) * ss))
        total = k.sum()
        if total != 0.0:
            k = k / total
        fixed = np.where(
            k < 0.0,
            np.trunc(-0.5 + k * (1 << _PRECISION_BITS)),
            np.trunc(0.5 + k * (1 << _PRECISION_BITS)),
        )
        w[xx, xmin:xmax] = fixed.astype(np.int64)
    return w


def _pass(img: np.ndarray, w: np.ndarray, axis: int) -> np.ndarray:
    acc = np.tensordot(img.astype(np.int64), w, axes=([axis], [1]))
    acc = np.moveaxis(acc, -1, axis)
    acc = (acc + (1 << (_PRECISION_BITS - 1))) >> _PRECISION_BITS
    return np.clip(acc, 0, 255).astype(np.uint8)


def downsample(img: np.ndarray, grid=GRID) -> np.ndarray:
    """(H, W, 3) image, uint8 or float in [0, 1] (row 0 = top), to a
    (grid[1], grid[0], 3) float32 grid in [0, 1]."""
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    h, w, _ = img.shape
    gw, gh = grid
    if gw != w:
        img = _pass(img, _resample_weights(w, gw), axis=1)
    if gh != h:
        img = _pass(img, _resample_weights(h, gh), axis=0)
    return img.astype(np.float32) / 255.0


def render_grid(fb: np.ndarray) -> np.ndarray:
    """Grid of a renderer framebuffer (row 0 = bottom, unclipped)."""
    return downsample(np.clip(np.asarray(fb)[::-1], 0.0, 1.0))


def grid_stats(grid: np.ndarray) -> dict:
    return {
        "lum": grid.mean(-1).ravel().tolist(),
        "mean_rgb": grid.mean((0, 1)).tolist(),
    }


def compare(a, b) -> tuple[float, float]:
    """(luminance correlation, max per-channel mean difference) between two
    grids, or a grid and a ``grid_stats`` dict."""
    def parts(x):
        if isinstance(x, dict):
            return (np.asarray(x["lum"], np.float32),
                    np.asarray(x["mean_rgb"], np.float32))
        return x.mean(-1).ravel(), x.mean((0, 1))

    lum_a, mean_a = parts(a)
    lum_b, mean_b = parts(b)
    corr = float(np.corrcoef(lum_a, lum_b)[0, 1])
    mean_diff = float(np.abs(mean_a - mean_b).max())
    return corr, mean_diff


def load_golden(name: str) -> dict:
    with open(os.path.join(GOLDEN_DIR, f"{name}.json")) as f:
        return json.load(f)
