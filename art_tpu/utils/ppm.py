"""PPM P3 output with the reference's exact contract, plus a PNG copy.

The reference writes the image to **stdout** as ASCII PPM, rows top-down
(j = ny-1 .. 0), each channel as ``int(255.99 * c)`` with **no clamping**
(reference src/main.cu:715-727), so emissive scenes can produce out-of-range
P3 values.  ``write_ppm`` reproduces that bit-for-bit by default; clamping is
an explicit opt-in flag (a deliberate-quirk decision documented in
SURVEY.md §7).
"""

from __future__ import annotations

import ctypes
import io
import os
import struct
import subprocess
import zlib

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(__file__)), "native"
)
_native_lib = None
_native_tried = False


def _load_native():
    """Build (once, cached as a .so next to the source) and load the C++
    formatter; any failure falls back to the Python writer silently."""
    global _native_lib, _native_tried
    if _native_tried:
        return _native_lib
    _native_tried = True
    src = os.path.join(_NATIVE_DIR, "ppm_writer.cpp")
    so = os.path.join(_NATIVE_DIR, "libppm.so")
    try:
        if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-o", so, src],
                check=True, capture_output=True, timeout=120,
            )
        lib = ctypes.CDLL(so)
        lib.ppm_format_body.restype = ctypes.c_size_t
        lib.ppm_format_body.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_char_p,
        ]
        _native_lib = lib
    except Exception:  # noqa: BLE001 — native path is best-effort
        _native_lib = None
    return _native_lib


def format_ppm(fb: np.ndarray, clamp: bool = False) -> str:
    """Format a (ny, nx, 3) float framebuffer (row 0 = bottom scanline) as PPM P3.

    Row 0 of ``fb`` is the *bottom* of the image (the reference framebuffer
    is indexed pixel = j*nx + i with j growing upward); rows are emitted
    top-down exactly like the reference writer loop (src/main.cu:717-727).
    Uses the native formatter (native/ppm_writer.cpp) when it builds;
    otherwise a pure-Python writer with identical output.
    """
    fb = np.asarray(fb, np.float64)
    ny, nx, _ = fb.shape
    vals = fb * 255.99
    if clamp:
        vals = np.clip(vals, 0.0, 255.0)
    # int() in C++ truncates toward zero.  NaN pixels cast to INT64_MIN
    # (matching C++ UB-in-practice); silence numpy's RuntimeWarning for
    # that cast — the sizing below already handles the value.
    with np.errstate(invalid="ignore"):
        ints = np.ascontiguousarray(np.trunc(vals).astype(np.int64))
    header = f"P3\n{nx} {ny}\n255\n"

    lib = _load_native()
    if lib is not None:
        # exact worst-case sizing from the widest value actually present;
        # min/max separately (np.abs(INT64_MIN) — a NaN pixel — is itself
        # negative, so an abs()-based bound would undersize the buffer)
        digits = (
            max(len(str(int(ints.max()))), len(str(int(ints.min())))) + 1
            if ints.size else 2
        )
        buf = ctypes.create_string_buffer(3 * (digits + 1) * ny * nx + 64)
        n = lib.ppm_format_body(
            ints.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(ny), ctypes.c_int64(nx), buf,
        )
        return header + buf.raw[:n].decode("ascii")

    out = io.StringIO()
    out.write(header)
    # top-down: j = ny-1 .. 0
    for j in range(ny - 1, -1, -1):
        row = ints[j]
        out.write("\n".join(f"{r} {g} {b}" for r, g, b in row))
        out.write("\n")
    return out.getvalue()


def write_ppm(fb: np.ndarray, stream, clamp: bool = False) -> None:
    stream.write(format_ppm(fb, clamp=clamp))


def png_bytes(fb: np.ndarray) -> bytes:
    """Encode a (ny, nx, 3) framebuffer (row 0 = bottom, values in [0, 1])
    as an 8-bit RGB PNG, top row first, with the standard library only."""
    img = (np.clip(np.asarray(fb, np.float64)[::-1], 0.0, 1.0) * 255.0 + 0.5)
    img = np.ascontiguousarray(img.astype(np.uint8))
    ny, nx, _ = img.shape
    # filter type 0 (none) before every scanline
    raw = np.concatenate(
        [np.zeros((ny, 1), np.uint8), img.reshape(ny, nx * 3)], axis=1
    ).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", nx, ny, 8, 2, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 9)) + chunk(b"IEND", b"")
    )


def write_png(fb: np.ndarray, path: str) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(fb))


def read_ppm(text: str) -> np.ndarray:
    """Parse a P3 PPM back into a (ny, nx, 3) int array (row 0 = bottom).

    Used by the test suite to round-trip the output contract.
    """
    tokens = []
    for line in text.splitlines():
        line = line.split("#", 1)[0]
        tokens.extend(line.split())
    assert tokens[0] == "P3", "not a P3 PPM"
    nx, ny, _maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
    data = np.array(tokens[4:], dtype=np.int64).reshape(ny, nx, 3)
    # File rows are top-down; flip back to bottom-up framebuffer order.
    return data[::-1]
