"""Decode the bundled JPEG textures into the committed uint8 arrays.

    python scripts/decode_textures.py

Writes ``assets/textures/decoded.npz`` (one (H, W, 3) uint8 array per
``*.jpg``, keyed by file name).  ``art_tpu.utils.images.load_image_rgb`` reads
the bundled textures from that file, so rendering them needs no image
library; only this script needs Pillow.
"""

import glob
import io
import os
import sys
import zipfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
from PIL import Image  # noqa: E402

from art_tpu.utils.images import ASSET_DIR, DECODED_TEXTURES  # noqa: E402


def main():
    arrays = {}
    for path in sorted(glob.glob(os.path.join(ASSET_DIR, "*.jpg"))):
        with Image.open(path) as im:
            arrays[os.path.basename(path)] = np.asarray(
                im.convert("RGB"), dtype=np.uint8
            )
    # an .npz by hand: fixed timestamps and the strongest deflate level
    # make the file reproducible and smallest
    with zipfile.ZipFile(DECODED_TEXTURES, "w") as z:
        for name, a in arrays.items():
            buf = io.BytesIO()
            np.save(buf, a)
            info = zipfile.ZipInfo(name + ".npy", date_time=(1980, 1, 1, 0, 0, 0))
            info.compress_type = zipfile.ZIP_DEFLATED
            z.writestr(info, buf.getvalue(), compresslevel=9)
    for name, a in arrays.items():
        print(f"{name}: {a.shape}")
    print(f"wrote {DECODED_TEXTURES}")


if __name__ == "__main__":
    main()
