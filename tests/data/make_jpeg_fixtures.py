"""Writes the JPEG fixtures of ``tests/data/jpeg/`` and their decoded
hashes (``hashes.json``): smooth seeded numpy images with a little noise,
saved by PIL at ImageNet-like and odd sizes in the samplings, qualities
and restart intervals the port's decoder reads. ``hashes.json`` holds,
per file, the shape and the SHA-256 of ``np.asarray(Image.open(f).
convert("RGB"))``'s bytes, which the port's decoder must reproduce
(``tests/test_torch_image_decode.py``; ``chip_smoke.py``'s ``data_plane``
phase on the card). Run from the repository root:

    python tests/data/make_jpeg_fixtures.py
"""

import hashlib
import io
import json
import os

import numpy as np
from PIL import Image

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jpeg")

# name, (width, height), PIL save options, grey
FIXTURES = [
    ("landscape_420_q75", (500, 375), dict(quality=75, subsampling=2), False),
    ("portrait_420_q90", (375, 500), dict(quality=90, subsampling=2), False),
    ("odd_422_q85", (333, 251), dict(quality=85, subsampling=1), False),
    ("odd_444_q95", (257, 199), dict(quality=95, subsampling=0), False),
    ("restart_420_q75", (500, 333),
     dict(quality=75, subsampling=2, restart_marker_blocks=7), False),
    ("grey_q80", (299, 299), dict(quality=80), True),
    ("odd_420_q60", (211, 317), dict(quality=60, subsampling=2), False),
    ("vga_420_q75", (640, 480), dict(quality=75, subsampling=2), False),
]


def smooth_image(w, h, seed, grey=False):
    rng = np.random.RandomState(seed)
    c = 1 if grey else 3
    coarse = (rng.rand(h // 32 + 2, w // 32 + 2, c) * 255).astype(np.uint8)
    img = Image.fromarray(coarse[:, :, 0] if grey else coarse)
    base = np.asarray(img.resize((w, h), Image.BICUBIC), np.int32)
    noise = rng.randint(-6, 7, base.shape)
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def decoded_hash(data: bytes):
    arr = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    return list(arr.shape), hashlib.sha256(arr.tobytes()).hexdigest()


def main():
    os.makedirs(OUT, exist_ok=True)
    hashes = {}
    for seed, (name, (w, h), opts, grey) in enumerate(FIXTURES):
        buf = io.BytesIO()
        Image.fromarray(smooth_image(w, h, seed, grey)).save(buf, "JPEG",
                                                             **opts)
        data = buf.getvalue()
        with open(os.path.join(OUT, name + ".jpg"), "wb") as f:
            f.write(data)
        shape, digest = decoded_hash(data)
        hashes[name + ".jpg"] = {"shape": shape, "sha256": digest}
    with open(os.path.join(OUT, "hashes.json"), "w") as f:
        json.dump(hashes, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
