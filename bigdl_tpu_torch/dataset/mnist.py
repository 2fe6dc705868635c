"""MNIST loader (``bigdl_tpu/dataset/mnist.py``), copied whole: the idx
reader and writer, the deterministic synthetic digits, the idx dataset
generator, ``load_samples`` and the mean/std constants.

No file is downloaded: the loader reads idx files from disk when present
and otherwise falls back to the synthetic digit set (class-dependent blob
patterns), so the LeNet config runs end to end anywhere.
``generate_idx_dataset`` writes that digit set as real idx files, byte
for byte the JAX package's, to feed the real reader.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import List, Tuple

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample

TRAIN_MEAN = 0.13066047740239436 * 255
TRAIN_STD = 0.30810780876661765 * 255
TEST_MEAN = 0.13251460696903547 * 255
TEST_STD = 0.31048024294290553 * 255


def _read_idx_images(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"bad magic {magic} in {path}")
        return np.frombuffer(f.read(), np.uint8).reshape(n, rows, cols)


def _read_idx_labels(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"bad magic {magic} in {path}")
        return np.frombuffer(f.read(), np.uint8)


def _synthetic_digits(n: int, seed: int,
                      noise: float = 25.0) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic learnable stand-in: each class is a distinct 28x28
    blob pattern plus noise (``noise`` = std in 0..255 pixel units; high
    values make the accuracy-parity harness land below 100%, a sharper
    parity signal)."""
    rng = np.random.RandomState(seed)
    protos = np.zeros((10, 28, 28), np.float32)
    proto_rng = np.random.RandomState(1234)
    for c in range(10):
        for _ in range(4):
            cy, cx = proto_rng.randint(4, 24, 2)
            yy, xx = np.mgrid[0:28, 0:28]
            protos[c] += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 18.0)
    protos = protos / protos.max(axis=(1, 2), keepdims=True) * 255.0
    labels = rng.randint(0, 10, n)
    imgs = protos[labels] + rng.randn(n, 28, 28).astype(np.float32) * noise
    return np.clip(imgs, 0, 255).astype(np.uint8), labels.astype(np.uint8)


def read_data_sets(data_dir: str, kind: str = "train",
                   synthetic_fallback: bool = True,
                   synthetic_count: int = 2048) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (images uint8 (N,28,28), labels uint8 0-9)."""
    prefix = "train" if kind == "train" else "t10k"
    candidates = [
        (f"{prefix}-images-idx3-ubyte", f"{prefix}-labels-idx1-ubyte"),
        (f"{prefix}-images-idx3-ubyte.gz", f"{prefix}-labels-idx1-ubyte.gz"),
    ]
    for img_name, lab_name in candidates:
        ip = os.path.join(data_dir, img_name)
        lp = os.path.join(data_dir, lab_name)
        if os.path.exists(ip) and os.path.exists(lp):
            return _read_idx_images(ip), _read_idx_labels(lp)
    if not synthetic_fallback:
        raise FileNotFoundError(f"no MNIST idx files under {data_dir}")
    seed = 7 if kind == "train" else 13
    return _synthetic_digits(synthetic_count, seed)


def write_idx_files(data_dir: str, images: np.ndarray, labels: np.ndarray,
                    kind: str = "train") -> None:
    """Write (N,28,28) uint8 images + uint8 labels as real MNIST idx files
    (the exact format ``read_data_sets`` parses). Used by the
    accuracy-parity harness to exercise the real-file reader path and by
    users converting their own digit datasets."""
    os.makedirs(data_dir, exist_ok=True)
    prefix = "train" if kind == "train" else "t10k"
    images = np.asarray(images)
    labels = np.asarray(labels)
    if images.dtype != np.uint8 or labels.dtype != np.uint8:
        raise ValueError(
            f"idx files store uint8; got images {images.dtype}, labels "
            f"{labels.dtype} — scale to [0, 255] and cast explicitly")
    if images.ndim != 3:
        raise ValueError(f"images must be (N, rows, cols); got {images.shape}")
    n, rows, cols = images.shape
    if len(labels) != n:
        raise ValueError(f"{n} images but {len(labels)} labels")
    images = np.ascontiguousarray(images)
    labels = np.ascontiguousarray(labels)
    with open(os.path.join(data_dir, f"{prefix}-images-idx3-ubyte"), "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, rows, cols))
        f.write(images.tobytes())
    with open(os.path.join(data_dir, f"{prefix}-labels-idx1-ubyte"), "wb") as f:
        f.write(struct.pack(">II", 2049, n))
        f.write(labels.tobytes())


def generate_idx_dataset(data_dir: str, n_train: int = 4096,
                         n_test: int = 1024, seed: int = 7,
                         noise: float = 25.0) -> None:
    """Generate a deterministic LEARNABLE digit dataset as real idx files
    on disk (train + t10k pairs) — the in-env stand-in for downloading
    MNIST (zero egress), feeding the real reader path end to end."""
    write_idx_files(data_dir, *_synthetic_digits(n_train, seed, noise),
                    "train")
    write_idx_files(data_dir, *_synthetic_digits(n_test, seed + 6, noise),
                    "test")


def load_samples(data_dir: str, kind: str = "train", **kw) -> List[Sample]:
    """Samples with (1,28,28) float features and 1-based labels, the shape
    the reference LeNet pipeline produces."""
    imgs, labels = read_data_sets(data_dir, kind, **kw)
    return [
        Sample(imgs[i].astype(np.float32)[None, :, :], np.float32(labels[i] + 1))
        for i in range(len(imgs))
    ]
