"""CIFAR-10 loader (``bigdl_tpu/dataset/cifar.py``), copied whole: the
python-pickle batch reader and writer, the two synthetic sets and the
train mean/std.

No file is downloaded: ``read_data_sets`` reads ``data_batch_1..5`` /
``test_batch`` (directly or under ``cifar-10-batches-py``) when present
and otherwise falls back to the synthetic set, so the CIFAR mains run
anywhere. ``generate_batch_dataset`` writes a learnable synthetic set as
real pickle batch files, the JAX package's bytes, to feed the reader.
Unpickling runs code: read only batch files from a trusted source.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Tuple

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample

TRAIN_MEAN = (125.3, 123.0, 113.9)
TRAIN_STD = (63.0, 62.1, 66.7)


def _synthetic(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.RandomState(seed)
    protos = (np.random.RandomState(99).rand(10, 3, 32, 32)
              .astype(np.float32) * 255)
    labels = rng.randint(0, 10, n)
    imgs = (0.6 * protos[labels]
            + 0.4 * rng.rand(n, 3, 32, 32).astype(np.float32) * 255)
    return imgs.astype(np.uint8), labels.astype(np.uint8)


def _synthetic_learnable(n: int, seed: int,
                         noise: float) -> Tuple[np.ndarray, np.ndarray]:
    """A deterministic learnable 10-class CIFAR-shaped set: smooth
    per-class prototype fields plus pixel noise (``noise`` sets the
    difficulty)."""
    rng = np.random.RandomState(seed)
    proto_rng = np.random.RandomState(1234)
    base = proto_rng.rand(10, 3, 8, 8).astype(np.float32)
    protos = np.repeat(np.repeat(base, 4, axis=2), 4, axis=3) * 255.0
    labels = (np.arange(n) % 10).astype(np.uint8)
    perm = rng.permutation(n)
    labels = labels[perm]
    imgs = (protos[labels]
            + rng.randn(n, 3, 32, 32).astype(np.float32) * noise)
    return np.clip(imgs, 0, 255).astype(np.uint8), labels


def generate_batch_dataset(data_dir: str, n_train: int = 2048,
                           n_test: int = 1024, seed: int = 0,
                           noise: float = 64.0) -> None:
    """Write the learnable synthetic set as CIFAR pickle batch files
    (``data_batch_1..5`` and ``test_batch``)."""
    os.makedirs(data_dir, exist_ok=True)
    imgs, labels = _synthetic_learnable(n_train, seed, noise)
    per = -(-n_train // 5)
    for i in range(5):
        lo, hi = i * per, min((i + 1) * per, n_train)
        with open(os.path.join(data_dir, f"data_batch_{i + 1}"), "wb") as f:
            pickle.dump({b"data": imgs[lo:hi].reshape(hi - lo, -1),
                         b"labels": labels[lo:hi].tolist()}, f)
    imgs_t, labels_t = _synthetic_learnable(n_test, seed + 1, noise)
    with open(os.path.join(data_dir, "test_batch"), "wb") as f:
        pickle.dump({b"data": imgs_t.reshape(n_test, -1),
                     b"labels": labels_t.tolist()}, f)


def read_data_sets(data_dir: str, kind: str = "train",
                   synthetic_fallback: bool = True,
                   synthetic_count: int = 2048
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(images uint8 (N, 3, 32, 32), labels uint8 0-9)."""
    batch_dir = os.path.join(data_dir, "cifar-10-batches-py")
    root = batch_dir if os.path.isdir(batch_dir) else data_dir
    names = ([f"data_batch_{i}" for i in range(1, 6)] if kind == "train"
             else ["test_batch"])
    imgs, labels = [], []
    for name in names:
        p = os.path.join(root, name)
        if not os.path.exists(p):
            if synthetic_fallback:
                return _synthetic(synthetic_count,
                                  21 if kind == "train" else 22)
            raise FileNotFoundError(p)
        with open(p, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        imgs.append(np.asarray(d[b"data"], np.uint8).reshape(-1, 3, 32, 32))
        labels.append(np.asarray(d[b"labels"], np.uint8))
    return np.concatenate(imgs), np.concatenate(labels)


def load_samples(data_dir: str, kind: str = "train", **kw) -> List[Sample]:
    """Float32 (3, 32, 32) features in 0-255 with 1-based labels."""
    imgs, labels = read_data_sets(data_dir, kind, **kw)
    return [Sample(imgs[i].astype(np.float32), np.float32(labels[i] + 1))
            for i in range(len(imgs))]
