"""20-Newsgroups and GloVe loaders, the text classifier's data
(``bigdl_tpu/dataset/news20.py``; reference ``pyspark/bigdl/dataset/
news20.py``).

Nothing is downloaded. :func:`get_news20` reads an expanded
``20news-18828/`` tree (one subdirectory per group of message files) or
a ``20news*.tar.gz`` archive (expanded once into ``dest_dir``) and
returns ``(text, 1-based label)`` pairs; without either it returns a
deterministic synthetic corpus whose classes have their own keywords.
:func:`get_glove_w2v` reads ``glove.6B.<dim>d.txt`` or yields synthetic
vectors covering that corpus; :func:`glove_dict` is its dict. The
defaults live under the temporary directory (``tempfile.gettempdir()``).
"""

from __future__ import annotations

import os
import tarfile
import tempfile
from typing import Dict, Iterator, List, Tuple

import numpy as np

CLASS_NUM = 20
DEFAULT_DIR = os.path.join(tempfile.gettempdir(), "news20")
GLOVE_DIR = os.path.join(DEFAULT_DIR, "glove.6B")


def _synthetic_news(n_per_class: int, seed: int) -> List[Tuple[str, int]]:
    """Learnable stand-in: each class has a distinct keyword vocabulary, so
    a bag-of-embeddings classifier can separate them."""
    rng = np.random.RandomState(seed)
    texts = []
    for c in range(CLASS_NUM):
        class_words = [f"topic{c}word{k}" for k in range(8)]
        shared = [f"common{k}" for k in range(16)]
        for _ in range(n_per_class):
            n_w = int(rng.randint(20, 60))
            words = [
                class_words[rng.randint(len(class_words))]
                if rng.rand() < 0.5 else shared[rng.randint(len(shared))]
                for _ in range(n_w)
            ]
            texts.append((" ".join(words), c + 1))  # 1-based labels
    return texts


def get_news20(dest_dir: str = DEFAULT_DIR,
               n_per_class: int = 25,
               seed: int = 42) -> List[Tuple[str, int]]:
    """Return ``[(text, 1-based label)]``. Reads an expanded
    ``20news-18828/`` tree (class-per-subdir of message files) or the
    ``.tar.gz`` archive from ``dest_dir`` when present; synthetic otherwise."""
    tree = os.path.join(dest_dir, "20news-18828")
    archive = None
    if os.path.isdir(dest_dir):
        for f in os.listdir(dest_dir):
            if f.startswith("20news") and f.endswith((".tar.gz", ".tgz")):
                archive = os.path.join(dest_dir, f)
                break
    if not os.path.isdir(tree) and archive is not None:
        with tarfile.open(archive, "r:gz") as tf:
            tf.extractall(dest_dir, filter="data")
    if os.path.isdir(tree):
        texts: List[Tuple[str, int]] = []
        for label, group in enumerate(sorted(os.listdir(tree)), start=1):
            gdir = os.path.join(tree, group)
            if not os.path.isdir(gdir):
                continue
            for fname in sorted(os.listdir(gdir)):
                path = os.path.join(gdir, fname)
                with open(path, "rb") as f:
                    texts.append((f.read().decode("latin1"), label))
        if texts:
            return texts
    return _synthetic_news(n_per_class, seed)


def _synthetic_glove(dim: int, seed: int) -> Iterator[Tuple[str, np.ndarray]]:
    """Seeded vectors for every word of the synthetic corpus."""
    rng = np.random.RandomState(seed)
    for c in range(CLASS_NUM):
        for k in range(8):
            w = f"topic{c}word{k}"
            yield w, rng.standard_normal(dim).astype(np.float32)
    for k in range(16):
        yield f"common{k}", rng.standard_normal(dim).astype(np.float32)


def get_glove_w2v(source_dir: str = GLOVE_DIR, dim: int = 100,
                  seed: int = 42) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield ``(word, vector)`` pairs from ``glove.6B.<dim>d.txt`` when the
    file exists; synthetic vocabulary otherwise."""
    path = os.path.join(source_dir, f"glove.6B.{dim}d.txt")
    if os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip().split(" ")
                yield parts[0], np.asarray(parts[1:], np.float32)
        return
    yield from _synthetic_glove(dim, seed)


def glove_dict(source_dir: str = GLOVE_DIR, dim: int = 100,
               seed: int = 42) -> Dict[str, np.ndarray]:
    return dict(get_glove_w2v(source_dir, dim, seed))
