"""The vision pipeline (``bigdl_tpu/transform/vision/image.py``; the
reference's ``transform/vision/image``): ``ImageFeature`` (a mutable map
holding the decoded mat, label, uri and derived tensors),
``FeatureTransformer`` steps chained with ``>>`` (the reference's
``->``) into a ``Pipeline``, the geometric (``Resize``, ``AspectScale``,
``CenterCrop``, ``RandomCrop``, ``HFlip``, ``Expand``) and photometric
(``Brightness``, ``Contrast``, ``Saturation``, ``Hue``, ``ChannelOrder``,
``ChannelNormalize``, ``PixelNormalizer``) ops, ``RandomTransformer``,
the terminal ``MatToTensor`` and ``ImageFrameToSample``, and
``LocalImageFrame`` with ``ImageFrame.read`` / ``ImageFrame.array``.

Mats are HWC float32 numpy arrays on the host; ``ImageFrame.read``
decodes through the port's own decoder
(``bigdl_tpu_torch.native.decode_image``, the counterpart of PIL's
``convert("RGB")``), and every random step draws from a per-feature
``np.random.RandomState(seed * 1_000_003 + index)``, the JAX package's
draws, so a pipeline gives the same features in both packages.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


class ImageFeature(dict):
    """Mutable feature map (reference ``ImageFeature``): well-known keys
    ``mat`` (HWC float32), ``label``, ``uri``, ``sample``."""

    MAT = "mat"
    LABEL = "label"
    URI = "uri"
    SAMPLE = "sample"

    def __init__(self, mat=None, label=None, uri: Optional[str] = None) -> None:
        super().__init__()
        if mat is not None:
            self[self.MAT] = np.asarray(mat, np.float32)
        if label is not None:
            self[self.LABEL] = label
        if uri is not None:
            self[self.URI] = uri

    def mat(self) -> np.ndarray:
        return self[self.MAT]

    def set_mat(self, m: np.ndarray) -> None:
        self[self.MAT] = np.asarray(m, np.float32)


class FeatureTransformer:
    """One step of the pipeline; compose with ``>>`` (the reference's
    ``->``). Subclasses override :meth:`transform_mat` (the common case) or
    :meth:`apply_feature` for whole-feature edits."""

    def apply_feature(self, feature: ImageFeature,
                      rng: np.random.RandomState) -> ImageFeature:
        feature.set_mat(self.transform_mat(feature.mat(), rng))
        return feature

    def transform_mat(self, mat: np.ndarray,
                      rng: np.random.RandomState) -> np.ndarray:
        return mat

    def __rshift__(self, other: "FeatureTransformer") -> "Pipeline":
        return Pipeline([self, other])

    def __call__(self, feature: ImageFeature,
                 rng: Optional[np.random.RandomState] = None) -> ImageFeature:
        return self.apply_feature(feature, rng or np.random.RandomState(0))


class Pipeline(FeatureTransformer):
    def __init__(self, stages: Sequence[FeatureTransformer]) -> None:
        self.stages = list(stages)

    def apply_feature(self, feature, rng):
        for s in self.stages:
            feature = s.apply_feature(feature, rng)
        return feature

    def __rshift__(self, other):
        return Pipeline(self.stages + [other])


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def _resize_hwc(mat: np.ndarray, h: int, w: int) -> np.ndarray:
    from bigdl_tpu_torch.dataset.image import resize_bilinear

    return resize_bilinear(
        np.ascontiguousarray(mat.transpose(2, 0, 1)), h, w).transpose(1, 2, 0)


class Resize(FeatureTransformer):
    def __init__(self, resize_h: int, resize_w: int) -> None:
        self.h, self.w = resize_h, resize_w

    def transform_mat(self, mat, rng):
        return _resize_hwc(mat, self.h, self.w)


class AspectScale(FeatureTransformer):
    """Scale the SHORT side to ``min_size`` keeping aspect (reference
    ``AspectScale``)."""

    def __init__(self, min_size: int, max_size: int = 1000) -> None:
        self.min_size, self.max_size = min_size, max_size

    def transform_mat(self, mat, rng):
        h, w = mat.shape[:2]
        scale = self.min_size / min(h, w)
        if max(h, w) * scale > self.max_size:
            scale = self.max_size / max(h, w)
        return _resize_hwc(mat, max(1, round(h * scale)),
                           max(1, round(w * scale)))


class CenterCrop(FeatureTransformer):
    def __init__(self, crop_width: int, crop_height: int) -> None:
        self.w, self.h = crop_width, crop_height

    def transform_mat(self, mat, rng):
        H, W = mat.shape[:2]
        oy, ox = (H - self.h) // 2, (W - self.w) // 2
        return mat[oy:oy + self.h, ox:ox + self.w]


class RandomCrop(FeatureTransformer):
    def __init__(self, crop_width: int, crop_height: int) -> None:
        self.w, self.h = crop_width, crop_height

    def transform_mat(self, mat, rng):
        H, W = mat.shape[:2]
        oy = rng.randint(0, H - self.h + 1)
        ox = rng.randint(0, W - self.w + 1)
        return mat[oy:oy + self.h, ox:ox + self.w]


class HFlip(FeatureTransformer):
    """Horizontal flip with probability ``p`` (reference ``HFlip`` is
    unconditional; ``RandomTransformer(HFlip(), 0.5)`` is the random form —
    both shapes supported via ``p``)."""

    def __init__(self, p: float = 1.0) -> None:
        self.p = p

    def transform_mat(self, mat, rng):
        if self.p >= 1.0 or rng.rand() < self.p:
            return mat[:, ::-1].copy()
        return mat


class Expand(FeatureTransformer):
    """Zero-pad to a random larger canvas (reference ``Expand``, SSD aug)."""

    def __init__(self, max_expand_ratio: float = 2.0,
                 means: Sequence[float] = (123.0, 117.0, 104.0)) -> None:
        self.max_ratio = max_expand_ratio
        self.means = np.asarray(means, np.float32)

    def transform_mat(self, mat, rng):
        ratio = rng.uniform(1.0, self.max_ratio)
        H, W, C = mat.shape
        nh, nw = int(H * ratio), int(W * ratio)
        oy = rng.randint(0, nh - H + 1)
        ox = rng.randint(0, nw - W + 1)
        canvas = np.empty((nh, nw, C), np.float32)
        canvas[:] = self.means[:C]
        canvas[oy:oy + H, ox:ox + W] = mat
        return canvas


# ---------------------------------------------------------------------------
# photometric
# ---------------------------------------------------------------------------

class Brightness(FeatureTransformer):
    def __init__(self, delta_low: float = -32.0, delta_high: float = 32.0) -> None:
        self.lo, self.hi = delta_low, delta_high

    def transform_mat(self, mat, rng):
        return mat + rng.uniform(self.lo, self.hi)


class Contrast(FeatureTransformer):
    def __init__(self, delta_low: float = 0.5, delta_high: float = 1.5) -> None:
        self.lo, self.hi = delta_low, delta_high

    def transform_mat(self, mat, rng):
        return mat * rng.uniform(self.lo, self.hi)


class Saturation(FeatureTransformer):
    """Blend with the per-pixel grey value (channel mean)."""

    def __init__(self, delta_low: float = 0.5, delta_high: float = 1.5) -> None:
        self.lo, self.hi = delta_low, delta_high

    def transform_mat(self, mat, rng):
        f = rng.uniform(self.lo, self.hi)
        grey = mat.mean(axis=2, keepdims=True)
        return grey + (mat - grey) * f


class Hue(FeatureTransformer):
    """Rotate channels toward their mean by a random angle-ish factor (a
    cheap OpenCV-free hue shift: blend of channel roll)."""

    def __init__(self, delta: float = 18.0) -> None:
        self.delta = delta

    def transform_mat(self, mat, rng):
        f = rng.uniform(-self.delta, self.delta) / 180.0
        rolled = np.roll(mat, 1, axis=2)
        return mat * (1.0 - abs(f)) + rolled * abs(f)


class ChannelOrder(FeatureTransformer):
    """BGR↔RGB flip (reference ``ChannelOrder`` randomly shuffles; here the
    deterministic reverse, the common use)."""

    def transform_mat(self, mat, rng):
        return mat[:, :, ::-1].copy()


class ChannelNormalize(FeatureTransformer):
    def __init__(self, mean_r: float, mean_g: float, mean_b: float,
                 std_r: float = 1.0, std_g: float = 1.0,
                 std_b: float = 1.0) -> None:
        self.mean = np.asarray([mean_r, mean_g, mean_b], np.float32)
        self.std = np.asarray([std_r, std_g, std_b], np.float32)

    def transform_mat(self, mat, rng):
        return (mat - self.mean) / self.std


class PixelNormalizer(FeatureTransformer):
    """Subtract a full per-pixel mean image (reference ``PixelNormalizer``)."""

    def __init__(self, means: np.ndarray) -> None:
        self.means = np.asarray(means, np.float32)

    def transform_mat(self, mat, rng):
        return mat - self.means


class RandomTransformer(FeatureTransformer):
    """Apply ``inner`` with probability ``p`` (reference
    ``RandomTransformer``)."""

    def __init__(self, inner: FeatureTransformer, p: float) -> None:
        self.inner = inner
        self.p = p

    def apply_feature(self, feature, rng):
        if rng.rand() < self.p:
            return self.inner.apply_feature(feature, rng)
        return feature


# ---------------------------------------------------------------------------
# terminal stages
# ---------------------------------------------------------------------------

class MatToTensor(FeatureTransformer):
    """HWC float mat → CHW float32 tensor under ``to_key`` (reference
    ``MatToTensor`` / ``MatToFloats``)."""

    def __init__(self, to_key: str = "floats") -> None:
        self.to_key = to_key

    def apply_feature(self, feature, rng):
        feature[self.to_key] = np.ascontiguousarray(
            feature.mat().transpose(2, 0, 1), np.float32)
        return feature


class ImageFrameToSample(FeatureTransformer):
    """Build the training ``Sample`` from feature keys (reference
    ``ImageFrameToSample(inputKeys, targetKeys)``)."""

    def __init__(self, input_keys: Sequence[str] = ("floats",),
                 target_keys: Optional[Sequence[str]] = ("label",)) -> None:
        self.input_keys = list(input_keys)
        self.target_keys = list(target_keys or [])

    def apply_feature(self, feature, rng):
        from bigdl_tpu_torch.dataset.sample import Sample

        feats = [np.asarray(feature[k], np.float32) for k in self.input_keys]
        labels = [np.asarray(feature[k], np.float32)
                  for k in self.target_keys if k in feature]
        feature[ImageFeature.SAMPLE] = Sample(
            feats if len(feats) > 1 else feats[0],
            (labels if len(labels) > 1 else labels[0]) if labels else None)
        return feature


# ---------------------------------------------------------------------------
# ImageFrame
# ---------------------------------------------------------------------------

class LocalImageFrame:
    """In-memory collection of ImageFeatures (reference ``LocalImageFrame``);
    ``transform`` applies a FeatureTransformer chain to every feature with a
    per-feature seeded generator."""

    def __init__(self, features: List[ImageFeature], seed: int = 0) -> None:
        self.features = list(features)
        self.seed = seed

    def transform(self, transformer: FeatureTransformer) -> "LocalImageFrame":
        out = []
        for i, f in enumerate(self.features):
            rng = np.random.RandomState(self.seed * 1_000_003 + i)
            nf = ImageFeature()
            nf.update(f)
            out.append(transformer.apply_feature(nf, rng))
        return LocalImageFrame(out, self.seed)

    __rshift__ = transform

    def get_sample(self):
        return [f[ImageFeature.SAMPLE] for f in self.features]

    def get_image(self):
        return [f.mat() for f in self.features]

    def get_label(self):
        return [f.get(ImageFeature.LABEL) for f in self.features]

    def __len__(self) -> int:
        return len(self.features)


class ImageFrame:
    """Factory facade (reference ``object ImageFrame``)."""

    @staticmethod
    def read(path: str, seed: int = 0) -> LocalImageFrame:
        """Read a file or directory of images (float32 HWC RGB)."""
        from bigdl_tpu_torch.native import decode_image

        paths = []
        if os.path.isdir(path):
            for root, _, files in os.walk(path):
                for f in sorted(files):
                    if f.lower().endswith(
                            (".jpg", ".jpeg", ".png", ".bmp", ".gif")):
                        paths.append(os.path.join(root, f))
        else:
            paths = [path]
        feats = []
        for p in paths:
            with open(p, "rb") as f:
                arr = decode_image(f.read(), p).astype(np.float32)
            feats.append(ImageFeature(arr, uri=p))
        return LocalImageFrame(feats, seed)

    @staticmethod
    def array(mats: Sequence[np.ndarray], labels: Optional[Sequence] = None,
              seed: int = 0) -> LocalImageFrame:
        feats = []
        for i, m in enumerate(mats):
            feats.append(ImageFeature(
                m, None if labels is None else labels[i]))
        return LocalImageFrame(feats, seed)
