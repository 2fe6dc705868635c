"""Image transformers (``bigdl_tpu/dataset/image.py``): the reference's
``BGRImgNormalizer``, ``GreyImgNormalizer``, ``BGRImgCropper``, ``HFlip``,
``ColorJitter``, ``Lighting`` and the Inception/ResNet
``RandomResizedCrop``, on ``Sample(feature=(C, H, W) float32, label)`` in
host numpy. Each random transformer draws from its own
``np.random.RandomState(seed)`` in the JAX package's order, so both give
the same samples bitwise.

``image_folder_samples`` loads a class-per-subdirectory folder through
the port's own decoder (``bigdl_tpu_torch.native.decode_image``, the
counterpart of JAX's PIL ``convert("RGB")``): each image ``/ 255`` in CHW
f32, bilinear-resized to ``image_size``, with 1-based labels in sorted
class order."""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.dataset.transformer import Transformer


class GreyImgNormalizer(Transformer):
    """(x - mean) / std on single-channel images (reference MNIST pipeline)."""

    def __init__(self, mean: float, std: float) -> None:
        self.mean = mean
        self.std = std

    def apply(self, it: Iterator[Sample]) -> Iterator[Sample]:
        for s in it:
            yield Sample((s.feature() - self.mean) / self.std, s.labels[0])


class BGRImgNormalizer(Transformer):
    """Per-channel (x - mean) / std on channels-first images (reference
    CIFAR/ImageNet pipelines)."""

    def __init__(self, means, stds) -> None:
        self.means = np.asarray(means, np.float32).reshape(-1, 1, 1)
        self.stds = np.asarray(stds, np.float32).reshape(-1, 1, 1)

    def apply(self, it: Iterator[Sample]) -> Iterator[Sample]:
        for s in it:
            yield Sample((s.feature() - self.means) / self.stds, s.labels[0])


class BGRImgCropper(Transformer):
    """Random (train) or centre crop to (crop_h, crop_w) (reference
    ``BGRImgCropper``/``CropCenter``/``CropRandom``)."""

    def __init__(self, crop_width: int, crop_height: int,
                 crop_method: str = "random", seed: int = 0) -> None:
        self.cw = crop_width
        self.ch = crop_height
        self.method = crop_method
        self._rng = np.random.RandomState(seed)

    def apply(self, it: Iterator[Sample]) -> Iterator[Sample]:
        for s in it:
            img = s.feature()  # (C, H, W)
            _, h, w = img.shape
            if self.method == "random":
                y0 = self._rng.randint(0, h - self.ch + 1)
                x0 = self._rng.randint(0, w - self.cw + 1)
            else:
                y0 = (h - self.ch) // 2
                x0 = (w - self.cw) // 2
            yield Sample(img[:, y0:y0 + self.ch, x0:x0 + self.cw],
                         s.labels[0])


class HFlip(Transformer):
    def __init__(self, threshold: float = 0.5, seed: int = 0) -> None:
        self.threshold = threshold
        self._rng = np.random.RandomState(seed)

    def apply(self, it: Iterator[Sample]) -> Iterator[Sample]:
        for s in it:
            img = s.feature()
            if self._rng.rand() < self.threshold:
                img = img[:, :, ::-1].copy()
            yield Sample(img, s.labels[0])


class ColorJitter(Transformer):
    """Random brightness, contrast and saturation in random order
    (reference ``ColorJitter``, the ResNet ImageNet recipe)."""

    def __init__(self, brightness: float = 0.4, contrast: float = 0.4,
                 saturation: float = 0.4, seed: int = 0) -> None:
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self._rng = np.random.RandomState(seed)

    def _blend(self, a, b, alpha):
        return alpha * a + (1.0 - alpha) * b

    def apply(self, it: Iterator[Sample]) -> Iterator[Sample]:
        for s in it:
            img = s.feature().astype(np.float32)
            ops = [self._bright, self._contrast, self._saturate]
            self._rng.shuffle(ops)
            for op in ops:
                img = op(img)
            yield Sample(img, s.labels[0])

    def _bright(self, img):
        alpha = 1.0 + self.brightness * (2 * self._rng.rand() - 1)
        return self._blend(img, np.zeros_like(img), alpha)

    def _contrast(self, img):
        alpha = 1.0 + self.contrast * (2 * self._rng.rand() - 1)
        grey = img.mean()
        return self._blend(img, np.full_like(img, grey), alpha)

    def _saturate(self, img):
        alpha = 1.0 + self.saturation * (2 * self._rng.rand() - 1)
        grey = img.mean(axis=0, keepdims=True)
        return self._blend(img, np.broadcast_to(grey, img.shape), alpha)


class Lighting(Transformer):
    """AlexNet-style PCA lighting noise (reference ``Lighting``, with the
    ImageNet eigendecomposition)."""

    _eigval = np.array([0.2175, 0.0188, 0.0045], np.float32)
    _eigvec = np.array(
        [[-0.5675, 0.7192, 0.4009],
         [-0.5808, -0.0045, -0.8140],
         [-0.5836, -0.6948, 0.4203]], np.float32)

    def __init__(self, alphastd: float = 0.1, seed: int = 0) -> None:
        self.alphastd = alphastd
        self._rng = np.random.RandomState(seed)

    def apply(self, it: Iterator[Sample]) -> Iterator[Sample]:
        for s in it:
            img = s.feature().astype(np.float32)
            alpha = self._rng.randn(3).astype(np.float32) * self.alphastd
            shift = (self._eigvec @ (alpha * self._eigval)).reshape(3, 1, 1)
            yield Sample(img + shift, s.labels[0])


class RandomResizedCrop(Transformer):
    """Scale-and-aspect random crop, then a bilinear resize to
    ``size`` x ``size`` (the Inception/ResNet train augmentation)."""

    def __init__(self, size: int, min_area: float = 0.08,
                 seed: int = 0) -> None:
        self.size = size
        self.min_area = min_area
        self._rng = np.random.RandomState(seed)

    def apply(self, it: Iterator[Sample]) -> Iterator[Sample]:
        for s in it:
            img = s.feature()
            _, h, w = img.shape
            for _ in range(10):
                area = h * w * self._rng.uniform(self.min_area, 1.0)
                ratio = self._rng.uniform(3 / 4, 4 / 3)
                ch = int(round(np.sqrt(area / ratio)))
                cw = int(round(np.sqrt(area * ratio)))
                if ch <= h and cw <= w:
                    y0 = self._rng.randint(0, h - ch + 1)
                    x0 = self._rng.randint(0, w - cw + 1)
                    crop = img[:, y0:y0 + ch, x0:x0 + cw]
                    break
            else:
                side = min(h, w)
                crop = img[:, :side, :side]
            yield Sample(resize_bilinear(crop, self.size, self.size),
                         s.labels[0])


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize (half-pixel centres) of a (C, H, W) numpy image to
    f32, JAX's arithmetic (float64 weights, the result cast once)."""
    c, h, w = img.shape
    if h == out_h and w == out_w:
        return img.astype(np.float32)
    ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1)[None, :, None]
    wx = np.clip(xs - x0, 0, 1)[None, None, :]
    p00 = img[:, y0][:, :, x0]
    p01 = img[:, y0][:, :, x1]
    p10 = img[:, y1][:, :, x0]
    p11 = img[:, y1][:, :, x1]
    top = p00 * (1 - wx) + p01 * wx
    bot = p10 * (1 - wx) + p11 * wx
    return (top * (1 - wy) + bot * wy).astype(np.float32)


def image_folder_samples(path: str, image_size: int = 224):
    """An ImageFolder-style directory (one subdirectory per class, in
    sorted order) as Samples: every file of a class directory decoded to
    RGB, ``/ 255`` as (3, H, W) f32, resized to ``image_size`` square,
    with the 1-based class index as its label."""
    from bigdl_tpu_torch.native import decode_image

    classes = sorted(
        d for d in os.listdir(path) if os.path.isdir(os.path.join(path, d)))
    samples = []
    for ci, cls in enumerate(classes):
        cdir = os.path.join(path, cls)
        for fname in sorted(os.listdir(cdir)):
            fpath = os.path.join(cdir, fname)
            with open(fpath, "rb") as f:
                rgb = decode_image(f.read(), fpath)
            arr = rgb.astype(np.float32).transpose(2, 0, 1) / 255.0
            arr = resize_bilinear(arr, image_size, image_size)
            samples.append(Sample(arr, np.float32(ci + 1)))
    return samples
