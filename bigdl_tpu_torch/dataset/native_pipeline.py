"""Image MiniBatch pipeline over uint8 NHWC images
(``bigdl_tpu/dataset/native_pipeline.py``).

``NativeImagePipeline(images, labels, batch_size=, crop=, mean=, std=,
pad=, hflip=, seed=, output=)`` draws the JAX pipeline's epoch shuffles,
crop offsets and flips in the same order from one
``np.random.RandomState(seed)`` (``_host_iter``), so both packages yield
the same batches:

- ``output="u8_nhwc"``: the host only crops and flips uint8 copies; the
  card normalizes and transposes them (:class:`DeviceImageNormalizer`,
  passed to ``Optimizer.set_device_preprocess`` through
  :meth:`NativeImagePipeline.device_normalizer`), so each upload carries
  a quarter of the f32 bytes;
- ``output="f32_nchw"``: the host normalizes and transposes, the JAX
  package's numpy iterator. The JAX package's C++ loader
  (``bigdl_tpu/native``), which its tests hold equal to that iterator,
  comes with the host data plane; until then the port's f32 feed is the
  numpy iterator.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
from bigdl_tpu_torch.dataset.sample import MiniBatch


class NativeImagePipeline(AbstractDataSet):
    """MiniBatches from (N, H, W, C) uint8 images and integer labels.

    ``train=True``: an endless shuffled stream, random crop and flip;
    ``train=False``: one pass, centre crop, no flip. ``pad`` zero-pads
    every image before the crop (the reference CIFAR recipe). Labels come
    out as float32, as in JAX."""

    def __init__(self, images: np.ndarray, labels: Sequence[int], *,
                 batch_size: int, crop: Optional[tuple] = None,
                 mean, std, pad: int = 0, hflip: bool = True,
                 seed: int = 0, output: str = "f32_nchw") -> None:
        if output not in ("f32_nchw", "u8_nhwc"):
            raise ValueError(f"unknown output {output!r}")
        images = np.ascontiguousarray(images, np.uint8)
        if images.ndim != 4:
            raise ValueError(f"expected (N, H, W, C) uint8 images, got "
                             f"shape {images.shape}")
        if pad:
            images = np.pad(images, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
        self.images = images
        self.labels = np.ascontiguousarray(labels, np.int32)
        self.n, self.h, self.w, self.c = images.shape
        self.crop_h, self.crop_w = crop if crop else (self.h, self.w)
        if self.crop_h > self.h or self.crop_w > self.w:
            raise ValueError(
                f"crop {self.crop_h}x{self.crop_w} exceeds (padded) image "
                f"{self.h}x{self.w}")
        self.batch = batch_size
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.hflip = hflip
        self.seed = seed
        self.output = output

    def size(self) -> int:
        return self.n

    def _params(self, rng: np.random.RandomState, train: bool, k: int):
        max_y = self.h - self.crop_h
        max_x = self.w - self.crop_w
        if train:
            oy = rng.randint(0, max_y + 1, k).astype(np.int32)
            ox = rng.randint(0, max_x + 1, k).astype(np.int32)
            fl = ((rng.rand(k) < 0.5).astype(np.uint8) if self.hflip
                  else np.zeros(k, np.uint8))
        else:
            oy = np.full(k, max_y // 2, np.int32)
            ox = np.full(k, max_x // 2, np.int32)
            fl = np.zeros(k, np.uint8)
        return oy, ox, fl

    def data(self, train: bool) -> Iterator[MiniBatch]:
        """One epoch, shuffle, crop and flip loop for both feeds: only the
        finishing of each image differs (uint8 copy, or normalize and
        transpose to CHW)."""
        u8 = self.output == "u8_nhwc"
        rng = np.random.RandomState(self.seed)
        while True:
            idx = np.arange(self.n)
            if train:
                rng.shuffle(idx)
            for i in range(0, self.n - self.batch + 1, self.batch):
                sel = idx[i:i + self.batch]
                oy, ox, fl = self._params(rng, train, len(sel))
                if u8:
                    out = np.empty((len(sel), self.crop_h, self.crop_w,
                                    self.c), np.uint8)
                else:
                    out = np.empty((len(sel), self.c, self.crop_h,
                                    self.crop_w), np.float32)
                for j, s in enumerate(sel):
                    im = self.images[s, oy[j]:oy[j] + self.crop_h,
                                     ox[j]:ox[j] + self.crop_w, :]
                    if fl[j]:
                        im = im[:, ::-1, :]
                    if u8:
                        out[j] = im
                    else:
                        out[j] = ((im.astype(np.float32) - self.mean)
                                  / self.std).transpose(2, 0, 1)
                yield MiniBatch(out, self.labels[sel].astype(np.float32))
            if not train:
                return

    def device_normalizer(self) -> "DeviceImageNormalizer":
        """The on-device preprocess of ``output="u8_nhwc"`` batches."""
        return DeviceImageNormalizer(self.mean, self.std)


class DeviceImageNormalizer:
    """A uint8 NHWC batch tensor → normalized float32 NCHW, on the
    batch's device: ``((x.float() - mean) / std).permute(0, 3, 1, 2)``.
    The result is a view in channels-last memory order, the layout the
    fused graph converts to anyway. Mean and std are kept on each device
    they were asked for."""

    def __init__(self, mean, std) -> None:
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self._on: Dict[torch.device, tuple] = {}

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.device not in self._on:
            self._on[x.device] = (torch.from_numpy(self.mean).to(x.device),
                                  torch.from_numpy(self.std).to(x.device))
        mean, std = self._on[x.device]
        return ((x.float() - mean) / std).permute(0, 3, 1, 2)
