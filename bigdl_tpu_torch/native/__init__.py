"""Native host runtime: C++ image ops, the prefetch executor and the image
decoder, through ctypes (``bigdl_tpu/native/__init__.py``).

The reference's native row-set (MKL, MKL-DNN and OpenCV JNI, and the
``Engine.default`` thread pool that drives its data path) becomes, on
the host of the card, one C++ library (``native/src/``, built with g++ at
first use into ``bigdl_tpu_torch/_build/`` by :mod:`.build`):

* :func:`augment_batch` — crop, flip and normalize, HWC u8 → CHW f32
  (``(x - mean) * (1 / std)``, JAX's arithmetic);
* :func:`resize_bilinear` — batched bilinear resize of u8 images;
* :func:`decode_cifar` — the CIFAR binary record split;
* :func:`recs_index` — one pass over a RECS shard's varints;
* :class:`NativeLoader` — the threaded bounded prefetch executor;
* :func:`decode_image` (``native/decode.py``) — JPEG (baseline), PNG and
  BMP bytes → ``(H, W, 3)`` uint8 RGB, as PIL's ``convert("RGB")`` gives.

There is no numpy fallback: where JAX's module reports itself
unavailable, :func:`library` raises ``OSError`` with the compiler's
output.
"""

from __future__ import annotations

import ctypes

import numpy as np

_lib = None


def library() -> ctypes.CDLL:
    """The loaded native library (built at first use); raises OSError."""
    global _lib
    if _lib is not None:
        return _lib
    from bigdl_tpu_torch.native.build import build_library

    lib = ctypes.CDLL(build_library())
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    c_f32p = ctypes.POINTER(ctypes.c_float)
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    c_i64p = ctypes.POINTER(i64)
    lib.bigdl_augment_batch.argtypes = [
        c_u8p, i32, i32, i32, i32, c_i32p, c_i32p, c_u8p, i32, i32,
        c_f32p, c_f32p, c_f32p, i32]
    lib.bigdl_resize_bilinear.argtypes = [
        c_u8p, i32, i32, i32, i32, c_u8p, i32, i32, i32]
    lib.bigdl_decode_cifar.argtypes = [
        c_u8p, i32, i32, i32, c_u8p, c_i32p, i32, i32]
    lib.bigdl_loader_create.restype = ctypes.c_void_p
    lib.bigdl_loader_create.argtypes = [
        i32, i32, i32, i32, i32, i32, c_f32p, c_f32p, i32, i32]
    lib.bigdl_loader_push.restype = i32
    lib.bigdl_loader_push.argtypes = [
        ctypes.c_void_p, c_u8p, c_i32p, c_i32p, c_i32p, c_u8p]
    lib.bigdl_loader_pop.restype = i32
    lib.bigdl_loader_pop.argtypes = [ctypes.c_void_p, c_f32p, c_i32p]
    lib.bigdl_loader_stop.argtypes = [ctypes.c_void_p]
    lib.bigdl_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.bigdl_recs_index.restype = i64
    lib.bigdl_recs_index.argtypes = [c_u8p, i64, i64, c_i64p, c_i64p, c_i64p]
    lib.bigdl_jpeg_info.restype = i32
    lib.bigdl_jpeg_info.argtypes = [c_u8p, i64, c_i32p, c_i32p,
                                    ctypes.c_char_p, i32]
    lib.bigdl_jpeg_decode.restype = i32
    lib.bigdl_jpeg_decode.argtypes = [c_u8p, i64, c_u8p, i32, i32,
                                      ctypes.c_char_p, i32]
    lib.bigdl_png_unfilter.restype = i32
    lib.bigdl_png_unfilter.argtypes = [c_u8p, i32, i32, i32, c_u8p]
    _lib = lib
    return lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _crop_params(n, h, w, crop_h, crop_w, off_y, off_x, flip):
    """The per-image crop offsets and flips as the C side reads them,
    checked: n of each, every crop inside its image."""
    off_y = np.ascontiguousarray(off_y, np.int32)
    off_x = np.ascontiguousarray(off_x, np.int32)
    flip = np.ascontiguousarray(flip, np.uint8)
    if not off_y.shape == off_x.shape == flip.shape == (n,):
        raise ValueError(f"need {n} crop offsets and flips, got "
                         f"{off_y.shape}, {off_x.shape}, {flip.shape}")
    if n and (off_y.min() < 0 or off_x.min() < 0
              or off_y.max() + crop_h > h or off_x.max() + crop_w > w):
        raise ValueError(f"a {crop_h}x{crop_w} crop leaves the {h}x{w} "
                         "image")
    return off_y, off_x, flip


def augment_batch(images: np.ndarray, off_y: np.ndarray, off_x: np.ndarray,
                  flip: np.ndarray, crop_h: int, crop_w: int,
                  mean, std, n_threads: int = 4) -> np.ndarray:
    """(n, H, W, C) u8 → (n, C, crop_h, crop_w) f32, crop/flip/normalize."""
    lib = library()
    images = np.ascontiguousarray(images, np.uint8)
    n, h, w, c = images.shape
    off_y, off_x, flip = _crop_params(n, h, w, crop_h, crop_w, off_y, off_x,
                                      flip)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    out = np.empty((n, c, crop_h, crop_w), np.float32)
    lib.bigdl_augment_batch(_u8(images), n, h, w, c, _i32(off_y), _i32(off_x),
                            _u8(flip), crop_h, crop_w, _f32(mean), _f32(std),
                            _f32(out), n_threads)
    return out


def resize_bilinear(images: np.ndarray, dst_h: int, dst_w: int,
                    n_threads: int = 4) -> np.ndarray:
    """(n, H, W, C) u8 → (n, dst_h, dst_w, C) u8, half-pixel bilinear."""
    lib = library()
    images = np.ascontiguousarray(images, np.uint8)
    n, h, w, c = images.shape
    out = np.empty((n, dst_h, dst_w, c), np.uint8)
    lib.bigdl_resize_bilinear(_u8(images), n, h, w, c, _u8(out), dst_h, dst_w,
                              n_threads)
    return out


def decode_cifar(records: np.ndarray, record_len: int = 3073,
                 label_offset: int = 0, label_base: int = 1,
                 n_threads: int = 4):
    """Raw .bin bytes → ((n, 3, 32, 32) u8 planar, (n,) int32 labels);
    ``label_base=1`` gives the reference's 1-based labels."""
    lib = library()
    records = np.ascontiguousarray(records, np.uint8).reshape(-1)
    n = records.size // record_len
    img_len = record_len - label_offset - 1
    images = np.empty((n, img_len), np.uint8)
    labels = np.empty((n,), np.int32)
    lib.bigdl_decode_cifar(_u8(records), n, record_len, label_offset,
                           _u8(images), _i32(labels), label_base, n_threads)
    return images.reshape(n, 3, 32, 32), labels


class NativeLoader:
    """Bounded prefetch executor over the C++ worker pool.

    ``push`` copies a batch of raw HWC u8 images and host-drawn crop and
    flip parameters into the library (blocking while ``queue_depth``
    batches are in flight); ``pop`` returns the oldest finished
    ``(images f32 CHW, labels i32)`` batch. The augmentation runs in C++
    threads off the GIL, overlapping the step on the card."""

    def __init__(self, batch: int, src_h: int, src_w: int, c: int,
                 crop_h: int, crop_w: int, mean, std,
                 queue_depth: int = 4, n_workers: int = 4) -> None:
        self._h = None
        lib = library()
        self._lib = lib
        mean = np.ascontiguousarray(mean, np.float32)
        std = np.ascontiguousarray(std, np.float32)
        if mean.size != c or std.size != c:
            raise ValueError(f"mean and std need {c} values, got "
                             f"{mean.size} and {std.size}")
        self._h = lib.bigdl_loader_create(batch, src_h, src_w, c, crop_h,
                                          crop_w, _f32(mean), _f32(std),
                                          queue_depth, n_workers)
        self.batch, self.c, self.crop_h, self.crop_w = batch, c, crop_h, crop_w
        self._src = (src_h, src_w, c)

    def push(self, images: np.ndarray, labels: np.ndarray,
             off_y: np.ndarray, off_x: np.ndarray, flip: np.ndarray) -> None:
        images = np.ascontiguousarray(images, np.uint8)
        if images.shape != (self.batch, *self._src):
            raise ValueError(f"push expects ({self.batch}, "
                             f"{', '.join(map(str, self._src))}) uint8 "
                             f"images, got {images.shape}")
        labels = np.ascontiguousarray(labels, np.int32)
        if labels.shape != (self.batch,):
            raise ValueError(f"push expects {self.batch} labels, got "
                             f"{labels.shape}")
        off_y, off_x, flip = _crop_params(self.batch, *self._src[:2],
                                          self.crop_h, self.crop_w, off_y,
                                          off_x, flip)
        rc = self._lib.bigdl_loader_push(self._h, _u8(images), _i32(labels),
                                         _i32(off_y), _i32(off_x), _u8(flip))
        if rc != 0:
            raise RuntimeError("NativeLoader stopped")

    def pop(self):
        out = np.empty((self.batch, self.c, self.crop_h, self.crop_w),
                       np.float32)
        labels = np.empty((self.batch,), np.int32)
        rc = self._lib.bigdl_loader_pop(self._h, _f32(out), _i32(labels))
        if rc != 0:
            raise RuntimeError("NativeLoader stopped and drained")
        return out, labels

    def stop(self) -> None:
        """Wakes every thread waiting in push/pop (they raise
        RuntimeError). Must precede :meth:`close` when producer threads
        exist: close frees the loader, so no thread may still be in a
        call."""
        if self._h:
            self._lib.bigdl_loader_stop(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.bigdl_loader_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def recs_index(buf: np.ndarray):
    """Index a RECS shard buffer (uint8, starting at the magic):
    ``(labels, offsets, lengths)``, each int64. Raises ValueError on
    malformed data; grows its capacity and retries when the first guess
    undershoots."""
    lib = library()
    buf = np.ascontiguousarray(buf, np.uint8)
    cap = max(1024, buf.size // 64)
    while True:
        labels = np.empty(cap, np.int64)
        offsets = np.empty(cap, np.int64)
        lengths = np.empty(cap, np.int64)
        n = lib.bigdl_recs_index(_u8(buf), buf.size, cap, _i64(labels),
                                 _i64(offsets), _i64(lengths))
        if n == -1:
            raise ValueError("malformed RECS shard")
        if n == -2:
            cap *= 4
            continue
        return labels[:n].copy(), offsets[:n].copy(), lengths[:n].copy()


from bigdl_tpu_torch.native.decode import (  # noqa: E402,F401
    decode_image, decode_images,
)
