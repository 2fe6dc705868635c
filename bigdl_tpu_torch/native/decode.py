"""PIL-free image decoding: bytes → ``(H, W, 3)`` uint8 RGB, the array
``np.asarray(PIL.Image.open(f).convert("RGB"))`` gives, for the formats
the data plane reads (the counterpart of the PIL calls in
``bigdl_tpu/dataset/image.py:200-213`` and
``bigdl_tpu/transform/vision/image.py:345-363``):

* **JPEG**, baseline and extended sequential (SOF0/SOF1), Huffman, 8-bit,
  one or three components, sampling 4:4:4, 4:2:2, 4:2:0 or 4:4:0,
  restart markers, any size: decoded in C++ as libjpeg-turbo decodes by
  default (``native/src/image_decode.cpp``); greyscale comes out as three
  equal channels;
* **PNG**, 8-bit greyscale, RGB, palette, grey+alpha and RGBA (and 1, 2
  or 4-bit greyscale or palette), the five row filters, not interlaced:
  the chunks are read here, the IDAT stream inflated with ``zlib`` and
  unfiltered in C++; alpha is dropped and a palette looked up, as
  ``convert("RGB")`` does;
* **BMP**, uncompressed 24-bit (bottom-up or top-down).

Anything else raises ``ValueError`` naming the file and the feature:
progressive or arithmetic-coded JPEG, 12-bit samples, CMYK/YCCK,
interlaced or 16-bit PNG, compressed or paletted BMP, GIF.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence

import numpy as np

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def decode_image(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Decode one image file's bytes to a contiguous ``(H, W, 3)`` uint8
    RGB array; ``name`` (a path) goes into the error messages."""
    data = bytes(data)
    if data[:2] == b"\xff\xd8":
        return _jpeg(data, name)
    if data[:8] == _PNG_MAGIC:
        return _png(data, name)
    if data[:2] == b"BM":
        return _bmp(data, name)
    if data[:4] == b"GIF8":
        raise ValueError(f"{name}: GIF is not read (JPEG, PNG and BMP are)")
    raise ValueError(f"{name}: unknown image format (JPEG, PNG and BMP are "
                     "read)")


def decode_images(blobs: Sequence[bytes], n_threads: int = 1,
                  names: Sequence[str] = ()) -> List[np.ndarray]:
    """Decode many files on ``n_threads`` threads (the C++ decode runs
    with the GIL released)."""
    names = list(names) or [f"<image {i}>" for i in range(len(blobs))]
    if n_threads <= 1:
        return [decode_image(b, n) for b, n in zip(blobs, names)]
    with ThreadPoolExecutor(n_threads) as pool:
        return list(pool.map(decode_image, blobs, names))


def _jpeg(data: bytes, name: str) -> np.ndarray:
    from bigdl_tpu_torch.native import _i32, _u8, library

    lib = library()
    buf = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(256)
    h, w = np.zeros(1, np.int32), np.zeros(1, np.int32)
    if lib.bigdl_jpeg_info(_u8(buf), buf.size, _i32(h), _i32(w), err,
                           256) != 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    out = np.empty((int(h[0]), int(w[0]), 3), np.uint8)
    if lib.bigdl_jpeg_decode(_u8(buf), buf.size, _u8(out), int(h[0]),
                             int(w[0]), err, 256) != 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


def _png(data: bytes, name: str) -> np.ndarray:
    from bigdl_tpu_torch.native import _u8, library

    pos, ihdr, palette, idat = 8, None, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise ValueError(f"{name}: truncated PNG chunk {kind!r}")
        (crc,) = struct.unpack_from(">I", data, pos + 8 + length)
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{name}: PNG chunk {kind!r} fails its CRC")
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{name}: PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"{name}: PNG color type {ctype}")
    if depth == 16:
        raise ValueError(f"{name}: 16-bit PNG (8-bit samples are read)")
    if depth != 8 and not (ctype in (0, 3) and depth in (1, 2, 4)):
        raise ValueError(f"{name}: {depth}-bit PNG of color type {ctype} "
                         "(8-bit samples, and 1, 2 or 4-bit grey or "
                         "palette, are read)")
    if interlace:
        raise ValueError(f"{name}: interlaced (Adam7) PNG")
    ch = _PNG_CHANNELS[ctype]
    row = (w * ch * depth + 7) // 8
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{name}: PNG image data does not inflate: {e}") \
            from None
    if raw.size < h * (row + 1):
        raise ValueError(f"{name}: truncated PNG image data")
    out = np.empty((h, row), np.uint8)
    bpp = max(1, ch * depth // 8)       # the filters' left distance
    bad = library().bigdl_png_unfilter(_u8(raw), h, row, bpp, _u8(out))
    if bad:
        raise ValueError(f"{name}: PNG row {bad - 1} has an unknown filter "
                         f"type {raw[(bad - 1) * (row + 1)]}")
    if depth < 8:                 # packed samples, most significant first
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        out = ((out[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(
            h, -1)[:, :w]
        if ctype == 0:            # grey scaled to 8 bits, as PIL reads it
            out = out * np.uint8(255 // ((1 << depth) - 1))
    px = out.reshape(h, w, ch)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{name}: palette PNG without a PLTE chunk")
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette)] = palette[:256]
        return full[px[:, :, 0]]
    if ch <= 2:                                  # grey, grey + alpha
        return np.ascontiguousarray(np.repeat(px[:, :, :1], 3, axis=2))
    return np.ascontiguousarray(px[:, :, :3])


def _bmp(data: bytes, name: str) -> np.ndarray:
    if len(data) < 26:
        raise ValueError(f"{name}: truncated BMP header")
    (offset,) = struct.unpack_from("<I", data, 10)
    (hsize,) = struct.unpack_from("<I", data, 14)
    if hsize == 12:                              # BITMAPCOREHEADER
        w, h, _, bpp = struct.unpack_from("<HHHH", data, 18)
        comp = 0
    elif hsize >= 40:
        w, h, _, bpp, comp = struct.unpack_from("<iiHHI", data, 18)
    else:
        raise ValueError(f"{name}: BMP header of {hsize} bytes")
    if bpp != 24 or comp != 0:
        raise ValueError(f"{name}: {bpp}-bit BMP with compression {comp} "
                         "(uncompressed 24-bit is read)")
    top_down = h < 0
    h = abs(h)
    stride = (w * 3 + 3) // 4 * 4
    if offset + stride * h > len(data):
        raise ValueError(f"{name}: truncated BMP pixel data")
    rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h,
                                                                     stride)
    px = rows[:, :w * 3].reshape(h, w, 3)[:, :, ::-1]
    if not top_down:
        px = px[::-1]
    return np.ascontiguousarray(px)
