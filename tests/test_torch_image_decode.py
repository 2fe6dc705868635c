"""The port's PIL-free image decoder (``bigdl_tpu_torch/native/decode.py``
over ``native/src/image_decode.cpp``) against PIL, the decoder of the JAX
package's loaders, on the CPU.

Tolerances, with their reasons:

* JPEG: bitwise where PIL's libjpeg-turbo and the port run the same
  integer IDCT, fancy upsampling and fixed-point color tables (every case
  here so far); the bound is max |Δ| <= 1 per channel value, and each
  case prints how many values differ;
* PNG and BMP: bitwise (lossless formats: unfiltering and channel
  expansion are exact);
* the committed fixtures (``tests/data/jpeg``) decode to the SHA-256 of
  PIL's arrays recorded in ``hashes.json``, which ``chip_smoke.py``
  checks again on the card.

JPEGs come from PIL at quality 75 and 95 in 4:4:4, 4:2:2 and 4:2:0, grey,
with restart markers and at odd sizes. 4:4:0 and non-interleaved scans,
which PIL does not write, come from a small baseline encoder below
(PIL's own tables, a float forward DCT), and PIL decodes them too.
"""

import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image
from tests.torch_parity import one_torch_thread  # noqa: F401

from bigdl_tpu_torch.native import decode_image, decode_images

DATA = os.path.join(os.path.dirname(__file__), "data", "jpeg")


def smooth(h, w, seed, c=3):
    """A seeded image with JPEG-friendly structure and some noise."""
    rng = np.random.RandomState(seed)
    coarse = (rng.rand(h // 8 + 2, w // 8 + 2, c) * 255).astype(np.uint8)
    img = Image.fromarray(coarse[:, :, 0] if c == 1 else coarse)
    base = np.asarray(img.resize((w, h), Image.BICUBIC), np.int32)
    noise = rng.randint(-20, 21, base.shape)
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def held_to_pil(data: bytes, what: str) -> None:
    """Bitwise, or within 1 per value with the count printed."""
    want, got = pil_rgb(data), decode_image(data, what)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert got.flags["C_CONTIGUOUS"]
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    n = int((d > 0).sum())
    print(f"{what}: {n} of {d.size} values differ, max {int(d.max())}")
    assert int(d.max()) <= 1, what


def save_jpeg(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


SIZES = [(375, 500), (17, 13), (1, 1), (9, 31), (33, 7), (2, 3), (5, 18),
         (64, 64)]


@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("subsampling", [0, 1, 2],
                         ids=["444", "422", "420"])
@pytest.mark.parametrize("restart", [0, 3])
def test_pil_jpegs_decode_as_pil_decodes_them(quality, subsampling, restart):
    for h, w in SIZES:
        kw = dict(quality=quality, subsampling=subsampling)
        if restart:
            kw["restart_marker_blocks"] = restart
        data = save_jpeg(smooth(h, w, h * w + quality), **kw)
        if restart and h * w > 64 * 16:
            assert b"\xff\xd0" in data
        held_to_pil(data, f"{h}x{w} q{quality} s{subsampling} r{restart}")


@pytest.mark.parametrize("h,w", [(299, 299), (17, 13), (9, 31), (1, 5)])
def test_grey_jpeg_is_three_equal_channels(h, w):
    data = save_jpeg(smooth(h, w, 5, c=1), quality=80)
    held_to_pil(data, f"grey {h}x{w}")
    got = decode_image(data)
    assert (got[:, :, 0] == got[:, :, 1]).all()
    assert (got[:, :, 0] == got[:, :, 2]).all()


# -------------------------------------------- a small baseline encoder


def _segments(data: bytes):
    """(marker, payload) of the header segments of a JPEG, up to SOS."""
    pos, out = 2, []
    while True:
        m = data[pos + 1]
        (n,) = struct.unpack_from(">H", data, pos + 2)
        out.append((m, data[pos + 4:pos + 2 + n]))
        if m == 0xDA:
            return out
        pos += 2 + n


def _zigzag():
    order = sorted(((x + y, x if (x + y) % 2 else y, y * 8 + x)
                    for y in range(8) for x in range(8)))
    return [i for _, _, i in order]


ZIGZAG = _zigzag()                     # zigzag position -> natural index


def _huff_codes(payload: bytes):
    """{(class, id): {symbol: (code, length)}} of a DHT payload."""
    tables, i = {}, 0
    while i < len(payload):
        tc, th = payload[i] >> 4, payload[i] & 15
        counts = payload[i + 1:i + 17]
        vals = payload[i + 17:i + 17 + sum(counts)]
        codes, code, k = {}, 0, 0
        for length, n in enumerate(counts, start=1):
            for _ in range(n):
                codes[vals[k]] = (code, length)
                code += 1
                k += 1
            code <<= 1
        tables[(tc, th)] = codes
        i += 17 + sum(counts)
    return tables


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, v, n):
        self.acc = (self.acc << n) | (v & ((1 << n) - 1))
        self.n += n
        while self.n >= 8:
            b = (self.acc >> (self.n - 8)) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
            self.n -= 8

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _dct_matrix():
    m = np.zeros((8, 8))
    for u in range(8):
        c = np.sqrt(0.5) if u == 0 else 1.0
        for x in range(8):
            m[u, x] = 0.5 * c * np.cos((2 * x + 1) * u * np.pi / 16)
    return m


def encode_jpeg(rgb, sampling, interleaved=True, restart=0):
    """A baseline JPEG of ``rgb`` with the luma sampling ``(h, v)``
    (chroma 1x1), PIL's quality-75 tables, no JFIF marker (component ids
    1-3 imply YCbCr), one interleaved scan or one scan per component."""
    template = save_jpeg(np.zeros((16, 16, 3), np.uint8), quality=75,
                         subsampling=0)
    segs = {}
    for marker, payload in _segments(template):   # tables may be split
        segs[marker] = segs.get(marker, b"") + payload
    qt = {}
    dqt = segs[0xDB]
    i = 0
    while i < len(dqt):
        qt[dqt[i] & 15] = np.frombuffer(dqt[i + 1:i + 65], np.uint8)
        i += 65
    codes = _huff_codes(segs[0xC4])
    H, W, _ = rgb.shape
    f = rgb.astype(np.float64)
    y = 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
    cb = -0.168736 * f[..., 0] - 0.331264 * f[..., 1] + 0.5 * f[..., 2] + 128
    cr = 0.5 * f[..., 0] - 0.418688 * f[..., 1] - 0.081312 * f[..., 2] + 128
    hs, vs = sampling
    mcu_w, mcu_h = 8 * hs, 8 * vs
    mx, my = -(-W // mcu_w), -(-H // mcu_h)

    def plane(p, rh, rv):
        dh, dw = -(-H // rv), -(-W // rh)
        p = np.pad(p, ((0, dh * rv - H), (0, dw * rh - W)), mode="edge")
        return p.reshape(dh, rv, dw, rh).mean(axis=(1, 3)), dh, dw

    comps = []
    for k, (p, tq) in enumerate(((y, 0), (cb, 1), (cr, 1))):
        h, v = (hs, vs) if k == 0 else (1, 1)
        pl, dh, dw = plane(p, hs // h, vs // v)
        if interleaved:
            ph, pw = my * v * 8, mx * h * 8
        else:
            ph, pw = -(-dh // 8) * 8, -(-dw // 8) * 8
        pl = np.pad(pl, ((0, ph - dh), (0, pw - dw)), mode="edge")
        comps.append(dict(id=k + 1, h=h, v=v, tq=tq, plane=pl - 128.0,
                          bw=-(-dw // 8), bh=-(-dh // 8), table=tq))
    m = _dct_matrix()

    def block(c, by, bx, pred, bits):
        blk = c["plane"][by * 8:by * 8 + 8, bx * 8:bx * 8 + 8]
        coef = (m @ blk @ m.T).reshape(64)
        q = np.zeros(64)
        q[ZIGZAG] = qt[c["tq"]]
        zz = np.round(coef[ZIGZAG] / q[ZIGZAG]).astype(int)
        dc_codes, ac_codes = codes[(0, c["table"])], codes[(1, c["table"])]
        diff = zz[0] - pred
        s = int(abs(diff)).bit_length()
        bits.put(*dc_codes[s])
        if s:
            bits.put(diff if diff >= 0 else diff + (1 << s) - 1, s)
        run = 0
        for v in zz[1:]:
            if v == 0:
                run += 1
                continue
            while run > 15:
                bits.put(*ac_codes[0xF0])
                run -= 16
            s = int(abs(v)).bit_length()
            bits.put(*ac_codes[(run << 4) | s])
            bits.put(v if v >= 0 else v + (1 << s) - 1, s)
            run = 0
        if run:
            bits.put(*ac_codes[0x00])
        return int(zz[0])

    def seg(marker, payload):
        return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) \
            + payload

    out = bytearray(b"\xff\xd8")
    out += seg(0xDB, dqt)
    sof = struct.pack(">BHHB", 8, H, W, 3) + b"".join(
        bytes([c["id"], (c["h"] << 4) | c["v"], c["tq"]]) for c in comps)
    out += seg(0xC0, sof)
    out += seg(0xC4, segs[0xC4])
    if restart:
        out += seg(0xDD, struct.pack(">H", restart))

    def scan(scomps, units):
        bits, preds, n_rst = _Bits(), {c["id"]: 0 for c in scomps}, 0
        for i, unit in enumerate(units):
            if restart and i and i % restart == 0:
                bits.flush()
                bits.out += bytes([0xFF, 0xD0 + n_rst % 8])
                n_rst += 1
                preds = {k: 0 for k in preds}
            for c, by, bx in unit:
                preds[c["id"]] = block(c, by, bx, preds[c["id"]], bits)
        bits.flush()
        hdr = bytes([len(scomps)]) + b"".join(
            bytes([c["id"], (c["table"] << 4) | c["table"]])
            for c in scomps) + b"\x00\x3f\x00"
        return seg(0xDA, hdr) + bytes(bits.out)

    if interleaved:
        units = [[(c, yy + my_ * c["v"], xx + mx_ * c["h"]) for c in comps
                  for yy in range(c["v"]) for xx in range(c["h"])]
                 for my_ in range(my) for mx_ in range(mx)]
        out += scan(comps, units)
    else:
        for c in comps:
            out += scan([c], [[(c, by, bx)] for by in range(c["bh"])
                              for bx in range(c["bw"])])
    return bytes(out + b"\xff\xd9")


@pytest.mark.parametrize("sampling", [(1, 2), (2, 1), (2, 2), (1, 1)],
                         ids=["440", "422", "420", "444"])
@pytest.mark.parametrize("interleaved", [True, False])
def test_encoded_samplings_and_scans_decode_as_pil(sampling, interleaved):
    """4:4:0 (h1v2 fancy upsampling) and one scan per component, which PIL
    does not write; the other samplings through the same encoder."""
    for h, w in [(37, 45), (16, 16), (9, 2), (1, 17), (23, 3)]:
        data = encode_jpeg(smooth(h, w, h + w), sampling, interleaved,
                           restart=2 if h * w > 300 else 0)
        assert Image.open(io.BytesIO(data)).size == (w, h)
        held_to_pil(data, f"{h}x{w} {sampling} interleaved={interleaved}")


# ------------------------------------------------------ PNG and BMP


def save_png(img, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "PNG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("mode", ["L", "RGB", "P", "LA", "RGBA", "1",
                                  "P4"])
@pytest.mark.parametrize("size", [(37, 45), (1, 1), (3, 64)])
def test_pil_pngs_decode_bitwise(mode, size):
    rgb = np.random.RandomState(size[0]).randint(
        0, 256, (*size, 3)).astype(np.uint8)
    im = Image.fromarray(rgb)
    if mode.startswith("P"):      # PIL packs a 4-color palette in 2 bits
        im = im.quantize(50 if mode == "P" else 4)
    else:
        im = im.convert(mode)
    for optimize in (False, True):
        data = save_png(im, optimize=optimize)
        np.testing.assert_array_equal(decode_image(data), pil_rgb(data))


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_png(px: np.ndarray, ctype: int, filters, depth=8, interlace=0,
              palette=None) -> bytes:
    """A PNG whose rows use the given filter types (cycled), encoded
    here, so all five filters are exercised."""
    h, w = px.shape[:2]
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    raw = px.reshape(h, w * ch).astype(np.int32)
    rows = []
    for y in range(h):
        ft = filters[y % len(filters)]
        cur = raw[y]
        prev = raw[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(ch, np.int32), cur[:-ch]])
        ul = np.concatenate([np.zeros(ch, np.int32), prev[:-ch]])
        if ft == 0:
            pred = np.zeros_like(cur)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prev
        elif ft == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, ul))
        rows.append(bytes([ft]) + ((cur - pred) % 256).astype(np.uint8)
                    .tobytes())
    out = b"\x89PNG\r\n\x1a\n" + _png_chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                             interlace))
    if palette is not None:
        out += _png_chunk(b"PLTE", palette.tobytes())
    return out + _png_chunk(b"IDAT", zlib.compress(b"".join(rows))) \
        + _png_chunk(b"IEND", b"")


@pytest.mark.parametrize("ctype", [0, 2, 3, 4, 6])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (0, 1, 2, 3, 4)])
def test_every_png_row_filter_unfilters_bitwise(ctype, filters):
    rng = np.random.RandomState(ctype * 7 + len(filters))
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    px = rng.randint(0, 256, (11, 13, ch)).astype(np.uint8)
    palette = None
    if ctype == 3:
        px = px % 40
        palette = rng.randint(0, 256, (40, 3)).astype(np.uint8)
    data = write_png(px, ctype, filters, palette=palette)
    np.testing.assert_array_equal(decode_image(data), pil_rgb(data))


@pytest.mark.parametrize("size", [(37, 45), (1, 1), (5, 3)])
def test_bmp_decodes_bitwise(size):
    rgb = np.random.RandomState(2).randint(0, 256, (*size, 3)).astype(
        np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "BMP")
    data = buf.getvalue()
    np.testing.assert_array_equal(decode_image(data), rgb)
    np.testing.assert_array_equal(decode_image(data), pil_rgb(data))
    # a top-down BMP (negative height)
    top = bytearray(data)
    (h,) = struct.unpack_from("<i", top, 22)
    struct.pack_into("<i", top, 22, -h)
    (off,) = struct.unpack_from("<I", top, 10)
    stride = (size[1] * 3 + 3) // 4 * 4
    rows = [bytes(top[off + i * stride:off + (i + 1) * stride])
            for i in range(h)]
    top[off:off + h * stride] = b"".join(rows[::-1])
    np.testing.assert_array_equal(decode_image(bytes(top)), rgb)


# ------------------------------------------------------------ refusals


def _patch(data: bytes, marker: int, offset: int, value: int) -> bytes:
    i = data.index(bytes([0xFF, marker]))
    out = bytearray(data)
    out[i + offset] = value
    return bytes(out)


def refusals():
    rgb = smooth(24, 40, 1)
    base = save_jpeg(rgb, quality=75)
    gif = io.BytesIO()
    Image.fromarray(rgb).save(gif, "GIF")
    cmyk = io.BytesIO()
    Image.fromarray(rgb).convert("CMYK").save(cmyk, "JPEG")
    grey16 = io.BytesIO()
    Image.fromarray((rgb[:, :, 0].astype(np.uint16) * 200)).save(grey16,
                                                                 "PNG")
    px = rgb.reshape(24, 40, 3)
    return [
        ("progressive", save_jpeg(rgb, progressive=True),
         "progressive JPEG"),
        ("cmyk", cmyk.getvalue(), "CMYK/YCCK"),
        ("12bit", _patch(base, 0xC0, 4, 12), "12-bit JPEG"),
        ("arithmetic", _patch(base, 0xC0, 1, 0xC9), "arithmetic-coded"),
        ("lossless", _patch(base, 0xC0, 1, 0xC3), "lossless JPEG"),
        ("411", _patch(encode_jpeg(rgb, (2, 1)), 0xC0, 11, 0x41),
         "chroma sampling"),
        ("interlaced", write_png(px, 2, (0,), interlace=1), "interlaced"),
        ("png16", grey16.getvalue(), "16-bit PNG"),
        ("rgb4", write_png(px % 16, 2, (0,), depth=4), "4-bit PNG"),
        ("gif", gif.getvalue(), "GIF"),
        ("bmp32", _bmp32(rgb), "32-bit BMP"),
        ("unknown", b"not an image at all", "unknown image format"),
        ("truncated", base[:len(base) // 3], None),
    ]


def _bmp32(rgb):
    buf = io.BytesIO()
    Image.fromarray(rgb).convert("RGBA").save(buf, "BMP")
    return buf.getvalue()


@pytest.mark.parametrize("case", refusals(), ids=lambda c: c[0])
def test_unsupported_files_raise_naming_the_file_and_feature(case):
    name, data, feature = case
    path = f"/data/{name}.img"
    if feature is None:           # truncated data: decodes or raises
        try:
            out = decode_image(data, path)
        except ValueError as e:
            assert path in str(e)
        else:
            assert out.shape == (24, 40, 3)
        return
    with pytest.raises(ValueError) as e:
        decode_image(data, path)
    assert path in str(e.value) and feature in str(e.value), str(e.value)


# ------------------------------------------------------------ fixtures


def test_committed_fixtures_decode_to_the_recorded_hashes():
    with open(os.path.join(DATA, "hashes.json")) as f:
        hashes = json.load(f)
    assert len(hashes) == 8
    names = sorted(hashes)
    blobs = []
    for name in names:
        with open(os.path.join(DATA, name), "rb") as f:
            blobs.append(f.read())
    for n_threads in (1, 4):
        for name, data, got in zip(names, blobs, decode_images(
                blobs, n_threads=n_threads, names=names)):
            assert list(got.shape) == hashes[name]["shape"], name
            assert hashlib.sha256(got.tobytes()).hexdigest() == \
                hashes[name]["sha256"], name
            if n_threads == 1:            # the recorded hash is PIL's
                held_to_pil(data, name)
