// Image decoding for the host data plane: baseline JPEG and PNG row
// unfiltering (the PIL calls of bigdl_tpu/dataset/image.py:200-213 and
// bigdl_tpu/transform/vision/image.py:345-363 have no counterpart on the
// card's machine, which has no PIL). See bigdl_native.h for the C API.
//
// The JPEG path reproduces what PIL gets from libjpeg-turbo's defaults, so
// the two decode the same file to the same bytes:
//   * Huffman entropy decoding of sequential (baseline or extended 8-bit)
//     scans, interleaved or not, with restart intervals;
//   * the integer "islow" IDCT of jidctint.c (13-bit constants, 2 bits of
//     pass-1 scaling, the same rounding and the same range-limit table);
//   * "fancy" upsampling of subsampled planes (jdsample.c: h2v1 and h2v2
//     triangle filters when the plane is wider than 2 samples, h1v2 always,
//     box replication otherwise), with the rows above and below the image
//     and the columns past its edge replicated from the edge;
//   * the fixed-point YCbCr->RGB tables of jdcolor.c (16 fraction bits).
// Everything else raises a message naming the feature: progressive,
// arithmetic-coded, lossless or hierarchical JPEG, 12-bit samples, CMYK or
// YCCK (four components), samplings other than 1x or 2x per axis.

#include "bigdl_native.h"

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct JpegError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw JpegError{msg}; }

// zigzag position -> natural (row-major) index; 16 extra entries absorb a
// run that overshoots the block, as jpeg_natural_order does
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct HuffTable {
  bool defined = false;
  uint8_t look_len[1 << kLookBits];
  uint8_t look_val[1 << kLookBits];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
};

void build_huff(HuffTable& t, const uint8_t counts[16], const uint8_t* vals,
                int n_vals) {
  int huffsize[257], huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < counts[l - 1]; ++i) huffsize[p++] = l;
  huffsize[p] = 0;
  int code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code > (1 << si)) fail("bad Huffman table");
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (counts[l - 1]) {
      t.valoffset[l] = p - huffcode[p];
      p += counts[l - 1];
      t.maxcode[l] = huffcode[p - 1];
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.maxcode[17] = 0x7FFFFFFF;
  std::memcpy(t.vals, vals, n_vals);
  std::memset(t.look_len, 0, sizeof(t.look_len));
  p = 0;
  for (int l = 1; l <= kLookBits; ++l) {
    for (int i = 0; i < counts[l - 1]; ++i, ++p) {
      const int first = huffcode[p] << (kLookBits - l);
      for (int j = 0; j < (1 << (kLookBits - l)); ++j) {
        t.look_len[first + j] = static_cast<uint8_t>(l);
        t.look_val[first + j] = vals[p];
      }
    }
  }
  t.defined = true;
}

// MSB-first bit buffer over entropy-coded bytes: a stuffed 0xFF00 reads as
// 0xFF; at a marker it stops consuming and supplies zero bits (as libjpeg
// does on a short segment)
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int bits = 0;
  bool at_marker = false;

  void fill() {
    while (bits <= 56) {
      uint64_t b = 0;
      if (!at_marker && p < end) {
        const uint8_t c = *p;
        if (c == 0xFF) {
          if (p + 1 < end && p[1] == 0x00) {
            p += 2;
            b = 0xFF;
          } else {
            at_marker = true;
          }
        } else {
          ++p;
          b = c;
        }
      }
      buf |= b << (56 - bits);
      bits += 8;
    }
  }
  uint32_t get(int n) {  // n in 1..16
    if (bits < n) fill();
    const uint32_t v = static_cast<uint32_t>(buf >> (64 - n));
    buf <<= n;
    bits -= n;
    return v;
  }
  void restart() {  // drop buffered bits, step over the RSTn marker
    buf = 0;
    bits = 0;
    const uint8_t* q = p;
    while (q + 1 < end && !(q[0] == 0xFF && q[1] >= 0xD0 && q[1] <= 0xD7)) ++q;
    p = q + 1 < end ? q + 2 : end;
    at_marker = false;
  }
};

int decode_huff(BitReader& br, const HuffTable& t) {
  if (br.bits < 16) br.fill();
  const uint32_t look = static_cast<uint32_t>(br.buf >> (64 - kLookBits));
  const int len = t.look_len[look];
  if (len) {
    br.buf <<= len;
    br.bits -= len;
    return t.look_val[look];
  }
  const uint32_t code16 = static_cast<uint32_t>(br.buf >> 48);
  for (int l = kLookBits + 1; l <= 16; ++l) {
    const int32_t code = static_cast<int32_t>(code16 >> (16 - l));
    if (code <= t.maxcode[l]) {
      br.buf <<= l;
      br.bits -= l;
      return t.vals[code + t.valoffset[l]];
    }
  }
  fail("corrupt JPEG data: bad Huffman code");
}

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// ------------------------------------------------------------ islow IDCT

// jidctint.c's tables: range_limit over DESCALE(...) & 1023 (the post-IDCT
// table of jdmaster.c) and the simple 0..255 clamp of the color converter
uint8_t g_idct_limit[1024];
int g_cr_r[256], g_cb_b[256], g_cr_g[256], g_cb_g[256];

struct Tables {
  Tables() {
    for (int i = 0; i < 1024; ++i) {
      const int x = i < 512 ? i : i - 1024;
      g_idct_limit[i] =
          static_cast<uint8_t>(std::min(255, std::max(0, x + 128)));
    }
    // jdcolor.c build_ycc_rgb_table: SCALEBITS 16, FIX(x) rounds x * 2^16
    const int64_t one_half = int64_t(1) << 15;
    auto fix = [](double v) { return static_cast<int64_t>(v * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      g_cr_r[i] = static_cast<int>((fix(1.40200) * x + one_half) >> 16);
      g_cb_b[i] = static_cast<int>((fix(1.77200) * x + one_half) >> 16);
      g_cr_g[i] = static_cast<int>(-fix(0.71414) * x);
      g_cb_g[i] = static_cast<int>(-fix(0.34414) * x + one_half);
    }
  }
};
const Tables g_tables;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270,
                  F0_899 = 7373, F1_175 = 9633, F1_501 = 12299,
                  F1_847 = 15137, F1_961 = 16069, F2_053 = 16819,
                  F2_562 = 20995, F3_072 = 25172;

// coef: natural order; q: quantizer in natural order; out: 8 rows of 8
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qt = q + c;
    int* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] &&
        !in[56]) {
      const int dc = in[0] * qt[0] * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = in[16] * qt[16], z3 = in[48] * qt[48];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    z2 = in[0] * qt[0];
    z3 = in[32] * qt[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = in[56] * qt[56];
    tmp1 = in[40] * qt[40];
    tmp2 = in[24] * qt[24];
    tmp3 = in[8] * qt[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    w[0] = static_cast<int>(descale(tmp10 + tmp3, sh));
    w[56] = static_cast<int>(descale(tmp10 - tmp3, sh));
    w[8] = static_cast<int>(descale(tmp11 + tmp2, sh));
    w[48] = static_cast<int>(descale(tmp11 - tmp2, sh));
    w[16] = static_cast<int>(descale(tmp12 + tmp1, sh));
    w[40] = static_cast<int>(descale(tmp12 - tmp1, sh));
    w[24] = static_cast<int>(descale(tmp13 + tmp0, sh));
    w[32] = static_cast<int>(descale(tmp13 - tmp0, sh));
  }
  const int sh = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + static_cast<size_t>(r) * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      const uint8_t v = g_idct_limit[descale(w[0], kPass1Bits + 3) & 1023];
      for (int i = 0; i < 8; ++i) o[i] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (1 << kConstBits);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = g_idct_limit[descale(tmp10 + tmp3, sh) & 1023];
    o[7] = g_idct_limit[descale(tmp10 - tmp3, sh) & 1023];
    o[1] = g_idct_limit[descale(tmp11 + tmp2, sh) & 1023];
    o[6] = g_idct_limit[descale(tmp11 - tmp2, sh) & 1023];
    o[2] = g_idct_limit[descale(tmp12 + tmp1, sh) & 1023];
    o[5] = g_idct_limit[descale(tmp12 - tmp1, sh) & 1023];
    o[3] = g_idct_limit[descale(tmp13 + tmp0, sh) & 1023];
    o[4] = g_idct_limit[descale(tmp13 - tmp0, sh) & 1023];
  }
}

// ------------------------------------------------------------ the decoder

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc = 0, ac = 0, pred = 0;
  int dw = 0, dh = 0;     // downsampled size (jdinput.c)
  int stride = 0, rows = 0;
  std::vector<uint8_t> plane;
};

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

class Jpeg {
 public:
  Jpeg(const uint8_t* buf, int64_t size) : buf_(buf), size_(size) {}

  // parses through the frame header only (info) or the whole file
  void run(bool info_only) {
    if (size_ < 4 || buf_[0] != 0xFF || buf_[1] != 0xD8)
      fail("not a JPEG file (no SOI marker)");
    int64_t pos = 2;
    bool frame = false, scanned = false;
    for (;;) {
      while (pos < size_ && buf_[pos] != 0xFF) ++pos;  // junk before a marker
      while (pos < size_ && buf_[pos] == 0xFF) ++pos;  // fill bytes
      if (pos >= size_) {
        if (scanned) break;  // a missing EOI after the image data
        fail("truncated JPEG file");
      }
      const uint8_t m = buf_[pos++];
      if (m == 0xD9) break;                                  // EOI
      if (m == 0xD8 || m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      if (pos + 2 > size_) fail("truncated JPEG segment");
      const int len = (buf_[pos] << 8) | buf_[pos + 1];
      if (len < 2 || pos + len > size_) fail("truncated JPEG segment");
      const uint8_t* seg = buf_ + pos + 2;
      const int n = len - 2;
      switch (m) {
        case 0xC0:
        case 0xC1:
          sof(seg, n);
          frame = true;
          if (info_only) return;
          break;
        case 0xC2:
        case 0xC6:
          fail("progressive JPEG (SOF" + std::to_string(m - 0xC0) + ")");
        case 0xC3:
        case 0xC7:
          fail("lossless JPEG (SOF" + std::to_string(m - 0xC0) + ")");
        case 0xC5:
          fail("hierarchical JPEG (SOF5)");
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
        case 0xCC:
          fail("arithmetic-coded JPEG");
        case 0xC4:
          dht(seg, n);
          break;
        case 0xDB:
          dqt(seg, n);
          break;
        case 0xDD:
          if (n < 2) fail("bad DRI segment");
          restart_interval_ = (seg[0] << 8) | seg[1];
          break;
        case 0xDA:
          if (!frame) fail("scan before the frame header");
          pos = scan(seg, n, pos + len);
          scanned = true;
          continue;
        case 0xE0:
          if (n >= 5 && !std::memcmp(seg, "JFIF\0", 5)) jfif_ = true;
          break;
        case 0xEE:
          if (n >= 12 && !std::memcmp(seg, "Adobe", 5)) {
            adobe_ = true;
            adobe_transform_ = seg[11];
          }
          break;
        default:
          break;
      }
      pos += len;
    }
    if (!frame) fail("no frame header (SOF) in the JPEG file");
    if (info_only) return;
    if (!scanned) fail("no image data (SOS) in the JPEG file");
  }

  void write_rgb(uint8_t* out) {
    const int W = width_, H = height_;
    if (comps_.size() == 1) {
      const Component& c = comps_[0];
      for (int y = 0; y < H; ++y) {
        const uint8_t* row = c.plane.data() + static_cast<size_t>(y) * c.stride;
        uint8_t* o = out + static_cast<size_t>(y) * W * 3;
        for (int x = 0; x < W; ++x)
          o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = row[x];
      }
      return;
    }
    const uint8_t* p[3];
    int stride[3];
    std::vector<uint8_t> up[3];
    for (int i = 0; i < 3; ++i) {
      upsample(comps_[i], up[i], &p[i], &stride[i]);
    }
    const bool rgb = rgb_colorspace();
    for (int y = 0; y < H; ++y) {
      const uint8_t* r0 = p[0] + static_cast<size_t>(y) * stride[0];
      const uint8_t* r1 = p[1] + static_cast<size_t>(y) * stride[1];
      const uint8_t* r2 = p[2] + static_cast<size_t>(y) * stride[2];
      uint8_t* o = out + static_cast<size_t>(y) * W * 3;
      if (rgb) {
        for (int x = 0; x < W; ++x) {
          o[3 * x] = r0[x];
          o[3 * x + 1] = r1[x];
          o[3 * x + 2] = r2[x];
        }
        continue;
      }
      for (int x = 0; x < W; ++x) {
        const int yy = r0[x], cb = r1[x], cr = r2[x];
        o[3 * x] = clamp(yy + g_cr_r[cr]);
        o[3 * x + 1] = clamp(yy + ((g_cb_g[cb] + g_cr_g[cr]) >> 16));
        o[3 * x + 2] = clamp(yy + g_cb_b[cb]);
      }
    }
  }

  int width_ = 0, height_ = 0;

 private:
  static uint8_t clamp(int v) {
    return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
  }

  bool rgb_colorspace() const {  // jdapimin.c default_decompress_parms
    if (jfif_) return false;
    if (adobe_) return adobe_transform_ == 0;
    return comps_[0].id == 82 && comps_[1].id == 71 && comps_[2].id == 66;
  }

  void sof(const uint8_t* s, int n) {
    if (n < 6) fail("bad SOF segment");
    if (!comps_.empty()) fail("more than one frame header");
    const int precision = s[0];
    if (precision != 8)
      fail(std::to_string(precision) + "-bit JPEG (only 8-bit samples)");
    height_ = (s[1] << 8) | s[2];
    width_ = (s[3] << 8) | s[4];
    const int nc = s[5];
    if (height_ == 0)
      fail("JPEG with its height in a DNL marker");
    if (width_ == 0) fail("JPEG of zero width");
    if (nc == 4) fail("CMYK/YCCK JPEG (four components)");
    if (nc != 1 && nc != 3)
      fail("JPEG with " + std::to_string(nc) + " components");
    if (n < 6 + 3 * nc) fail("bad SOF segment");
    hmax_ = vmax_ = 1;
    for (int i = 0; i < nc; ++i) {
      Component c;
      c.id = s[6 + 3 * i];
      c.h = s[7 + 3 * i] >> 4;
      c.v = s[7 + 3 * i] & 15;
      c.tq = s[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("bad JPEG component parameters");
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
      comps_.push_back(c);
    }
    mcux_ = ceil_div(width_, 8 * hmax_);
    mcuy_ = ceil_div(height_, 8 * vmax_);
    for (Component& c : comps_) {
      if (nc == 3) {
        const int rh = hmax_ / c.h, rv = vmax_ / c.v;
        if (hmax_ % c.h || vmax_ % c.v || rh > 2 || rv > 2)
          fail("JPEG chroma sampling " + std::to_string(hmax_) + "x" +
               std::to_string(vmax_) + " over " + std::to_string(c.h) + "x" +
               std::to_string(c.v) +
               " (4:4:4, 4:2:2, 4:2:0 and 4:4:0 are read)");
      }
      c.dw = ceil_div(width_ * c.h, hmax_);
      c.dh = ceil_div(height_ * c.v, vmax_);
      c.stride = mcux_ * c.h * 8;
      c.rows = mcuy_ * c.v * 8;
      c.plane.assign(static_cast<size_t>(c.stride) * c.rows, 0);
    }
  }

  void dqt(const uint8_t* s, int n) {
    int i = 0;
    while (i < n) {
      const int pq = s[i] >> 4, tq = s[i] & 15;
      ++i;
      if (tq > 3 || pq > 1) fail("bad DQT segment");
      if (i + 64 * (pq + 1) > n) fail("bad DQT segment");
      for (int k = 0; k < 64; ++k) {
        const int v = pq ? (s[i + 2 * k] << 8) | s[i + 2 * k + 1] : s[i + k];
        qt_[tq][kNatural[k]] = static_cast<uint16_t>(v);
      }
      qt_defined_[tq] = true;
      i += 64 * (pq + 1);
    }
  }

  void dht(const uint8_t* s, int n) {
    int i = 0;
    while (i < n) {
      if (i + 17 > n) fail("bad DHT segment");
      const int tc = s[i] >> 4, th = s[i] & 15;
      if (tc > 1 || th > 3) fail("bad DHT segment");
      const uint8_t* counts = s + i + 1;
      int total = 0;
      for (int l = 0; l < 16; ++l) total += counts[l];
      if (total > 256 || i + 17 + total > n) fail("bad DHT segment");
      build_huff(huff_[tc][th], counts, s + i + 17, total);
      i += 17 + total;
    }
  }

  void decode_into(BitReader& br, Component& c, int by, int bx) {
    const HuffTable& dc = huff_[0][c.dc];
    const HuffTable& ac = huff_[1][c.ac];
    int16_t coef[64];
    std::memset(coef, 0, sizeof(coef));
    int s = decode_huff(br, dc);
    if (s > 15) fail("corrupt JPEG data: bad DC magnitude");
    if (s) c.pred += extend(static_cast<int>(br.get(s)), s);
    coef[0] = static_cast<int16_t>(c.pred);
    for (int k = 1; k < 64; ++k) {
      const int rs = decode_huff(br, ac);
      const int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        coef[kNatural[k]] =
            static_cast<int16_t>(extend(static_cast<int>(br.get(s)), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    idct_islow(coef, qt_[c.tq],
               c.plane.data() + static_cast<size_t>(by) * 8 * c.stride + bx * 8,
               c.stride);
  }

  // decodes one sequential scan; returns the file position after its data
  int64_t scan(const uint8_t* s, int n, int64_t data) {
    if (n < 1) fail("bad SOS segment");
    const int ns = s[0];
    if (ns < 1 || ns > 4 || n < 4 + 2 * ns) fail("bad SOS segment");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      const int id = s[1 + 2 * i];
      Component* c = nullptr;
      for (Component& x : comps_)
        if (x.id == id) c = &x;
      if (!c) fail("scan names an unknown component");
      c->dc = s[2 + 2 * i] >> 4;
      c->ac = s[2 + 2 * i] & 15;
      if (c->dc > 3 || c->ac > 3 || !huff_[0][c->dc].defined ||
          !huff_[1][c->ac].defined)
        fail("scan uses an undefined Huffman table");
      if (!qt_defined_[c->tq]) fail("component uses an undefined quantizer");
      c->pred = 0;
      sc.push_back(c);
    }
    const int ss = s[1 + 2 * ns], se = s[2 + 2 * ns], ahl = s[3 + 2 * ns];
    if (ss != 0 || se != 63 || ahl != 0)
      fail("JPEG scan is not sequential (spectral selection " +
           std::to_string(ss) + "-" + std::to_string(se) + ")");
    BitReader br{buf_ + data, buf_ + size_};
    int64_t mcu = 0;
    auto restart = [&]() {
      if (restart_interval_ && mcu > 0 && mcu % restart_interval_ == 0) {
        br.restart();
        for (Component* c : sc) c->pred = 0;
      }
      ++mcu;
    };
    if (ns == 1) {  // one block per MCU over the component's own blocks
      Component& c = *sc[0];
      const int bw = ceil_div(c.dw, 8), bh = ceil_div(c.dh, 8);
      for (int by = 0; by < bh; ++by)
        for (int bx = 0; bx < bw; ++bx) {
          restart();
          decode_into(br, c, by, bx);
        }
    } else {
      for (int my = 0; my < mcuy_; ++my)
        for (int mx = 0; mx < mcux_; ++mx) {
          restart();
          for (Component* c : sc)
            for (int yy = 0; yy < c->v; ++yy)
              for (int xx = 0; xx < c->h; ++xx)
                decode_into(br, *c, my * c->v + yy, mx * c->h + xx);
        }
    }
    // the next marker: an FF not followed by a stuffed zero or a restart
    const uint8_t* q = br.p;
    const uint8_t* end = buf_ + size_;
    while (q + 1 < end &&
           !(q[0] == 0xFF && q[1] != 0x00 && !(q[1] >= 0xD0 && q[1] <= 0xD7)))
      ++q;
    return q + 1 < end ? q - buf_ : size_;
  }

  // a component plane at full size: its own plane (no subsampling) or the
  // upsampled copy in `up`; rows and columns past the plane's downsampled
  // size replicate its edge (jdmainct.c's context rows, jdsample.c's edge
  // columns)
  void upsample(const Component& c, std::vector<uint8_t>& up,
                const uint8_t** p, int* stride) const {
    const int rh = hmax_ / c.h, rv = vmax_ / c.v;
    const uint8_t* in = c.plane.data();
    const int is = c.stride, dw = c.dw, dh = c.dh;
    if (rh == 1 && rv == 1) {
      *p = in;
      *stride = is;
      return;
    }
    const int ow = dw * rh, oh = dh * rv;
    up.assign(static_cast<size_t>(ow) * oh, 0);
    *p = up.data();
    *stride = ow;
    auto at = [&](int y, int x) -> int {
      y = std::min(std::max(y, 0), dh - 1);
      x = std::min(std::max(x, 0), dw - 1);
      return in[static_cast<size_t>(y) * is + x];
    };
    if (rh == 2 && rv == 1) {
      for (int y = 0; y < dh; ++y) {
        uint8_t* o = up.data() + static_cast<size_t>(y) * ow;
        for (int x = 0; x < dw; ++x) {
          const int v = at(y, x);
          if (dw > 2) {  // h2v1_fancy_upsample
            o[2 * x] = static_cast<uint8_t>((v * 3 + at(y, x - 1) + 1) >> 2);
            o[2 * x + 1] =
                static_cast<uint8_t>((v * 3 + at(y, x + 1) + 2) >> 2);
          } else {
            o[2 * x] = o[2 * x + 1] = static_cast<uint8_t>(v);
          }
        }
      }
    } else if (rh == 1 && rv == 2) {  // h1v2_fancy_upsample
      for (int y = 0; y < dh; ++y)
        for (int half = 0; half < 2; ++half) {
          uint8_t* o = up.data() + static_cast<size_t>(2 * y + half) * ow;
          const int ny = half ? y + 1 : y - 1, bias = half ? 2 : 1;
          for (int x = 0; x < dw; ++x)
            o[x] = static_cast<uint8_t>((at(y, x) * 3 + at(ny, x) + bias) >> 2);
        }
    } else {  // 2 x 2
      std::vector<int> sum(dw);
      for (int y = 0; y < dh; ++y)
        for (int half = 0; half < 2; ++half) {
          uint8_t* o = up.data() + static_cast<size_t>(2 * y + half) * ow;
          if (dw <= 2) {  // h2v2_upsample
            for (int x = 0; x < dw; ++x)
              o[2 * x] = o[2 * x + 1] = static_cast<uint8_t>(at(y, x));
            continue;
          }
          const int ny = half ? y + 1 : y - 1;
          for (int x = 0; x < dw; ++x) sum[x] = at(y, x) * 3 + at(ny, x);
          for (int x = 0; x < dw; ++x) {  // h2v2_fancy_upsample
            const int left = sum[x > 0 ? x - 1 : 0];
            const int right = sum[x + 1 < dw ? x + 1 : dw - 1];
            o[2 * x] = static_cast<uint8_t>((sum[x] * 3 + left + 8) >> 4);
            o[2 * x + 1] = static_cast<uint8_t>((sum[x] * 3 + right + 7) >> 4);
          }
        }
    }
  }

  const uint8_t* buf_;
  int64_t size_;
  std::vector<Component> comps_;
  int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  int restart_interval_ = 0;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1;
  uint16_t qt_[4][64] = {};
  bool qt_defined_[4] = {false, false, false, false};
  HuffTable huff_[2][4];
};

void set_err(char* err, int32_t err_len, const std::string& msg) {
  if (err && err_len > 0) std::snprintf(err, err_len, "%s", msg.c_str());
}

}  // namespace

extern "C" {

int32_t bigdl_jpeg_info(const uint8_t* buf, int64_t size, int32_t* h,
                        int32_t* w, char* err, int32_t err_len) {
  try {
    Jpeg j(buf, size);
    j.run(true);
    *h = j.height_;
    *w = j.width_;
    return 0;
  } catch (const JpegError& e) {
    set_err(err, err_len, e.msg);
  } catch (const std::bad_alloc&) {
    set_err(err, err_len, "out of memory");
  }
  return -1;
}

int32_t bigdl_jpeg_decode(const uint8_t* buf, int64_t size, uint8_t* out,
                          int32_t h, int32_t w, char* err, int32_t err_len) {
  try {
    Jpeg j(buf, size);
    j.run(false);
    if (j.height_ != h || j.width_ != w) fail("output size mismatch");
    j.write_rgb(out);
    return 0;
  } catch (const JpegError& e) {
    set_err(err, err_len, e.msg);
  } catch (const std::bad_alloc&) {
    set_err(err, err_len, "out of memory");
  }
  return -1;
}

int32_t bigdl_png_unfilter(const uint8_t* raw, int32_t h, int32_t row_bytes,
                           int32_t bpp, uint8_t* out) {
  for (int32_t y = 0; y < h; ++y) {
    const uint8_t* src = raw + static_cast<size_t>(y) * (row_bytes + 1);
    const int ft = src[0];
    ++src;
    uint8_t* cur = out + static_cast<size_t>(y) * row_bytes;
    const uint8_t* prev = y ? cur - row_bytes : nullptr;
    switch (ft) {
      case 0:
        std::memcpy(cur, src, row_bytes);
        break;
      case 1:
        for (int32_t i = 0; i < row_bytes; ++i)
          cur[i] = static_cast<uint8_t>(src[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int32_t i = 0; i < row_bytes; ++i)
          cur[i] = static_cast<uint8_t>(src[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (int32_t i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0, b = prev ? prev[i] : 0;
          cur[i] = static_cast<uint8_t>(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int32_t i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0, b = prev ? prev[i] : 0;
          const int c = (i >= bpp && prev) ? prev[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = static_cast<uint8_t>(src[i] + pred);
        }
        break;
      default:
        return 1 + y;
    }
  }
  return 0;
}

}  // extern "C"
