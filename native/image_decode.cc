// Image reader for the Oxford-IIIT-Pet path: a JPEG decoder and Pillow's
// bicubic resize, giving bit for bit what Pillow 12.1.0 on libjpeg-turbo 3.1.3
// gives for Image.open(path).convert("RGB").resize((res, res)).
//
// JPEG: baseline and extended sequential Huffman (8-bit) and progressive
// (spectral selection, successive approximation), 1, 3 or 4 components, any
// sampling factors whose ratios are integral, restart intervals. The output
// stage is libjpeg's defaults: the accurate integer IDCT (jidctint.c, with the
// SIMD versions' saturating output), block smoothing of a progressive image
// whose low bits were left unrefined (jdcoefct.c), fancy upsampling
// (jdsample.c), the fixed-point YCbCr->RGB tables (jdcolor.c) and the colour
// space guess of jdapimin.c. Pillow then reads a 4-component image as inverted
// CMYK and converts it with Convert.c's cmyk2rgb; grey is replicated.
// No EXIF rotation and no ICC transform, as Pillow's open / convert / resize.
// A file that ends before its image data does raises, as Pillow does.
//
// Resize: Resample.c's two-pass fixed-point convolution (Keys cubic, a=-0.5,
// support scaled by the downscale factor, 22 fractional bits, horizontal pass
// into a uint8 image, then the vertical pass).
//
// Built by ssp_x_vit_tpu_torch/data/image_decode.py with
//   g++ -O3 -std=c++17 -fPIC -pthread -shared -ffp-contract=off
// (-ffp-contract=off: the resize weights must round as Pillow's do).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

namespace {

struct DecodeError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& what) { throw DecodeError(what); }

// Zigzag index -> natural index, with 16 extra entries (as libjpeg's
// jpeg_natural_order) so a corrupt run length cannot write outside the block.
constexpr int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct HuffTable {
  bool defined = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  // derived (jdhuff.c jpeg_make_d_derived_tbl)
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t look[1 << kLookBits];  // (length << 8) | symbol, 0 = longer code
};

void derive(HuffTable& t, bool dc) {
  int huffsize[257];
  uint32_t huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < t.bits[l]; i++) huffsize[p++] = l;
  huffsize[p] = 0;
  const int numsymbols = p;
  uint32_t code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) {
      huffcode[p++] = code;
      code++;
    }
    // no code may be all ones
    if (code >= (1u << si)) fail("corrupt JPEG: bad Huffman table");
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (t.bits[l]) {
      t.valoffset[l] = p - static_cast<int32_t>(huffcode[p]);
      p += t.bits[l];
      t.maxcode[l] = static_cast<int32_t>(huffcode[p - 1]);
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.valoffset[17] = 0;
  t.maxcode[17] = 0xFFFFF;
  std::memset(t.look, 0, sizeof(t.look));
  p = 0;
  for (int l = 1; l <= kLookBits; l++) {
    for (int i = 1; i <= t.bits[l]; i++, p++) {
      int lookbits = static_cast<int>(huffcode[p]) << (kLookBits - l);
      for (int ctr = 1 << (kLookBits - l); ctr > 0; ctr--)
        t.look[lookbits++] = static_cast<uint16_t>((l << 8) | t.vals[p]);
    }
  }
  if (dc)
    for (int i = 0; i < numsymbols; i++)
      if (t.vals[i] > 15) fail("corrupt JPEG: bad DC Huffman table");
}

// Entropy-coded data with libjpeg's conventions: FF 00 is a data FF, FF fill
// bytes are skipped, any other marker stops the data and the decoder reads
// zero bits from then on ("insufficient data"); the end of the file before a
// marker is a truncated file.
struct BitReader {
  const uint8_t* d = nullptr;
  size_t n = 0, pos = 0;
  uint64_t acc = 0;
  int nbits = 0;
  int marker = 0;
  bool insufficient = false;

  void fill() {
    while (nbits <= 56 && !marker) {
      if (pos >= n) fail("truncated JPEG: the file ends inside its image data");
      int c = d[pos++];
      if (c == 0xFF) {
        do {
          if (pos >= n) fail("truncated JPEG: the file ends inside its image data");
          c = d[pos++];
        } while (c == 0xFF);
        if (c == 0) {
          c = 0xFF;
        } else {
          marker = c;
          break;
        }
      }
      acc = (acc << 8) | static_cast<uint64_t>(c);
      nbits += 8;
    }
  }
  inline void need(int k) {
    if (nbits < k) {
      fill();
      if (nbits < k) {  // out of data: zero bits
        insufficient = true;
        acc <<= (56 - nbits);
        nbits = 56;
      }
    }
  }
  inline int get(int k) {
    need(k);
    nbits -= k;
    return static_cast<int>((acc >> nbits) & ((1u << k) - 1));
  }
  inline int decode(const HuffTable& t) {
    if (nbits < kLookBits) fill();
    int l;
    int32_t code;
    if (nbits >= kLookBits) {
      const int e = t.look[(acc >> (nbits - kLookBits)) & ((1 << kLookBits) - 1)];
      if (e) {
        nbits -= e >> 8;
        return e & 0xFF;
      }
      l = kLookBits + 1;
    } else {
      l = 1;
    }
    code = get(l);
    while (code > t.maxcode[l]) {
      code = (code << 1) | get(1);
      l++;
    }
    if (l > 16) return 0;  // bad code: libjpeg fakes a zero
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
};

inline int extend(int r, int s) { return r < (1 << (s - 1)) ? r + (-(1 << s) + 1) : r; }

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;    // downsampled width and height in samples
  int wib = 0, hib = 0;  // blocks holding image data
  int bw = 0, bh = 0;    // blocks allocated: whole MCUs
  std::vector<int16_t> coef;
  uint16_t q[64];
  bool q_latched = false;
  int coef_bits[64];
  int td = 0, ta = 0;
  int dc_pred = 0;
  inline int16_t* block(int by, int bx) {
    return &coef[(static_cast<size_t>(by) * bw + bx) * 64];
  }
};

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// jidctint.c jpeg_idct_islow; the output saturates as the SIMD versions do.
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  constexpr int CB = 13, P1 = 2;
  constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                    F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                    F2562 = 20995, F3072 = 25172;
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      const int dc = static_cast<int>(ip[0] * qp[0]) * (1 << P1);
      for (int r = 0; r < 8; r++) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847;
    int64_t tmp3 = z1 + z2 * F0765;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << CB);
    int64_t tmp1 = (z2 - z3) * (1 << CB);
    const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int S = CB - P1;
    constexpr int64_t R = int64_t{1} << (S - 1);
    wp[0] = static_cast<int>((t10 + tmp3 + R) >> S);
    wp[56] = static_cast<int>((t10 - tmp3 + R) >> S);
    wp[8] = static_cast<int>((t11 + tmp2 + R) >> S);
    wp[48] = static_cast<int>((t11 - tmp2 + R) >> S);
    wp[16] = static_cast<int>((t12 + tmp1 + R) >> S);
    wp[40] = static_cast<int>((t12 - tmp1 + R) >> S);
    wp[24] = static_cast<int>((t13 + tmp0 + R) >> S);
    wp[32] = static_cast<int>((t13 - tmp0 + R) >> S);
  }
  constexpr int S2 = CB + P1 + 3;
  constexpr int64_t R2 = int64_t{1} << (S2 - 1);
  for (int r = 0; r < 8; r++) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + static_cast<size_t>(r) * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      const uint8_t v = clamp255(((wp[0] + (1 << (P1 + 2))) >> (P1 + 3)) + 128);
      for (int c = 0; c < 8; c++) op[c] = v;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847;
    int64_t tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = (static_cast<int64_t>(wp[0]) + wp[4]) * (1 << CB);
    int64_t tmp1 = (static_cast<int64_t>(wp[0]) - wp[4]) * (1 << CB);
    const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = clamp255(static_cast<int>((t10 + tmp3 + R2) >> S2) + 128);
    op[7] = clamp255(static_cast<int>((t10 - tmp3 + R2) >> S2) + 128);
    op[1] = clamp255(static_cast<int>((t11 + tmp2 + R2) >> S2) + 128);
    op[6] = clamp255(static_cast<int>((t11 - tmp2 + R2) >> S2) + 128);
    op[2] = clamp255(static_cast<int>((t12 + tmp1 + R2) >> S2) + 128);
    op[5] = clamp255(static_cast<int>((t12 - tmp1 + R2) >> S2) + 128);
    op[3] = clamp255(static_cast<int>((t13 + tmp0 + R2) >> S2) + 128);
    op[4] = clamp255(static_cast<int>((t13 - tmp0 + R2) >> S2) + 128);
  }
}

// jdcolor.c's YCbCr -> RGB tables (SCALEBITS 16).
struct ColorTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  ColorTables() {
    constexpr int SB = 16;
    constexpr int64_t HALF = int64_t{1} << (SB - 1);
    auto fix = [](double x) { return static_cast<int64_t>(x * (1 << SB) + 0.5); };
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + HALF) >> SB);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + HALF) >> SB);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + HALF;
    }
  }
};
const ColorTables kColor;

class Jpeg {
 public:
  Jpeg(const uint8_t* data, size_t len) : d_(data), n_(len) {}

  // Decode to RGB as Pillow's open(...).convert("RGB"): out is width*height*3.
  std::vector<uint8_t> decode_rgb(int* width, int* height) {
    parse();
    *width = width_;
    *height = height_;
    return output();
  }

 private:
  const uint8_t* d_;
  size_t n_;
  size_t pos_ = 0;
  int width_ = 0, height_ = 0, ncomp_ = 0;
  bool progressive_ = false, sof_ = false;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = 0;
  int hmax_ = 1, vmax_ = 1, mcus_x_ = 0, mcus_y_ = 0;
  Component comp_[4];
  uint16_t qt_[4][64];
  bool qt_defined_[4] = {false, false, false, false};
  HuffTable dc_[4], ac_[4];
  int restart_interval_ = 0;
  int scans_ = 0;

  int byte() {
    if (pos_ >= n_) fail("truncated JPEG: the file ends before its end-of-image marker");
    return d_[pos_++];
  }
  int u16() {
    const int a = byte();
    return (a << 8) | byte();
  }
  // jdmarker.c next_marker: skip to the next FF xx with xx neither 00 nor FF.
  int next_marker() {
    for (;;) {
      int c = byte();
      while (c != 0xFF) c = byte();
      do c = byte();
      while (c == 0xFF);
      if (c != 0) return c;
    }
  }
  // the payload of a marker segment: [pos_, pos_ + len - 2)
  size_t segment() {
    const int len = u16();
    if (len < 2 || pos_ + (len - 2) > n_) fail("truncated JPEG: a marker segment runs past the end");
    return static_cast<size_t>(len - 2);
  }

  void parse() {
    if (n_ < 2 || d_[0] != 0xFF || d_[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
    pos_ = 2;
    int m = next_marker();
    for (;;) {
      bool done = false;
      int after = 0;  // marker already read by a scan
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2:
          read_sof(m == 0xC2);
          break;
        case 0xC3: case 0xC5: case 0xC6: case 0xC7: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
          fail("unsupported JPEG: lossless or hierarchical coding (SOF" + std::to_string(m - 0xC0) + ")");
        case 0xC9: case 0xCA:
          fail("unsupported JPEG: arithmetic coding (SOF" + std::to_string(m - 0xC0) + ")");
        case 0xC4:
          read_dht();
          break;
        case 0xDB:
          read_dqt();
          break;
        case 0xDD: {
          const size_t len = segment();
          if (len != 2) fail("corrupt JPEG: bad DRI length");
          restart_interval_ = u16();
          break;
        }
        case 0xDA: {
          const bool single = read_sos_and_decode(&after);
          // A single sequential scan of every component is the whole image:
          // libjpeg outputs it, and Pillow needs nothing after it.
          if (single) done = true;
          break;
        }
        case 0xD9:
          if (!scans_) fail("corrupt JPEG: no image data before end-of-image");
          done = true;
          break;
        case 0xE0: case 0xEE:
          read_app(m);
          break;
        case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5: case 0xD6: case 0xD7:
        case 0x01:
          break;  // parameterless markers are ignored
        case 0xD8:
          fail("corrupt JPEG: a second SOI marker");
        default:
          if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE || m == 0xDC || m == 0xCC || m == 0xDE ||
              m == 0xDF || (m >= 0xF0 && m <= 0xFD)) {
            pos_ += segment();
            break;
          }
          fail("corrupt JPEG: unknown marker 0x" + std::to_string(m));
      }
      if (done) return;
      m = after ? after : next_marker();
    }
  }

  void read_app(int m) {
    const size_t len = segment();
    const uint8_t* b = d_ + pos_;
    if (m == 0xE0 && len >= 14 && !std::memcmp(b, "JFIF\0", 5)) jfif_ = true;
    if (m == 0xEE && len >= 12 && !std::memcmp(b, "Adobe", 5)) {
      adobe_ = true;
      adobe_transform_ = b[11];
    }
    pos_ += len;
  }

  void read_dqt() {
    size_t len = segment();
    const size_t end = pos_ + len;
    while (pos_ < end) {
      const int pq = byte();
      const int prec = pq >> 4, id = pq & 15;
      if (id >= 4) fail("corrupt JPEG: bad quantization table index");
      if (pos_ + 64 * (prec ? 2 : 1) > end) fail("corrupt JPEG: short quantization table");
      for (int i = 0; i < 64; i++) qt_[id][kNatural[i]] = static_cast<uint16_t>(prec ? u16() : byte());
      qt_defined_[id] = true;
    }
    if (pos_ != end) fail("corrupt JPEG: bad DQT length");
  }

  void read_dht() {
    size_t len = segment();
    const size_t end = pos_ + len;
    while (pos_ < end) {
      if (end - pos_ < 17) fail("corrupt JPEG: bad DHT length");
      const int tc = byte();
      uint8_t bits[17];
      bits[0] = 0;
      int count = 0;
      for (int i = 1; i <= 16; i++) count += (bits[i] = static_cast<uint8_t>(byte()));
      if (count > 256 || pos_ + count > end) fail("corrupt JPEG: bad Huffman table");
      const int id = tc & 0x0F;
      if ((tc & 0xEF) > 3) fail("corrupt JPEG: bad Huffman table index");
      HuffTable& t = (tc & 0x10) ? ac_[id] : dc_[id];
      std::memcpy(t.bits, bits, 17);
      std::memset(t.vals, 0, 256);
      for (int i = 0; i < count; i++) t.vals[i] = static_cast<uint8_t>(byte());
      t.defined = true;
    }
    if (pos_ != end) fail("corrupt JPEG: bad DHT length");
  }

  void read_sof(bool progressive) {
    if (sof_) fail("corrupt JPEG: a second frame header");
    const size_t len = segment();
    const int precision = byte();
    height_ = u16();
    width_ = u16();
    ncomp_ = byte();
    if (precision != 8) fail("unsupported JPEG: " + std::to_string(precision) + "-bit samples");
    if (width_ <= 0 || height_ <= 0) fail("unsupported JPEG: empty image or a DNL-defined height");
    if (ncomp_ != 1 && ncomp_ != 3 && ncomp_ != 4)
      fail("unsupported JPEG: " + std::to_string(ncomp_) + " components");
    if (len != static_cast<size_t>(6 + 3 * ncomp_)) fail("corrupt JPEG: bad SOF length");
    // Pillow refuses what is over twice its decompression-bomb limit
    if (static_cast<int64_t>(width_) * height_ > 2 * int64_t{89478485})
      fail("image too large: " + std::to_string(width_) + "x" + std::to_string(height_));
    for (int i = 0; i < ncomp_; i++) {
      Component& c = comp_[i];
      c.id = byte();
      const int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail("corrupt JPEG: bad sampling factors");
      if (c.tq >= 4) fail("corrupt JPEG: bad quantization table index");
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
    }
    mcus_x_ = (width_ + 8 * hmax_ - 1) / (8 * hmax_);
    mcus_y_ = (height_ + 8 * vmax_ - 1) / (8 * vmax_);
    for (int i = 0; i < ncomp_; i++) {
      Component& c = comp_[i];
      c.dw = static_cast<int>((static_cast<int64_t>(width_) * c.h + hmax_ - 1) / hmax_);
      c.dh = static_cast<int>((static_cast<int64_t>(height_) * c.v + vmax_ - 1) / vmax_);
      c.wib = static_cast<int>((static_cast<int64_t>(width_) * c.h + 8 * hmax_ - 1) / (8 * hmax_));
      c.hib = static_cast<int>((static_cast<int64_t>(height_) * c.v + 8 * vmax_ - 1) / (8 * vmax_));
      c.bw = mcus_x_ * c.h;
      c.bh = mcus_y_ * c.v;
      c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
      for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
    }
    progressive_ = progressive;
    sof_ = true;
  }

  // ---- scans -------------------------------------------------------------

  struct Scan {
    Component* comp[4];
    int ns = 0, ss = 0, se = 63, ah = 0, al = 0;
  };

  // returns true when this scan is the whole of a single-scan sequential image
  bool read_sos_and_decode(int* after) {
    if (!sof_) fail("corrupt JPEG: scan before the frame header");
    const size_t len = segment();
    Scan s;
    s.ns = byte();
    if (len != static_cast<size_t>(4 + 2 * s.ns) || s.ns < 1 || s.ns > 4)
      fail("corrupt JPEG: bad SOS length");
    for (int i = 0; i < s.ns; i++) {
      const int id = byte(), t = byte();
      Component* found = nullptr;
      for (int c = 0; c < ncomp_; c++) {
        bool used = false;
        for (int j = 0; j < i; j++) used |= s.comp[j] == &comp_[c];
        if (comp_[c].id == id && !used) {
          found = &comp_[c];
          break;
        }
      }
      if (!found) fail("corrupt JPEG: scan names an unknown component");
      found->td = t >> 4;
      found->ta = t & 15;
      s.comp[i] = found;
    }
    s.ss = byte();
    s.se = byte();
    const int a = byte();
    s.ah = a >> 4;
    s.al = a & 15;
    const bool first_scan = scans_ == 0;
    ++scans_;

    if (progressive_) {
      bool bad = false;
      if (s.ss == 0) {
        bad = s.se != 0;
      } else {
        bad = s.ss > s.se || s.se > 63 || s.ns != 1;
      }
      if (s.ah != 0 && s.al != s.ah - 1) bad = true;
      if (s.al > 13) bad = true;
      if (bad) fail("corrupt JPEG: invalid progressive scan parameters");
    } else {
      s.ss = 0;
      s.se = 63;
      s.ah = s.al = 0;
    }
    int blocks = 0;
    for (int i = 0; i < s.ns; i++) {
      Component& c = *s.comp[i];
      blocks += s.ns == 1 ? 1 : c.h * c.v;
      if (!c.q_latched) {
        if (!qt_defined_[c.tq]) fail("corrupt JPEG: missing quantization table");
        std::memcpy(c.q, qt_[c.tq], sizeof(c.q));
        c.q_latched = true;
      }
      c.dc_pred = 0;
      const bool need_dc = s.ss == 0 && (!progressive_ || s.ah == 0);
      const bool need_ac = !progressive_ || s.ss > 0;
      if (need_dc) {
        if (c.td >= 4 || !dc_[c.td].defined) fail("corrupt JPEG: missing Huffman table");
        derive(dc_[c.td], true);
      }
      if (need_ac) {
        if (c.ta >= 4 || !ac_[c.ta].defined) fail("corrupt JPEG: missing Huffman table");
        derive(ac_[c.ta], false);
      }
      if (progressive_)
        for (int k = s.ss; k <= s.se; k++) c.coef_bits[k] = s.al;
    }
    if (blocks > 10) fail("corrupt JPEG: too many blocks in an MCU");

    decode_scan(s, after);
    return first_scan && !progressive_ && s.ns == ncomp_;
  }

  void decode_scan(const Scan& s, int* after) {
    BitReader br;
    br.d = d_;
    br.n = n_;
    br.pos = pos_;
    int eobrun = 0;
    int restarts_to_go = restart_interval_;
    int next_rst = 0;
    const int mx_n = s.ns == 1 ? s.comp[0]->wib : mcus_x_;
    const int my_n = s.ns == 1 ? s.comp[0]->hib : mcus_y_;
    int16_t* blocks[10];
    Component* owner[10];
    for (int my = 0; my < my_n; my++) {
      for (int mx = 0; mx < mx_n; mx++) {
        if (restart_interval_) {
          if (restarts_to_go == 0) {
            restart(br, next_rst);
            next_rst = (next_rst + 1) & 7;
            for (int i = 0; i < s.ns; i++) s.comp[i]->dc_pred = 0;
            eobrun = 0;
            restarts_to_go = restart_interval_;
          }
        }
        int nb = 0;
        if (s.ns == 1) {
          blocks[nb] = s.comp[0]->block(my, mx);
          owner[nb++] = s.comp[0];
        } else {
          for (int i = 0; i < s.ns; i++) {
            Component* c = s.comp[i];
            for (int y = 0; y < c->v; y++)
              for (int x = 0; x < c->h; x++) {
                blocks[nb] = c->block(my * c->v + y, mx * c->h + x);
                owner[nb++] = c;
              }
          }
        }
        if (!br.insufficient) {
          for (int b = 0; b < nb; b++) {
            Component& c = *owner[b];
            int16_t* blk = blocks[b];
            if (!progressive_) {
              decode_sequential(br, c, blk);
            } else if (s.ss == 0) {
              if (s.ah == 0) {
                int v = br.decode(dc_[c.td]);
                if (v) v = extend(br.get(v), v);
                c.dc_pred = static_cast<int>(static_cast<unsigned>(c.dc_pred) + static_cast<unsigned>(v));
                blk[0] = static_cast<int16_t>(static_cast<unsigned>(c.dc_pred) << s.al);
              } else if (br.get(1)) {
                blk[0] = static_cast<int16_t>(blk[0] | (1 << s.al));
              }
            } else if (s.ah == 0) {
              ac_first(br, ac_[c.ta], blk, s, eobrun);
            } else {
              ac_refine(br, ac_[c.ta], blk, s, eobrun);
            }
          }
        }
        if (restart_interval_) restarts_to_go--;
      }
    }
    // the next marker: the one that stopped the data, else skip leftover bytes
    pos_ = br.pos;
    *after = br.marker ? br.marker : next_marker();
  }

  void decode_sequential(BitReader& br, Component& c, int16_t* blk) {
    int s = br.decode(dc_[c.td]);
    if (s) s = extend(br.get(s), s);
    c.dc_pred = static_cast<int>(static_cast<unsigned>(c.dc_pred) + static_cast<unsigned>(s));
    blk[0] = static_cast<int16_t>(c.dc_pred);
    const HuffTable& t = ac_[c.ta];
    for (int k = 1; k < 64; k++) {
      int v = br.decode(t);
      const int r = v >> 4;
      v &= 15;
      if (v) {
        k += r;
        v = extend(br.get(v), v);
        blk[kNatural[k]] = static_cast<int16_t>(v);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  static void ac_first(BitReader& br, const HuffTable& t, int16_t* blk, const Scan& s, int& eobrun) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    for (int k = s.ss; k <= s.se; k++) {
      int v = br.decode(t);
      int r = v >> 4;
      v &= 15;
      if (v) {
        k += r;
        v = extend(br.get(v), v);
        blk[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(v) << s.al);
      } else {
        if (r == 15) {
          k += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          eobrun--;
          break;
        }
      }
    }
  }

  static void ac_refine(BitReader& br, const HuffTable& t, int16_t* blk, const Scan& s, int& eobrun) {
    const int p1 = 1 << s.al;
    const int m1 = -1 * (1 << s.al);
    int k = s.ss;
    if (eobrun == 0) {
      for (; k <= s.se; k++) {
        int v = br.decode(t);
        int r = v >> 4;
        v &= 15;
        if (v) {
          v = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (br.get(1)) {
              if ((*coef & p1) == 0) *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
            }
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= s.se);
        if (v) blk[kNatural[k]] = static_cast<int16_t>(v);
      }
    }
    if (eobrun > 0) {
      for (; k <= s.se; k++) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) {
          if (br.get(1)) {
            if ((*coef & p1) == 0) *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
          }
        }
      }
      eobrun--;
    }
  }

  // jdhuff.c process_restart + jdmarker.c read_restart_marker / jpeg_resync_to_restart
  void restart(BitReader& br, int desired) {
    br.nbits = 0;
    br.acc = 0;
    if (!br.marker) {
      pos_ = br.pos;
      br.marker = next_marker();
      br.pos = pos_;
    }
    if (br.marker == 0xD0 + desired) {
      br.marker = 0;
    } else {
      for (;;) {
        const int m = br.marker;
        int action;
        if (m < 0xC0) {
          action = 2;
        } else if (m < 0xD0 || m > 0xD7) {
          action = 3;
        } else if (m == 0xD0 + ((desired + 1) & 7) || m == 0xD0 + ((desired + 2) & 7)) {
          action = 3;
        } else if (m == 0xD0 + ((desired - 1) & 7) || m == 0xD0 + ((desired - 2) & 7)) {
          action = 2;
        } else {
          action = 1;
        }
        if (action == 1) {
          br.marker = 0;
          break;
        }
        if (action == 3) break;
        pos_ = br.pos;
        br.marker = next_marker();
        br.pos = pos_;
      }
    }
    if (!br.marker) br.insufficient = false;
  }

  // ---- output ------------------------------------------------------------

  // jdcoefct.c smoothing_ok: a progressive image some of whose first nine AC
  // coefficients (zigzag) were left unrefined, with usable quantizers.
  bool smoothing_ok() const {
    if (!progressive_) return false;
    bool useful = false;
    static constexpr int kQ[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    for (int ci = 0; ci < ncomp_; ci++) {
      const Component& c = comp_[ci];
      if (!c.q_latched) return false;
      for (int i = 0; i < 10; i++)
        if (c.q[kQ[i]] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; k++)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  // the component's samples: (wib*8) x (hib*8), row stride wib*8
  std::vector<uint8_t> component_plane(Component& c, bool smooth) {
    const int stride = c.wib * 8;
    std::vector<uint8_t> plane(static_cast<size_t>(stride) * c.hib * 8);
    if (!c.q_latched) {  // in no scan: libjpeg's multiplier table stays zero (mid-grey)
      std::memset(c.q, 0, sizeof(c.q));
      c.q_latched = true;
    }
    if (!smooth) {
      for (int by = 0; by < c.hib; by++)
        for (int bx = 0; bx < c.wib; bx++)
          idct_islow(c.block(by, bx), c.q, &plane[static_cast<size_t>(by) * 8 * stride + bx * 8], stride);
    } else {
      smooth_component(c, plane.data(), stride);
    }
    return plane;
  }

  // jdcoefct.c decompress_smooth_data, iMCU row by iMCU row (its row
  // arithmetic included: the last iMCU row's block count sets its bounds).
  void smooth_component(Component& c, uint8_t* plane, int stride) {
    const int T = mcus_y_;
    const int* cb = c.coef_bits;
    const bool change_dc = cb[1] == -1 && cb[2] == -1 && cb[3] == -1 && cb[4] == -1 && cb[5] == -1 &&
                           cb[6] == -1 && cb[7] == -1 && cb[8] == -1 && cb[9] == -1;
    const int64_t Q00 = c.q[0], Q01 = c.q[1], Q10 = c.q[8], Q20 = c.q[16], Q11 = c.q[9], Q02 = c.q[2];
    const int64_t Q03 = change_dc ? c.q[3] : 0, Q12 = change_dc ? c.q[10] : 0,
                  Q21 = change_dc ? c.q[17] : 0, Q30 = change_dc ? c.q[24] : 0;
    const int last_col = c.wib - 1;
    int16_t ws[64];
    for (int r = 0; r < T; r++) {
      int block_rows;
      if (r < T - 1) {
        block_rows = c.v;
      } else {
        block_rows = c.hib % c.v;
        if (block_rows == 0) block_rows = c.v;
      }
      const int image_block_rows = block_rows * T;
      for (int br = 0; br < block_rows; br++) {
        const int ibr = r * block_rows + br;
        const int row = r * c.v + br;
        const int prev = ibr > 0 ? row - 1 : row;
        const int prev2 = ibr > 1 ? row - 2 : prev;
        const int next = ibr < image_block_rows - 1 ? row + 1 : row;
        const int next2 = ibr < image_block_rows - 2 ? row + 2 : next;
        const int rows[5] = {prev2, prev, row, next, next2};
        int DC[5][5];
        for (int i = 0; i < 5; i++) {
          const int v0 = c.block(rows[i], 0)[0];
          for (int j = 0; j < 5; j++) DC[i][j] = v0;
        }
        for (int bn = 0; bn <= last_col; bn++) {
          std::memcpy(ws, c.block(row, bn), sizeof(ws));
          if (bn == 0 && bn < last_col)
            for (int i = 0; i < 5; i++) DC[i][3] = DC[i][4] = c.block(rows[i], 1)[0];
          if (bn + 1 < last_col)
            for (int i = 0; i < 5; i++) DC[i][4] = c.block(rows[i], bn + 2)[0];
          // DC01..DC25 of jdcoefct.c, row by row
#define D(n) static_cast<int64_t>(DC[((n) - 1) / 5][((n) - 1) % 5])
          auto predict = [](int64_t num, int64_t Q, int Al) {
            int pred;
            if (num >= 0) {
              pred = static_cast<int>(((Q << 7) + num) / (Q << 8));
              if (Al > 0 && pred >= (1 << Al)) pred = (1 << Al) - 1;
            } else {
              pred = static_cast<int>(((Q << 7) - num) / (Q << 8));
              if (Al > 0 && pred >= (1 << Al)) pred = (1 << Al) - 1;
              pred = -pred;
            }
            return static_cast<int16_t>(pred);
          };
          int Al;
          if ((Al = cb[1]) != 0 && ws[1] == 0) {
            const int64_t num = Q00 * (change_dc
                ? (-D(1) - D(2) + D(4) + D(5) - 3 * D(6) + 13 * D(7) - 13 * D(9) + 3 * D(10) -
                   3 * D(11) + 38 * D(12) - 38 * D(14) + 3 * D(15) - 3 * D(16) + 13 * D(17) -
                   13 * D(19) + 3 * D(20) - D(21) - D(22) + D(24) + D(25))
                : (-7 * D(11) + 50 * D(12) - 50 * D(14) + 7 * D(15)));
            ws[1] = predict(num, Q01, Al);
          }
          if ((Al = cb[2]) != 0 && ws[8] == 0) {
            const int64_t num = Q00 * (change_dc
                ? (-D(1) - 3 * D(2) - 3 * D(3) - 3 * D(4) - D(5) - D(6) + 13 * D(7) + 38 * D(8) +
                   13 * D(9) - D(10) + D(16) - 13 * D(17) - 38 * D(18) - 13 * D(19) + D(20) +
                   D(21) + 3 * D(22) + 3 * D(23) + 3 * D(24) + D(25))
                : (-7 * D(3) + 50 * D(8) - 50 * D(18) + 7 * D(23)));
            ws[8] = predict(num, Q10, Al);
          }
          if ((Al = cb[3]) != 0 && ws[16] == 0) {
            const int64_t num = Q00 * (change_dc
                ? (D(3) + 2 * D(7) + 7 * D(8) + 2 * D(9) - 5 * D(12) - 14 * D(13) - 5 * D(14) +
                   2 * D(17) + 7 * D(18) + 2 * D(19) + D(23))
                : (-D(3) + 13 * D(8) - 24 * D(13) + 13 * D(18) - D(23)));
            ws[16] = predict(num, Q20, Al);
          }
          if ((Al = cb[4]) != 0 && ws[9] == 0) {
            const int64_t num = Q00 * (change_dc
                ? (-D(1) + D(5) + 9 * D(7) - 9 * D(9) - 9 * D(17) + 9 * D(19) + D(21) - D(25))
                : (D(10) + D(16) - 10 * D(17) + 10 * D(19) - D(2) - D(20) + D(22) - D(24) + D(4) -
                   D(6) + 10 * D(7) - 10 * D(9)));
            ws[9] = predict(num, Q11, Al);
          }
          if ((Al = cb[5]) != 0 && ws[2] == 0) {
            const int64_t num = Q00 * (change_dc
                ? (2 * D(7) - 5 * D(8) + 2 * D(9) + D(11) + 7 * D(12) - 14 * D(13) + 7 * D(14) +
                   D(15) + 2 * D(17) - 5 * D(18) + 2 * D(19))
                : (-D(11) + 13 * D(12) - 24 * D(13) + 13 * D(14) - D(15)));
            ws[2] = predict(num, Q02, Al);
          }
          if (change_dc) {
            if ((Al = cb[6]) != 0 && ws[3] == 0)
              ws[3] = predict(Q00 * (D(7) - D(9) + 2 * D(12) - 2 * D(14) + D(17) - D(19)), Q03, Al);
            if ((Al = cb[7]) != 0 && ws[10] == 0)
              ws[10] = predict(Q00 * (D(7) - 3 * D(8) + D(9) - D(17) + 3 * D(18) - D(19)), Q12, Al);
            if ((Al = cb[8]) != 0 && ws[17] == 0)
              ws[17] = predict(Q00 * (D(7) - D(9) - 3 * D(12) + 3 * D(14) + D(17) - D(19)), Q21, Al);
            if ((Al = cb[9]) != 0 && ws[24] == 0)
              ws[24] = predict(Q00 * (D(7) + 2 * D(8) + D(9) - D(17) - 2 * D(18) - D(19)), Q30, Al);
            const int64_t num = Q00 * (
                -2 * D(1) - 6 * D(2) - 8 * D(3) - 6 * D(4) - 2 * D(5) - 6 * D(6) + 6 * D(7) +
                42 * D(8) + 6 * D(9) - 6 * D(10) - 8 * D(11) + 42 * D(12) + 152 * D(13) +
                42 * D(14) - 8 * D(15) - 6 * D(16) + 6 * D(17) + 42 * D(18) + 6 * D(19) -
                6 * D(20) - 2 * D(21) - 6 * D(22) - 8 * D(23) - 6 * D(24) - 2 * D(25));
            ws[0] = predict(num, Q00, 0);
          }
#undef D
          idct_islow(ws, c.q, plane + static_cast<size_t>(row) * 8 * stride + bn * 8, stride);
          for (int i = 0; i < 5; i++)
            for (int j = 0; j < 4; j++) DC[i][j] = DC[i][j + 1];
        }
      }
    }
  }

  // jdsample.c: the component at full size (width_ x height_), reading only
  // its dw x dh samples, rows above and below the image replicated.
  std::vector<uint8_t> upsample(const Component& c, const std::vector<uint8_t>& plane) {
    const int W = width_, H = height_, stride = c.wib * 8;
    std::vector<uint8_t> out(static_cast<size_t>(W) * H);
    auto in_row = [&](int y) {
      y = std::min(std::max(y, 0), c.dh - 1);
      return plane.data() + static_cast<size_t>(y) * stride;
    };
    const bool h2 = 2 * c.h == hmax_, v2 = 2 * c.v == vmax_;
    const bool h1 = c.h == hmax_, v1 = c.v == vmax_;
    std::vector<uint8_t> row(2 * static_cast<size_t>(c.dw) + 2);
    if (h1 && v1) {
      for (int y = 0; y < H; y++) std::memcpy(&out[static_cast<size_t>(y) * W], in_row(y), W);
    } else if (h2 && v1 && c.dw > 2) {
      for (int y = 0; y < H; y++) {
        const uint8_t* ip = in_row(y);
        uint8_t* op = row.data();
        int inv = ip[0];
        *op++ = static_cast<uint8_t>(inv);
        *op++ = static_cast<uint8_t>((inv * 3 + ip[1] + 2) >> 2);
        for (int x = 1; x < c.dw - 1; x++) {
          inv = ip[x] * 3;
          *op++ = static_cast<uint8_t>((inv + ip[x - 1] + 1) >> 2);
          *op++ = static_cast<uint8_t>((inv + ip[x + 1] + 2) >> 2);
        }
        inv = ip[c.dw - 1];
        *op++ = static_cast<uint8_t>((inv * 3 + ip[c.dw - 2] + 1) >> 2);
        *op++ = static_cast<uint8_t>(inv);
        std::memcpy(&out[static_cast<size_t>(y) * W], row.data(), W);
      }
    } else if (h1 && v2) {
      for (int y = 0; y < H; y++) {
        const int iy = y >> 1;
        const uint8_t* p0 = in_row(iy);
        const uint8_t* p1 = (y & 1) ? in_row(iy + 1) : in_row(iy - 1);
        const int bias = (y & 1) ? 2 : 1;
        uint8_t* op = &out[static_cast<size_t>(y) * W];
        for (int x = 0; x < W; x++) op[x] = static_cast<uint8_t>((p0[x] * 3 + p1[x] + bias) >> 2);
      }
    } else if (h2 && v2 && c.dw > 2) {
      for (int y = 0; y < H; y++) {
        const int iy = y >> 1;
        const uint8_t* p0 = in_row(iy);
        const uint8_t* p1 = (y & 1) ? in_row(iy + 1) : in_row(iy - 1);
        uint8_t* op = row.data();
        int this_sum = p0[0] * 3 + p1[0];
        int next_sum = p0[1] * 3 + p1[1];
        *op++ = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
        *op++ = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
        int last_sum = this_sum;
        this_sum = next_sum;
        for (int x = 2; x < c.dw; x++) {
          next_sum = p0[x] * 3 + p1[x];
          *op++ = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
          *op++ = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
          last_sum = this_sum;
          this_sum = next_sum;
        }
        *op++ = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
        *op++ = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
        std::memcpy(&out[static_cast<size_t>(y) * W], row.data(), W);
      }
    } else if (hmax_ % c.h == 0 && vmax_ % c.v == 0) {
      // h2v1 / h2v2 without fancy upsampling, and every other integral ratio
      const int fx = hmax_ / c.h, fy = vmax_ / c.v;
      for (int y = 0; y < H; y++) {
        const uint8_t* ip = in_row(y / fy);
        uint8_t* op = &out[static_cast<size_t>(y) * W];
        for (int x = 0; x < W; x++) op[x] = ip[x / fx];
      }
    } else {
      fail("unsupported JPEG: fractional sampling factors");
    }
    return out;
  }

  std::vector<uint8_t> output() {
    const bool smooth = smoothing_ok();
    const size_t npix = static_cast<size_t>(width_) * height_;
    std::vector<std::vector<uint8_t>> ch(ncomp_);
    for (int i = 0; i < ncomp_; i++) ch[i] = upsample(comp_[i], component_plane(comp_[i], smooth));
    std::vector<uint8_t> rgb(npix * 3);
    if (ncomp_ == 1) {
      const uint8_t* g = ch[0].data();
      for (size_t i = 0; i < npix; i++) rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = g[i];
      return rgb;
    }
    // jdapimin.c default_decompress_parms
    bool ycc;
    if (ncomp_ == 3) {
      if (jfif_) {
        ycc = true;
      } else if (adobe_) {
        ycc = adobe_transform_ != 0;
      } else {
        ycc = !(comp_[0].id == 'R' && comp_[1].id == 'G' && comp_[2].id == 'B');
      }
    } else {
      ycc = adobe_ && adobe_transform_ != 0;  // YCCK, else CMYK
    }
    const uint8_t *c0 = ch[0].data(), *c1 = ch[1].data(), *c2 = ch[2].data();
    for (size_t i = 0; i < npix; i++) {
      int r, g, b;
      if (ycc) {
        const int y = c0[i], cb = c1[i], cr = c2[i];
        r = y + kColor.cr_r[cr];
        g = y + static_cast<int>((kColor.cb_g[cb] + kColor.cr_g[cr]) >> 16);
        b = y + kColor.cb_b[cb];
      } else {
        r = c0[i];
        g = c1[i];
        b = c2[i];
      }
      if (ncomp_ == 3) {
        rgb[3 * i] = clamp255(r);
        rgb[3 * i + 1] = clamp255(g);
        rgb[3 * i + 2] = clamp255(b);
        continue;
      }
      // libjpeg's CMYK (YCCK: 255 - the RGB above), Pillow's "CMYK;I"
      // inversion, then Convert.c cmyk2rgb
      int cmy[3];
      if (ycc) {
        cmy[0] = 255 - clamp255(255 - r);
        cmy[1] = 255 - clamp255(255 - g);
        cmy[2] = 255 - clamp255(255 - b);
      } else {
        cmy[0] = 255 - r;
        cmy[1] = 255 - g;
        cmy[2] = 255 - b;
      }
      const int nk = ch[3][i];  // 255 - (255 - K)
      for (int j = 0; j < 3; j++) {
        const int tmp = cmy[j] * nk + 128;
        rgb[3 * i + j] = clamp255(nk - (((tmp >> 8) + tmp) >> 8));
      }
    }
    return rgb;
  }
};

// ---- Pillow's resize (Resample.c) -----------------------------------------

constexpr int kPrecision = 32 - 8 - 2;

double bicubic(double x) {
  constexpr double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

struct Coeffs {
  int ksize = 0;
  std::vector<int> bounds;  // xmin, count per output
  std::vector<int32_t> k;
};

Coeffs precompute(int in_size, int out_size) {
  const float in0 = 0.0f, in1 = static_cast<float>(in_size);
  const double scale = static_cast<double>(in1 - in0) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 2.0 * filterscale;
  Coeffs c;
  c.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  c.bounds.resize(2 * static_cast<size_t>(out_size));
  c.k.assign(static_cast<size_t>(out_size) * c.ksize, 0);
  std::vector<double> kk(c.ksize);
  for (int xx = 0; xx < out_size; xx++) {
    const double center = in0 + (xx + 0.5) * scale;
    double ww = 0.0;
    const double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    for (int x = 0; x < xmax; x++) {
      const double w = bicubic((x + xmin - center + 0.5) * ss);
      kk[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; x++)
      if (ww != 0.0) kk[x] /= ww;
    int32_t* k = &c.k[static_cast<size_t>(xx) * c.ksize];
    for (int x = 0; x < xmax; x++)
      k[x] = kk[x] < 0 ? static_cast<int32_t>(-0.5 + kk[x] * (1 << kPrecision))
                       : static_cast<int32_t>(0.5 + kk[x] * (1 << kPrecision));
    c.bounds[2 * xx] = xmin;
    c.bounds[2 * xx + 1] = xmax;
  }
  return c;
}

inline uint8_t clip8(int v) {
  const int s = v >> kPrecision;
  return static_cast<uint8_t>(s < 0 ? 0 : (s > 255 ? 255 : s));
}

// Image.resize((ow, oh)) of an RGB image, resample BICUBIC, no box, no reducing_gap.
void resize_rgb(const uint8_t* in, int w, int h, uint8_t* out, int ow, int oh) {
  if (w == ow && h == oh) {
    std::memcpy(out, in, static_cast<size_t>(w) * h * 3);
    return;
  }
  std::vector<uint8_t> tmp;
  const uint8_t* src = in;
  int src_w = w, row0 = 0;
  const Coeffs cv = precompute(h, oh);
  if (ow != w) {
    const Coeffs ch = precompute(w, ow);
    const int first = cv.bounds[0];
    const int last = cv.bounds[2 * (oh - 1)] + cv.bounds[2 * (oh - 1) + 1];
    tmp.resize(static_cast<size_t>(last - first) * ow * 3);
    for (int y = first; y < last; y++) {
      const uint8_t* ip = in + static_cast<size_t>(y) * w * 3;
      uint8_t* op = &tmp[static_cast<size_t>(y - first) * ow * 3];
      for (int xx = 0; xx < ow; xx++) {
        const int xmin = ch.bounds[2 * xx], xmax = ch.bounds[2 * xx + 1];
        const int32_t* k = &ch.k[static_cast<size_t>(xx) * ch.ksize];
        int s0 = 1 << (kPrecision - 1), s1 = s0, s2 = s0;
        for (int x = 0; x < xmax; x++) {
          const uint8_t* p = ip + (x + xmin) * 3;
          s0 += p[0] * k[x];
          s1 += p[1] * k[x];
          s2 += p[2] * k[x];
        }
        op[3 * xx] = clip8(s0);
        op[3 * xx + 1] = clip8(s1);
        op[3 * xx + 2] = clip8(s2);
      }
    }
    src = tmp.data();
    src_w = ow;
    row0 = first;
  }
  if (oh == h) {
    std::memcpy(out, src, static_cast<size_t>(ow) * oh * 3);
    return;
  }
  for (int yy = 0; yy < oh; yy++) {
    const int ymin = cv.bounds[2 * yy] - row0, ymax = cv.bounds[2 * yy + 1];
    const int32_t* k = &cv.k[static_cast<size_t>(yy) * cv.ksize];
    uint8_t* op = out + static_cast<size_t>(yy) * ow * 3;
    for (int xx = 0; xx < ow * 3; xx++) {
      int s = 1 << (kPrecision - 1);
      for (int y = 0; y < ymax; y++) s += src[static_cast<size_t>(y + ymin) * src_w * 3 + xx] * k[y];
      op[xx] = clip8(s);
    }
  }
}

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
}

bool read_file(const char* path, std::vector<uint8_t>* data, std::string* msg) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    *msg = "cannot open file";
    return false;
  }
  data->clear();
  uint8_t buf[1 << 16];
  size_t got;
  while ((got = std::fread(buf, 1, sizeof(buf), f)) > 0) data->insert(data->end(), buf, buf + got);
  const bool ok = !std::ferror(f);
  std::fclose(f);
  if (!ok) *msg = "read error";
  return ok;
}

}  // namespace

extern "C" {

// Decode a JPEG held in memory into RGB as Pillow's open(...).convert("RGB").
// Returns 0 and a malloc'd width*height*3 buffer (free it with ssp_image_free),
// or -1 with the reason in err.
int ssp_jpeg_decode_rgb(const uint8_t* data, int64_t len, uint8_t** out, int* width, int* height,
                        char* err, int errlen) {
  try {
    Jpeg j(data, static_cast<size_t>(len));
    std::vector<uint8_t> rgb = j.decode_rgb(width, height);
    *out = static_cast<uint8_t*>(std::malloc(rgb.size()));
    if (!*out) {
      set_error(err, errlen, "out of memory");
      return -1;
    }
    std::memcpy(*out, rgb.data(), rgb.size());
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

void ssp_image_free(void* p) { std::free(p); }

// Pillow's resize((ow, oh)) with BICUBIC of a w x h RGB uint8 image.
void ssp_resize_rgb(const uint8_t* in, int w, int h, uint8_t* out, int ow, int oh) {
  resize_rgb(in, w, h, out, ow, oh);
}

// Decode each JPEG file paths[i] and resize it to res x res into image
// slots[i] of out ([*, res, res, 3] uint8), with `threads` threads. Returns -1
// when every file was read, else the index i of the first file that failed,
// with the reason in err.
int64_t ssp_decode_resize_many(const char* const* paths, const int64_t* slots, int64_t n, int res,
                               uint8_t* out, int threads, char* err, int errlen) {
  std::atomic<int64_t> next{0};
  std::atomic<int64_t> failed{-1};
  std::mutex mu;
  std::string first_msg;
  auto work = [&]() {
    std::vector<uint8_t> data;
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= n || failed.load() >= 0) return;
      std::string msg;
      try {
        if (!read_file(paths[i], &data, &msg)) throw DecodeError(msg);
        Jpeg j(data.data(), data.size());
        int w = 0, h = 0;
        std::vector<uint8_t> rgb = j.decode_rgb(&w, &h);
        resize_rgb(rgb.data(), w, h, out + static_cast<size_t>(slots[i]) * res * res * 3, res, res);
        continue;
      } catch (const std::exception& e) {
        msg = e.what();
      } catch (...) {
        msg = "unknown error";
      }
      std::lock_guard<std::mutex> lock(mu);
      const int64_t prev = failed.load();
      if (prev < 0 || i < prev) {
        failed.store(i);
        first_msg = msg;
      }
    }
  };
  threads = std::max(1, std::min<int>(threads, static_cast<int>(std::max<int64_t>(n, 1))));
  std::vector<std::thread> pool;
  for (int t = 1; t < threads; t++) pool.emplace_back(work);
  work();
  for (auto& t : pool) t.join();
  if (failed.load() >= 0) set_error(err, errlen, first_msg);
  return failed.load();
}

}  // extern "C"
