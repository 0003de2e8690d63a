// The serial stages of the port's image codec (utils/image_io.py), with a
// plain C ABI bound through ctypes:
//
//   * PNG: unfiltering (all five filter types) and filtering (one type for
//     every row, or libpng's adaptive choice: the least sum of absolute
//     signed bytes);
//   * baseline JPEG decoding of one interleaved scan: Huffman decoding with
//     restart markers and byte stuffing, the ISLOW integer IDCT of
//     libjpeg's jidctint.c, the "fancy" triangle upsampling of jdsample.c
//     (h2v1, h1v2, h2v2; box replication for other ratios) and the
//     fixed-point YCbCr -> RGB tables of jdcolor.c, so that a decoded image
//     equals libjpeg's (and so cv2.imdecode's) bit for bit;
//   * baseline JPEG encoding: the fixed-point RGB -> YCbCr of jccolor.c,
//     the h2v1/h2v2 box downsampling of jcsample.c with its alternating
//     bias, the ISLOW integer FDCT of jfdctint.c, libjpeg's rounding
//     quantizer and Huffman coding with byte stuffing.
//
// The marker segments (tables, frame and scan headers) are read and written
// by the Python side.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // a run past the end of a corrupt block lands here, harmlessly
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ------------------------------------------------------------------ PNG
inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

void filter_row(int ftype, const uint8_t* cur, const uint8_t* prev,
                uint8_t* out, int stride, int bpp) {
  // one loop per type: the type's test stays out of the byte loop
  const int lead = bpp < stride ? bpp : stride;
  switch (ftype) {
    case 0:
      std::memcpy(out, cur, stride);
      break;
    case 1:
      std::memcpy(out, cur, lead);
      for (int i = bpp; i < stride; ++i) out[i] = uint8_t(cur[i] - cur[i - bpp]);
      break;
    case 2:
      if (!prev) {
        std::memcpy(out, cur, stride);
        break;
      }
      for (int i = 0; i < stride; ++i) out[i] = uint8_t(cur[i] - prev[i]);
      break;
    case 3:
      for (int i = 0; i < lead; ++i)
        out[i] = uint8_t(cur[i] - ((prev ? prev[i] : 0) >> 1));
      for (int i = bpp; i < stride; ++i)
        out[i] = uint8_t(cur[i] - ((cur[i - bpp] + (prev ? prev[i] : 0)) >> 1));
      break;
    default:
      for (int i = 0; i < lead; ++i) out[i] = uint8_t(cur[i] - (prev ? prev[i] : 0));
      if (!prev) {
        for (int i = bpp; i < stride; ++i)
          out[i] = uint8_t(cur[i] - cur[i - bpp]);
        break;
      }
      for (int i = bpp; i < stride; ++i)
        out[i] = uint8_t(cur[i] - paeth(cur[i - bpp], prev[i], prev[i - bpp]));
      break;
  }
}

// ---------------------------------------------------------- JPEG tables
const int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
              FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
              FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
              FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
              FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;
const int CONST_BITS = 13, PASS1_BITS = 2;

inline int32_t descale(int64_t x, int n) {
  return static_cast<int32_t>((x + (int64_t(1) << (n - 1))) >> n);
}

// libjpeg's post-IDCT range limit: the masked index wraps, as in
// prepare_range_limit_table (only corrupt data reaches the wrap)
inline uint8_t idct_limit(int32_t x) {
  int v = x & 1023;
  if (v < 128) return static_cast<uint8_t>(v + 128);
  if (v < 512) return 255;
  if (v < 896) return 0;
  return static_cast<uint8_t>(v - 896);
}

// One 1-D pass of jidctint.c's jpeg_idct_islow on x[0..7]: the eight sums
// before their descale, in output order.
void idct_1d(const int64_t* x, int64_t* out) {
  int64_t z1 = (x[2] + x[6]) * FIX_0_541196100;
  int64_t tmp2 = z1 + x[6] * -FIX_1_847759065;
  int64_t tmp3 = z1 + x[2] * FIX_0_765366865;
  int64_t tmp0 = (x[0] + x[4]) * (1 << CONST_BITS);
  int64_t tmp1 = (x[0] - x[4]) * (1 << CONST_BITS);
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  tmp0 = x[7];
  tmp1 = x[5];
  tmp2 = x[3];
  tmp3 = x[1];
  z1 = tmp0 + tmp3;
  int64_t z2 = tmp1 + tmp2, z3 = tmp0 + tmp2, z4 = tmp1 + tmp3;
  int64_t z5 = (z3 + z4) * FIX_1_175875602;
  tmp0 *= FIX_0_298631336;
  tmp1 *= FIX_2_053119869;
  tmp2 *= FIX_3_072711026;
  tmp3 *= FIX_1_501321110;
  z1 *= -FIX_0_899976223;
  z2 *= -FIX_2_562915447;
  z3 *= -FIX_1_961570560;
  z4 *= -FIX_0_390180644;
  z3 += z5;
  z4 += z5;
  tmp0 += z1 + z3;
  tmp1 += z2 + z4;
  tmp2 += z2 + z3;
  tmp3 += z1 + z4;
  out[0] = tmp10 + tmp3;
  out[7] = tmp10 - tmp3;
  out[1] = tmp11 + tmp2;
  out[6] = tmp11 - tmp2;
  out[2] = tmp12 + tmp1;
  out[5] = tmp12 - tmp1;
  out[3] = tmp13 + tmp0;
  out[4] = tmp13 - tmp0;
}

// jidctint.c jpeg_idct_islow: coef (natural order) * quant -> 8x8 samples,
// columns first, with its shortcuts for columns and rows without AC terms
void idct_islow(const int16_t* coef, const uint16_t* quant, uint8_t* out,
                int out_stride) {
  int32_t ws[64];
  int64_t x[8], y[8];
  for (int col = 0; col < 8; ++col) {
    bool dc_only = true;
    for (int k = 0; k < 8; ++k) {
      x[k] = int64_t(coef[8 * k + col]) * quant[8 * k + col];
      dc_only = dc_only && (k == 0 || coef[8 * k + col] == 0);
    }
    if (dc_only) {
      for (int k = 0; k < 8; ++k)
        ws[8 * k + col] = static_cast<int32_t>(x[0] * (1 << PASS1_BITS));
      continue;
    }
    idct_1d(x, y);
    for (int k = 0; k < 8; ++k)
      ws[8 * k + col] = descale(y[k], CONST_BITS - PASS1_BITS);
  }
  for (int row = 0; row < 8; ++row) {
    const int32_t* w = ws + 8 * row;
    uint8_t* o = out + row * out_stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
        w[6] == 0 && w[7] == 0) {
      uint8_t v = idct_limit(descale(w[0], PASS1_BITS + 3));
      for (int k = 0; k < 8; ++k) o[k] = v;
      continue;
    }
    for (int k = 0; k < 8; ++k) x[k] = w[k];
    idct_1d(x, y);
    for (int k = 0; k < 8; ++k)
      o[k] = idct_limit(descale(y[k], CONST_BITS + PASS1_BITS + 3));
  }
}

// jfdctint.c jpeg_fdct_islow, in place on (sample - 128); the output is
// scaled up by 8, as libjpeg's
void fdct_islow(int32_t* d) {
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass == 0 ? 1 : 8, next = pass == 0 ? 8 : 1;
    for (int r = 0; r < 8; ++r) {
      int32_t* p = d + r * next;
      int64_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      int64_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      int64_t tmp2 = p[2 * step] + p[5 * step];
      int64_t tmp5 = p[2 * step] - p[5 * step];
      int64_t tmp3 = p[3 * step] + p[4 * step];
      int64_t tmp4 = p[3 * step] - p[4 * step];
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
      if (pass == 0) {
        p[0] = static_cast<int32_t>((tmp10 + tmp11) * (1 << PASS1_BITS));
        p[4 * step] =
            static_cast<int32_t>((tmp10 - tmp11) * (1 << PASS1_BITS));
        p[2 * step] = descale(z1 + tmp13 * FIX_0_765366865,
                              CONST_BITS - PASS1_BITS);
        p[6 * step] = descale(z1 + tmp12 * -FIX_1_847759065,
                              CONST_BITS - PASS1_BITS);
      } else {
        p[0] = descale(tmp10 + tmp11, PASS1_BITS);
        p[4 * step] = descale(tmp10 - tmp11, PASS1_BITS);
        p[2 * step] = descale(z1 + tmp13 * FIX_0_765366865,
                              CONST_BITS + PASS1_BITS);
        p[6 * step] = descale(z1 + tmp12 * -FIX_1_847759065,
                              CONST_BITS + PASS1_BITS);
      }
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * FIX_1_175875602;
      tmp4 *= FIX_0_298631336;
      tmp5 *= FIX_2_053119869;
      tmp6 *= FIX_3_072711026;
      tmp7 *= FIX_1_501321110;
      z1 *= -FIX_0_899976223;
      z2 *= -FIX_2_562915447;
      z3 *= -FIX_1_961570560;
      z4 *= -FIX_0_390180644;
      z3 += z5;
      z4 += z5;
      const int n = pass == 0 ? CONST_BITS - PASS1_BITS
                              : CONST_BITS + PASS1_BITS;
      p[7 * step] = descale(tmp4 + z1 + z3, n);
      p[5 * step] = descale(tmp5 + z2 + z4, n);
      p[3 * step] = descale(tmp6 + z2 + z3, n);
      p[step] = descale(tmp7 + z1 + z4, n);
    }
  }
}

// ------------------------------------------------------ Huffman decoding
struct DecodeTable {
  // indexed by the next 16 bits: (code length << 8) | symbol; 0 = no code
  std::vector<uint16_t> lut;
  bool build(const uint8_t* bits, const uint8_t* vals) {
    lut.assign(65536, 0);
    int code = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < bits[len - 1]; ++i, ++k) {
        if (code >= (1 << len)) return false;
        int lo = code << (16 - len), n = 1 << (16 - len);
        for (int j = 0; j < n; ++j)
          lut[lo + j] = static_cast<uint16_t>((len << 8) | vals[k]);
        ++code;
      }
      code <<= 1;
    }
    return true;
  }
};

struct BitReader {
  const uint8_t* data;
  int64_t n, pos = 0;
  uint64_t buf = 0;
  int cnt = 0;
  bool marker = false;
  void fill() {
    while (cnt <= 56) {
      uint32_t b = 0;
      if (!marker && pos < n) {
        b = data[pos];
        if (b == 0xFF) {
          uint8_t nx = pos + 1 < n ? data[pos + 1] : 0xD9;
          if (nx == 0x00) {
            pos += 2;
          } else {
            marker = true;  // a marker ends the data: feed zeros
            b = 0;
          }
        } else {
          ++pos;
        }
      }
      buf |= uint64_t(b) << (56 - cnt);
      cnt += 8;
    }
  }
  uint32_t peek16() {
    if (cnt < 16) fill();
    return static_cast<uint32_t>(buf >> 48);
  }
  void skip(int k) { buf <<= k; cnt -= k; }
  uint32_t bits(int k) {
    if (k == 0) return 0;
    if (cnt < k) fill();
    uint32_t v = static_cast<uint32_t>(buf >> (64 - k));
    skip(k);
    return v;
  }
  // a restart: drop the partial byte, then step over the next RSTn marker
  bool restart() {
    buf = 0;
    cnt = 0;
    marker = false;
    while (pos + 1 < n &&
           !(data[pos] == 0xFF && data[pos + 1] >= 0xD0 &&
             data[pos + 1] <= 0xD7))
      ++pos;
    if (pos + 1 >= n) return false;
    pos += 2;
    return true;
  }
};

inline int decode_symbol(BitReader& br, const DecodeTable& t, bool* bad) {
  uint16_t e = t.lut[br.peek16()];
  if (e == 0) {
    *bad = true;
    return 0;
  }
  br.skip(e >> 8);
  return e & 0xFF;
}

inline int extend(uint32_t v, int s) {
  return v < (1u << (s - 1)) ? int(v) - (1 << s) + 1 : int(v);
}

// ------------------------------------------------- upsampling (jdsample.c)
// plane: the component's decoded samples (pw per row, at least dw x dh of
// them valid); out: the full-size component, ow x oh
void upsample(const uint8_t* plane, int pw, int dw, int dh, int hr, int vr,
              uint8_t* out, int ow, int oh) {
  auto at = [&](int r, int c) -> int { return plane[r * pw + c]; };
  if (hr == 1 && vr == 1) {
    for (int y = 0; y < oh; ++y) std::memcpy(out + y * ow, plane + y * pw, ow);
  } else if (hr == 2 && vr == 1 && dw > 2) {  // h2v1_fancy_upsample
    for (int y = 0; y < oh; ++y) {
      uint8_t* o = out + y * ow;
      for (int c = 0; c < dw; ++c) {
        int v = at(y, c), x = 2 * c;
        int left = c == 0 ? v : (v * 3 + at(y, c - 1) + 1) >> 2;
        int right = c == dw - 1 ? v : (v * 3 + at(y, c + 1) + 2) >> 2;
        if (x < ow) o[x] = static_cast<uint8_t>(left);
        if (x + 1 < ow) o[x + 1] = static_cast<uint8_t>(right);
      }
    }
  } else if (hr == 1 && vr == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < oh; ++y) {
      int r = y >> 1, nr = (y & 1) ? r + 1 : r - 1, bias = (y & 1) ? 2 : 1;
      nr = nr < 0 ? 0 : (nr > dh - 1 ? dh - 1 : nr);
      for (int x = 0; x < ow; ++x)
        out[y * ow + x] =
            static_cast<uint8_t>((at(r, x) * 3 + at(nr, x) + bias) >> 2);
    }
  } else if (hr == 2 && vr == 2 && dw > 2) {  // h2v2_fancy_upsample
    std::vector<int> sum(dw);
    for (int y = 0; y < oh; ++y) {
      int r = y >> 1, nr = (y & 1) ? r + 1 : r - 1;
      nr = nr < 0 ? 0 : (nr > dh - 1 ? dh - 1 : nr);
      for (int c = 0; c < dw; ++c) sum[c] = at(r, c) * 3 + at(nr, c);
      uint8_t* o = out + y * ow;
      for (int c = 0; c < dw; ++c) {
        int x = 2 * c, s = sum[c];
        int left = c == 0 ? (s * 4 + 8) >> 4 : (s * 3 + sum[c - 1] + 8) >> 4;
        int right = c == dw - 1 ? (s * 4 + 7) >> 4
                                : (s * 3 + sum[c + 1] + 7) >> 4;
        if (x < ow) o[x] = static_cast<uint8_t>(left);
        if (x + 1 < ow) o[x + 1] = static_cast<uint8_t>(right);
      }
    }
  } else {  // box replication (h2v1_upsample, h2v2_upsample, int_upsample)
    for (int y = 0; y < oh; ++y)
      for (int x = 0; x < ow; ++x)
        out[y * ow + x] = plane[(y / vr) * pw + x / hr];
  }
}

// ----------------------------------------------------- Huffman encoding
struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t buf = 0;
  int cnt = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t code, int len) {
    if (len == 0) return;
    buf = (buf << len) | (code & ((1u << len) - 1));
    cnt += len;
    while (cnt >= 8) {
      uint8_t b = static_cast<uint8_t>(buf >> (cnt - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0x00);
      cnt -= 8;
    }
  }
  void flush() {  // pad the last byte with 1-bits
    if (cnt > 0) put((1u << (8 - cnt)) - 1, 8 - cnt);
  }
};

struct EncodeTable {
  uint16_t code[256];
  uint8_t size[256];
  void build(const uint8_t* bits, const uint8_t* vals) {
    std::memset(size, 0, sizeof(size));
    int c = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < bits[len - 1]; ++i, ++k) {
        code[vals[k]] = static_cast<uint16_t>(c++);
        size[vals[k]] = static_cast<uint8_t>(len);
      }
      c <<= 1;
    }
  }
};

inline int nbits(int v) {
  int a = v < 0 ? -v : v, n = 0;
  while (a) {
    ++n;
    a >>= 1;
  }
  return n;
}

void encode_block(BitWriter& bw, const int16_t* q, int* pred,
                  const EncodeTable& dc, const EncodeTable& ac) {
  int diff = q[0] - *pred;
  *pred = q[0];
  int s = nbits(diff);
  bw.put(dc.code[s], dc.size[s]);
  bw.put(diff < 0 ? diff - 1 : diff, s);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = q[kNatural[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    s = nbits(v);
    int sym = (run << 4) | s;
    bw.put(ac.code[sym], ac.size[sym]);
    bw.put(v < 0 ? v - 1 : v, s);
    run = 0;
  }
  if (run > 0) bw.put(ac.code[0], ac.size[0]);
}

}  // namespace

extern "C" {

// raw: h rows of (filter byte, stride bytes); out: h * stride. Returns 0,
// or -(row + 1) at the first row whose filter type is not 0..4.
int png_unfilter(const uint8_t* raw, uint8_t* out, int h, int stride,
                 int bpp) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* in = raw + int64_t(y) * (stride + 1);
    int ftype = in[0];
    ++in;
    uint8_t* o = out + int64_t(y) * stride;
    const uint8_t* p = y > 0 ? o - stride : nullptr;
    switch (ftype) {
      case 0:
        std::memcpy(o, in, stride);
        break;
      case 1:
        for (int i = 0; i < stride; ++i)
          o[i] = static_cast<uint8_t>(in[i] + (i >= bpp ? o[i - bpp] : 0));
        break;
      case 2:
        for (int i = 0; i < stride; ++i)
          o[i] = static_cast<uint8_t>(in[i] + (p ? p[i] : 0));
        break;
      case 3:
        for (int i = 0; i < stride; ++i) {
          int a = i >= bpp ? o[i - bpp] : 0, b = p ? p[i] : 0;
          o[i] = static_cast<uint8_t>(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int i = 0; i < stride; ++i) {
          int a = i >= bpp ? o[i - bpp] : 0, b = p ? p[i] : 0;
          int c = (p && i >= bpp) ? p[i - bpp] : 0;
          o[i] = static_cast<uint8_t>(in[i] + paeth(a, b, c));
        }
        break;
      default:
        return -(y + 1);
    }
  }
  return 0;
}

// img: h * stride bytes; raw: h * (stride + 1). mode 0..4 filters every
// row with that type; 5 picks per row the type of the least sum of
// absolute signed bytes (libpng's heuristic).
void png_filter(const uint8_t* img, uint8_t* raw, int h, int stride, int bpp,
                int mode) {
  std::vector<uint8_t> trial(stride);
  for (int y = 0; y < h; ++y) {
    const uint8_t* cur = img + int64_t(y) * stride;
    const uint8_t* prev = y > 0 ? cur - stride : nullptr;
    uint8_t* o = raw + int64_t(y) * (stride + 1);
    int best = mode;
    if (mode == 5) {
      int64_t best_sum = -1;
      for (int f = 0; f < 5; ++f) {
        filter_row(f, cur, prev, trial.data(), stride, bpp);
        int64_t s = 0;
        for (int i = 0; i < stride; ++i) s += std::abs(int8_t(trial[i]));
        if (best_sum < 0 || s < best_sum) {
          best_sum = s;
          best = f;
        }
      }
    }
    o[0] = static_cast<uint8_t>(best);
    filter_row(best, cur, prev, o + 1, stride, bpp);
  }
}

// One interleaved baseline scan -> out (h * w * ncomp bytes; RGB when
// ncomp == 3 and `ycc`, else the components as stored).
//   hs, vs: sampling factors; qt: ncomp x 64 quantizers in natural order;
//   td, ta: DC/AC table slots; bits: 8 x 16 (DC0..3, AC0..3), vals: 8 x 256.
// Returns 0; -1 bad Huffman table, -2 bad code in the data, -3 missing
// restart marker, -4 unsupported sampling.
int jpeg_decode(const uint8_t* data, int64_t n, int w, int h, int ncomp,
                const int* hs, const int* vs, const uint16_t* qt,
                const int* td, const int* ta, const uint8_t* bits,
                const uint8_t* vals, int restart_interval, int ycc,
                uint8_t* out) {
  if (ncomp < 1 || ncomp > 4) return -4;
  int hmax = 1, vmax = 1;
  for (int c = 0; c < ncomp; ++c) {
    if (hs[c] < 1 || hs[c] > 4 || vs[c] < 1 || vs[c] > 4) return -4;
    hmax = hs[c] > hmax ? hs[c] : hmax;
    vmax = vs[c] > vmax ? vs[c] : vmax;
  }
  for (int c = 0; c < ncomp; ++c)
    if (hmax % hs[c] || vmax % vs[c]) return -4;
  DecodeTable tables[8];
  bool have[8] = {false};
  for (int c = 0; c < ncomp; ++c) {
    for (int slot : {td[c], 4 + ta[c]}) {
      if (slot < 0 || slot > 7) return -1;
      if (!have[slot]) {
        if (!tables[slot].build(bits + 16 * slot, vals + 256 * slot))
          return -1;
        have[slot] = true;
      }
    }
  }
  // a single-component scan is not interleaved: its MCU is one block
  int mh = ncomp == 1 ? 1 : hs[0], mv = ncomp == 1 ? 1 : vs[0];
  int mcu_w = ncomp == 1 ? 8 : 8 * hmax, mcu_h = ncomp == 1 ? 8 : 8 * vmax;
  int mx = (w + mcu_w - 1) / mcu_w, my = (h + mcu_h - 1) / mcu_h;
  std::vector<std::vector<uint8_t>> planes(ncomp);
  std::vector<int> pw(ncomp), ph(ncomp), bh(ncomp), bv(ncomp);
  for (int c = 0; c < ncomp; ++c) {
    bh[c] = ncomp == 1 ? mh : hs[c];
    bv[c] = ncomp == 1 ? mv : vs[c];
    pw[c] = mx * bh[c] * 8;
    ph[c] = my * bv[c] * 8;
    planes[c].assign(size_t(pw[c]) * ph[c], 0);
  }
  BitReader br;
  br.data = data;
  br.n = n;
  std::vector<int> pred(ncomp, 0);
  int16_t coef[64];
  bool bad = false;
  int64_t mcus = int64_t(mx) * my, left = restart_interval;
  for (int64_t m = 0; m < mcus; ++m) {
    if (restart_interval > 0) {
      if (left == 0) {
        if (!br.restart()) return -3;
        std::fill(pred.begin(), pred.end(), 0);
        left = restart_interval;
      }
      --left;
    }
    int ux = int(m % mx), uy = int(m / mx);
    for (int c = 0; c < ncomp; ++c) {
      const DecodeTable& dct = tables[td[c]];
      const DecodeTable& act = tables[4 + ta[c]];
      for (int by = 0; by < bv[c]; ++by)
        for (int bx = 0; bx < bh[c]; ++bx) {
          std::memset(coef, 0, sizeof(coef));
          int s = decode_symbol(br, dct, &bad);
          if (s) pred[c] += extend(br.bits(s), s);
          coef[0] = static_cast<int16_t>(pred[c]);
          for (int k = 1; k < 64; ++k) {
            int rs = decode_symbol(br, act, &bad);
            int r = rs >> 4;
            s = rs & 15;
            if (s) {
              k += r;
              coef[kNatural[k]] = static_cast<int16_t>(extend(br.bits(s), s));
            } else if (r == 15) {
              k += 15;
            } else {
              break;
            }
          }
          if (bad) return -2;
          int x0 = (ux * bh[c] + bx) * 8, y0 = (uy * bv[c] + by) * 8;
          idct_islow(coef, qt + 64 * c,
                     planes[c].data() + size_t(y0) * pw[c] + x0, pw[c]);
        }
    }
  }
  // upsample every component to the full size, then convert
  size_t npix = size_t(w) * h;
  std::vector<uint8_t> full(npix * ncomp);
  for (int c = 0; c < ncomp; ++c) {
    int hr = ncomp == 1 ? 1 : hmax / hs[c], vr = ncomp == 1 ? 1 : vmax / vs[c];
    int dw = ncomp == 1 ? w : (w * hs[c] + hmax - 1) / hmax;
    int dh = ncomp == 1 ? h : (h * vs[c] + vmax - 1) / vmax;
    upsample(planes[c].data(), pw[c], dw, dh, hr, vr,
             full.data() + npix * c, w, h);
  }
  if (ncomp == 3 && ycc) {
    // jdcolor.c: SCALEBITS 16, tables built for x = i - 128
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    const int64_t ONE_HALF = int64_t(1) << 15;
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = int((int64_t(91881) * x + ONE_HALF) >> 16);    // FIX(1.40200)
      cb_b[i] = int((int64_t(116130) * x + ONE_HALF) >> 16);   // FIX(1.77200)
      cr_g[i] = -int64_t(46802) * x;                           // FIX(0.71414)
      cb_g[i] = -int64_t(22554) * x + ONE_HALF;                // FIX(0.34414)
    }
    auto clamp = [](int v) -> uint8_t {
      return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    };
    const uint8_t *Y = full.data(), *Cb = Y + npix, *Cr = Cb + npix;
    for (size_t i = 0; i < npix; ++i) {
      int y = Y[i], cb = Cb[i], cr = Cr[i];
      out[3 * i] = clamp(y + cr_r[cr]);
      out[3 * i + 1] = clamp(y + int((cb_g[cb] + cr_g[cr]) >> 16));
      out[3 * i + 2] = clamp(y + cb_b[cb]);
    }
  } else {
    for (size_t i = 0; i < npix; ++i)
      for (int c = 0; c < ncomp; ++c) out[ncomp * i + c] = full[npix * c + i];
  }
  return 0;
}

// img: h x w x 3 RGB (or h x w gray when ncomp == 1) -> the entropy-coded
// data of one interleaved baseline scan (byte-stuffed, padded) in out
// (cap bytes). Chroma sampling: hs0 x vs0 for Y, 1 x 1 for Cb and Cr.
// qt: ncomp x 64 quantizers in natural order (0 = luma, 1 = chroma
// tables); bits/vals: DC0, AC0, DC1, AC1 (16 and 256 bytes each).
// Returns the byte count, or -1 when cap is too small.
int64_t jpeg_encode(const uint8_t* img, int w, int h, int ncomp, int hs0,
                    int vs0, const uint16_t* qt, const uint8_t* bits,
                    const uint8_t* vals, uint8_t* out, int64_t cap) {
  int hmax = ncomp == 1 ? 1 : hs0, vmax = ncomp == 1 ? 1 : vs0;
  int mcu_w = 8 * hmax, mcu_h = 8 * vmax;
  int mx = (w + mcu_w - 1) / mcu_w, my = (h + mcu_h - 1) / mcu_h;
  int fw = mx * mcu_w, fh = my * mcu_h;
  size_t fpix = size_t(fw) * fh;
  // colour conversion on the edge-replicated MCU-aligned image
  std::vector<uint8_t> comp(fpix * ncomp);
  int64_t tab[8][256];
  const int64_t ONE_HALF = int64_t(1) << 15, CBCR = int64_t(128) << 16;
  for (int i = 0; i < 256; ++i) {
    tab[0][i] = 19595 * int64_t(i);                   // FIX(0.29900)
    tab[1][i] = 38470 * int64_t(i);                   // FIX(0.58700)
    tab[2][i] = 7471 * int64_t(i) + ONE_HALF;         // FIX(0.11400)
    tab[3][i] = -11059 * int64_t(i);                  // FIX(0.16874)
    tab[4][i] = -21709 * int64_t(i);                  // FIX(0.33126)
    tab[5][i] = 32768 * int64_t(i) + CBCR + ONE_HALF - 1;  // FIX(0.5)
    tab[6][i] = -27439 * int64_t(i);                  // FIX(0.41869)
    tab[7][i] = -5329 * int64_t(i);                   // FIX(0.08131)
  }
  for (int y = 0; y < fh; ++y) {
    int sy = y < h ? y : h - 1;
    for (int x = 0; x < fw; ++x) {
      int sx = x < w ? x : w - 1;
      size_t o = size_t(y) * fw + x;
      if (ncomp == 1) {
        comp[o] = img[size_t(sy) * w + sx];
        continue;
      }
      const uint8_t* p = img + 3 * (size_t(sy) * w + sx);
      int r = p[0], g = p[1], b = p[2];
      comp[o] = uint8_t((tab[0][r] + tab[1][g] + tab[2][b]) >> 16);
      comp[fpix + o] = uint8_t((tab[3][r] + tab[4][g] + tab[5][b]) >> 16);
      comp[2 * fpix + o] = uint8_t((tab[5][r] + tab[6][g] + tab[7][b]) >> 16);
    }
  }
  // chroma planes, box-downsampled with jcsample.c's alternating bias from
  // the image padded to a row group (vmax rows); below the downsampled
  // rows, jcprepct.c replicates the last of them
  int cw = fw / hmax, ch = fh / vmax, crows = (h + vmax - 1) / vmax;
  std::vector<uint8_t> chroma(ncomp == 3 ? size_t(cw) * ch * 2 : 0);
  for (int c = 1; c < ncomp; ++c) {
    const uint8_t* src = comp.data() + fpix * c;
    uint8_t* dst = chroma.data() + size_t(cw) * ch * (c - 1);
    for (int y = 0; y < ch; ++y)
      for (int x = 0; x < cw; ++x) {
        int sum = 0, sy = y < crows ? y : crows - 1;
        for (int dy = 0; dy < vmax; ++dy)
          for (int dx = 0; dx < hmax; ++dx)
            sum += src[size_t(sy * vmax + dy) * fw + x * hmax + dx];
        int nsamp = hmax * vmax, v;
        if (nsamp == 4)
          v = (sum + ((x & 1) ? 2 : 1)) >> 2;
        else if (nsamp == 2)
          v = (sum + (x & 1)) >> 1;
        else
          v = sum;
        dst[size_t(y) * cw + x] = static_cast<uint8_t>(v);
      }
  }
  EncodeTable dc[2], ac[2];
  for (int t = 0; t < 2; ++t) {
    dc[t].build(bits + 32 * t, vals + 512 * t);
    ac[t].build(bits + 32 * t + 16, vals + 512 * t + 256);
  }
  // blocks beyond a component's width_in_blocks / height_in_blocks are
  // libjpeg's dummy blocks: no AC, the DC of the block before in the MCU
  int wib[3], hib[3];
  for (int c = 0; c < ncomp; ++c) {
    int sh = c == 0 ? hmax : 1, sv = c == 0 ? vmax : 1;
    wib[c] = ((w * sh + hmax - 1) / hmax + 7) / 8;
    hib[c] = ((h * sv + vmax - 1) / vmax + 7) / 8;
  }
  std::vector<uint8_t> bytes;
  bytes.reserve(size_t(w) * h / 2 + 1024);
  BitWriter bw(bytes);
  int pred[3] = {0, 0, 0};
  int32_t blk[64];
  int16_t q[64];
  for (int uy = 0; uy < my; ++uy)
    for (int ux = 0; ux < mx; ++ux)
      for (int c = 0; c < ncomp; ++c) {
        int nh = c == 0 ? hmax : 1, nv = c == 0 ? vmax : 1;
        const uint8_t* plane =
            c == 0 ? comp.data() : chroma.data() + size_t(cw) * ch * (c - 1);
        int stride = c == 0 ? fw : cw;
        const uint16_t* quant = qt + 64 * c;
        int tsel = c == 0 ? 0 : 1;
        int16_t last_dc = 0;
        for (int by = 0; by < nv; ++by)
          for (int bx = 0; bx < nh; ++bx) {
            int gx = ux * nh + bx, gy = uy * nv + by;
            if (gx >= wib[c] || gy >= hib[c]) {
              // never the MCU's first block: some block of it is inside
              std::memset(q, 0, sizeof(q));
              q[0] = last_dc;
            } else {
              for (int r = 0; r < 8; ++r)
                for (int k = 0; k < 8; ++k)
                  blk[8 * r + k] =
                      int32_t(plane[size_t(gy * 8 + r) * stride + gx * 8 + k]) -
                      128;
              fdct_islow(blk);
              for (int i = 0; i < 64; ++i) {
                int32_t qv = int32_t(quant[i]) << 3, t = blk[i];
                if (t < 0) {
                  t = -t + (qv >> 1);
                  t = t >= qv ? t / qv : 0;
                  t = -t;
                } else {
                  t += qv >> 1;
                  t = t >= qv ? t / qv : 0;
                }
                q[i] = static_cast<int16_t>(t);
              }
            }
            last_dc = q[0];
            encode_block(bw, q, &pred[c], dc[tsel], ac[tsel]);
          }
      }
  bw.flush();
  if (int64_t(bytes.size()) > cap) return -1;
  std::memcpy(out, bytes.data(), bytes.size());
  return int64_t(bytes.size());
}

}  // extern "C"
