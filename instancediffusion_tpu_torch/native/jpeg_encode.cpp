// Baseline JPEG encoder whose bytes equal what Pillow writes for
// Image.fromarray(rgb).convert("RGB").save(buf, format="JPEG"): libjpeg-turbo
// with its defaults (quality 75, 4:2:0, the standard Huffman tables of Annex
// K, a JFIF 1.01 APP0 with a 1:1 aspect, ISLOW DCT, no restart markers).
// Each stage follows libjpeg-turbo's C code (its SIMD paths give the same
// numbers):
//   * RGB -> YCbCr in 16-bit fixed point (jccolor.c rgb_ycc_convert)
//   * rows replicated down to a whole row group and then to a whole iMCU
//     row, columns replicated right to whole blocks (jcprepct.c,
//     jcsample.c expand_right_edge)
//   * chroma h2v2_downsample with the alternating 1, 2 bias (jcsample.c)
//   * the ISLOW forward DCT (jfdctint.c) of samples less 128
//   * quantisation by the reciprocal, correction and shift of
//     compute_reciprocal (jcdctmgr.c)
//   * dummy blocks past the image's blocks in an MCU: zeros with the DC of
//     the block before (jccoefct.c compress_data)
//   * Huffman coding with 0xFF stuffing, the last byte padded with ones
//     (jchuff.c), markers in jcmarker.c's order: SOI, APP0, DQT 0, DQT 1,
//     SOF0, DHT DC0, AC0, DC1, AC1, SOS, data, EOI.
//
// C interface (ctypes, instancediffusion_tpu_torch/data/_native.py):
//   int64 idt_jpeg_encode(rgb, h, w, out, cap)
//     (h, w, 3) uint8 -> the file's length; -(length) when cap is smaller
//     (nothing useful is written then), 0 for an empty image.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

const int kZigzag[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                         12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                         35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                         58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Annex K's tables in natural order (jcparam.c)
const int kLumaQuant[64] = {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
                            14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
                            18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
                            49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromaQuant[64] = {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                              24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
                              99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                              99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// DHT bodies after the class/id byte: 16 code counts by length, then symbols
const uint8_t kDcLuma[] = {0x00, 0x01, 0x05, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x00,
                           0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x01, 0x02, 0x03,
                           0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x0a, 0x0b};
const uint8_t kDcChroma[] = {0x00, 0x03, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01,
                             0x01, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x01, 0x02, 0x03,
                             0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x0a, 0x0b};
const uint8_t kAcLuma[] = {
    0x00, 0x02, 0x01, 0x03, 0x03, 0x02, 0x04, 0x03, 0x05, 0x05, 0x04, 0x04, 0x00, 0x00, 0x01,
    0x7d, 0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15,
    0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a,
    0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
    0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5,
    0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2,
    0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChroma[] = {
    0x00, 0x02, 0x01, 0x02, 0x04, 0x04, 0x03, 0x04, 0x07, 0x05, 0x04, 0x04, 0x00, 0x01, 0x02,
    0x77, 0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23,
    0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17,
    0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43,
    0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a,
    0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
    0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96,
    0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3,
    0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6,
    0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct Huff {
    uint32_t code[256];
    uint8_t size[256];
};

// jchuff.c jpeg_make_c_derived_tbl: canonical codes in order of length
Huff derive(const uint8_t* table) {
    Huff h;
    std::memset(&h, 0, sizeof(h));
    const uint8_t* syms = table + 16;
    uint32_t code = 0;
    int k = 0;
    for (int len = 1; len <= 16; ++len) {
        for (int i = 0; i < table[len - 1]; ++i, ++k) {
            h.code[syms[k]] = code++;
            h.size[syms[k]] = (uint8_t)len;
        }
        code <<= 1;
    }
    return h;
}

// the quality-75 table (scale 50, at least 1, at most 255) in natural order
void scaled_quant(const int* base, int* out) {
    for (int i = 0; i < 64; ++i) {
        long t = (base[i] * 50L + 50L) / 100L;
        out[i] = (int)(t < 1 ? 1 : (t > 255 ? 255 : t));
    }
}

struct Divisor {
    uint32_t recip, corr;
    int shift;
};

// jcdctmgr.c compute_reciprocal for a 16-bit DCTELEM (every divisor here is
// a table entry times 8, so never 1)
Divisor reciprocal(uint32_t divisor) {
    Divisor d;
    int b = 31 - __builtin_clz(divisor);
    int r = 16 + b;
    uint64_t fq = ((uint64_t)1 << r) / divisor;
    uint64_t fr = ((uint64_t)1 << r) % divisor;
    uint32_t c = divisor / 2;
    if (fr == 0) {
        fq >>= 1;
        r--;
    } else if (fr <= divisor / 2U) {
        c++;
    } else {
        fq++;
    }
    d.recip = (uint32_t)fq;
    d.corr = c;
    d.shift = r;
    return d;
}

int quantize_one(int v, const Divisor& d) {
    uint32_t a = (uint32_t)(v < 0 ? -v : v);
    uint32_t q = (uint32_t)(((uint64_t)(a + d.corr) * d.recip) >> d.shift);
    return v < 0 ? -(int)q : (int)q;
}

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

// jfdctint.c jpeg_fdct_islow, in place on a block of samples less 128
void fdct_islow(int32_t* data) {
    const int CB = 13, P1 = 2;
    for (int pass = 0; pass < 2; ++pass) {
        for (int i = 0; i < 8; ++i) {
            int32_t* p = pass == 0 ? data + i * 8 : data + i;
            const int s = pass == 0 ? 1 : 8;
            int32_t tmp0 = p[0] + p[7 * s], tmp7 = p[0] - p[7 * s];
            int32_t tmp1 = p[1 * s] + p[6 * s], tmp6 = p[1 * s] - p[6 * s];
            int32_t tmp2 = p[2 * s] + p[5 * s], tmp5 = p[2 * s] - p[5 * s];
            int32_t tmp3 = p[3 * s] + p[4 * s], tmp4 = p[3 * s] - p[4 * s];
            int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
            int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
            const int sh = pass == 0 ? CB - P1 : CB + P1;
            if (pass == 0) {
                p[0] = (tmp10 + tmp11) * (1 << P1);
                p[4 * s] = (tmp10 - tmp11) * (1 << P1);
            } else {
                p[0] = descale(tmp10 + tmp11, P1);
                p[4 * s] = descale(tmp10 - tmp11, P1);
            }
            int32_t z1 = (tmp12 + tmp13) * 4433;
            p[2 * s] = descale(z1 + tmp13 * 6270, sh);
            p[6 * s] = descale(z1 + tmp12 * (-15137), sh);
            z1 = tmp4 + tmp7;
            int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
            int32_t z5 = (z3 + z4) * 9633;
            tmp4 *= 2446;
            tmp5 *= 16819;
            tmp6 *= 25172;
            tmp7 *= 12299;
            z1 *= -7373;
            z2 *= -20995;
            z3 *= -16069;
            z4 *= -3196;
            z3 += z5;
            z4 += z5;
            p[7 * s] = descale(tmp4 + z1 + z3, sh);
            p[5 * s] = descale(tmp5 + z2 + z4, sh);
            p[3 * s] = descale(tmp6 + z2 + z3, sh);
            p[1 * s] = descale(tmp7 + z1 + z4, sh);
        }
    }
}

// one component's samples, padded to whole blocks (rows x cols, both
// multiples of 8), with its real block counts
struct Plane {
    std::vector<uint8_t> px;
    int64_t rows = 0, cols = 0, bw = 0, bh = 0;
};

class BitWriter {
  public:
    explicit BitWriter(std::vector<uint8_t>& out) : out_(out) {}
    void put(uint32_t code, int size) {
        acc_ = (acc_ << size) | (code & ((1u << size) - 1u));
        n_ += size;
        while (n_ >= 8) {
            n_ -= 8;
            emit((uint8_t)(acc_ >> n_));
        }
        acc_ &= (1u << n_) - 1u;
    }
    void flush() {
        if (n_) emit((uint8_t)((acc_ << (8 - n_)) | (0xFFu >> n_)));
        n_ = 0;
        acc_ = 0;
    }

  private:
    void emit(uint8_t b) {
        out_.push_back(b);
        if (b == 0xFF) out_.push_back(0);
    }
    std::vector<uint8_t>& out_;
    uint64_t acc_ = 0;
    int n_ = 0;
};

int nbits(int v) {
    unsigned a = (unsigned)(v < 0 ? -v : v);
    return a ? 32 - __builtin_clz(a) : 0;
}

void encode_block(BitWriter& bw, const int* coef, int& last_dc, const Huff& dc, const Huff& ac) {
    int diff = coef[0] - last_dc;
    last_dc = coef[0];
    int n = nbits(diff);
    bw.put(dc.code[n], dc.size[n]);
    if (n) bw.put((uint32_t)(diff < 0 ? diff - 1 : diff), n);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
        int v = coef[kZigzag[k]];
        if (v == 0) {
            ++run;
            continue;
        }
        while (run > 15) {
            bw.put(ac.code[0xF0], ac.size[0xF0]);
            run -= 16;
        }
        n = nbits(v);
        int sym = (run << 4) + n;
        bw.put(ac.code[sym], ac.size[sym]);
        bw.put((uint32_t)(v < 0 ? v - 1 : v), n);
        run = 0;
    }
    if (run > 0) bw.put(ac.code[0], ac.size[0]);
}

void put16(std::vector<uint8_t>& o, int v) {
    o.push_back((uint8_t)(v >> 8));
    o.push_back((uint8_t)v);
}

void segment(std::vector<uint8_t>& o, uint8_t marker, const std::vector<uint8_t>& body) {
    o.push_back(0xFF);
    o.push_back(marker);
    put16(o, (int)body.size() + 2);
    o.insert(o.end(), body.begin(), body.end());
}

void dht(std::vector<uint8_t>& o, uint8_t id, const uint8_t* table, size_t n) {
    std::vector<uint8_t> body{id};
    body.insert(body.end(), table, table + n);
    segment(o, 0xC4, body);
}

}  // namespace

extern "C" {

int64_t idt_jpeg_encode(const uint8_t* rgb, int64_t h, int64_t w, uint8_t* out, int64_t cap) {
    if (h <= 0 || w <= 0) return 0;
    const int64_t mcux = (w + 15) / 16, mcuy = (h + 15) / 16;
    const int64_t rows_even = (h + 1) & ~(int64_t)1;  // a whole row group of 2

    // colour conversion (jccolor.c), rows replicated to a whole row group
    // and columns to whole MCUs: the chroma planes before downsampling
    const int64_t full_cols = mcux * 16, full_rows = mcuy * 16;
    std::vector<uint8_t> ycc[3];
    for (auto& p : ycc) p.assign((size_t)(full_rows * full_cols), 0);
    const int32_t half = 1 << 15, offset = 128 << 16;
    for (int64_t y = 0; y < full_rows; ++y) {
        const int64_t sy = y < h ? y : h - 1;
        for (int64_t x = 0; x < full_cols; ++x) {
            const int64_t sx = x < w ? x : w - 1;
            const uint8_t* px = rgb + (sy * w + sx) * 3;
            const int32_t r = px[0], g = px[1], b = px[2];
            const size_t i = (size_t)(y * full_cols + x);
            ycc[0][i] = (uint8_t)((19595 * r + 38470 * g + 7471 * b + half) >> 16);
            ycc[1][i] = (uint8_t)((-11059 * r - 21709 * g + 32768 * b + offset + half - 1) >> 16);
            ycc[2][i] = (uint8_t)((32768 * r - 27439 * g - 5329 * b + offset + half - 1) >> 16);
        }
    }

    Plane planes[3];
    // luma: full size, blocks to ceil(w / 8) x ceil(h / 8), the rest of an
    // MCU dummy blocks
    planes[0].rows = full_rows;
    planes[0].cols = full_cols;
    planes[0].bw = (w + 7) / 8;
    planes[0].bh = (h + 7) / 8;
    planes[0].px = ycc[0];
    // chroma: h2v2 over row pairs of the even-row image, bias 1, 2, 1, ...;
    // rows past ceil(h / 2) repeat the last one (the iMCU padding)
    const int64_t crows = rows_even / 2;
    for (int c = 1; c < 3; ++c) {
        Plane& p = planes[c];
        p.rows = mcuy * 8;
        p.cols = mcux * 8;
        p.bw = mcux;
        p.bh = mcuy;
        p.px.assign((size_t)(p.rows * p.cols), 0);
        const std::vector<uint8_t>& src = ycc[c];
        for (int64_t y = 0; y < p.rows; ++y) {
            const int64_t sy = (y < crows ? y : crows - 1) * 2;
            const uint8_t* r0 = src.data() + sy * full_cols;
            const uint8_t* r1 = r0 + full_cols;
            int bias = 1;
            for (int64_t x = 0; x < p.cols; ++x) {
                const int64_t sx = 2 * x;
                p.px[(size_t)(y * p.cols + x)] =
                    (uint8_t)((r0[sx] + r0[sx + 1] + r1[sx] + r1[sx + 1] + bias) >> 2);
                bias ^= 3;
            }
        }
    }

    int qtab[2][64];
    scaled_quant(kLumaQuant, qtab[0]);
    scaled_quant(kChromaQuant, qtab[1]);
    Divisor div[2][64];
    for (int t = 0; t < 2; ++t)
        for (int i = 0; i < 64; ++i) div[t][i] = reciprocal((uint32_t)qtab[t][i] << 3);
    const Huff dc[2] = {derive(kDcLuma), derive(kDcChroma)};
    const Huff ac[2] = {derive(kAcLuma), derive(kAcChroma)};

    std::vector<uint8_t> o;
    o.reserve((size_t)(h * w) + 1024);
    o.push_back(0xFF);
    o.push_back(0xD8);
    segment(o, 0xE0, {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0});
    for (int t = 0; t < 2; ++t) {
        std::vector<uint8_t> body{(uint8_t)t};
        for (int k = 0; k < 64; ++k) body.push_back((uint8_t)qtab[t][kZigzag[k]]);
        segment(o, 0xDB, body);
    }
    segment(o, 0xC0, {8, (uint8_t)(h >> 8), (uint8_t)h, (uint8_t)(w >> 8), (uint8_t)w, 3, 1, 0x22,
                      0, 2, 0x11, 1, 3, 0x11, 1});
    dht(o, 0x00, kDcLuma, sizeof(kDcLuma));
    dht(o, 0x10, kAcLuma, sizeof(kAcLuma));
    dht(o, 0x01, kDcChroma, sizeof(kDcChroma));
    dht(o, 0x11, kAcChroma, sizeof(kAcChroma));
    segment(o, 0xDA, {3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0});

    BitWriter bw(o);
    int last_dc[3] = {0, 0, 0};
    int32_t block[64];
    int coef[64];
    for (int64_t my = 0; my < mcuy; ++my) {
        for (int64_t mx = 0; mx < mcux; ++mx) {
            for (int c = 0; c < 3; ++c) {
                const Plane& p = planes[c];
                const int n = c == 0 ? 2 : 1;
                const int t = c == 0 ? 0 : 1;
                int prev_dc = 0;
                for (int by = 0; by < n; ++by) {
                    for (int bx = 0; bx < n; ++bx) {
                        const int64_t gy = my * n + by, gx = mx * n + bx;
                        if (gy < p.bh && gx < p.bw) {
                            for (int r = 0; r < 8; ++r) {
                                const uint8_t* row = &p.px[(size_t)((gy * 8 + r) * p.cols + gx * 8)];
                                for (int k = 0; k < 8; ++k) block[r * 8 + k] = (int32_t)row[k] - 128;
                            }
                            fdct_islow(block);
                            for (int i = 0; i < 64; ++i) {
                                coef[i] = quantize_one(block[i], div[t][i]);
                            }
                        } else {
                            // a dummy block: zeros, the DC of the block before
                            // (a dummy row copies the row above's last block)
                            std::memset(coef, 0, sizeof(coef));
                            coef[0] = prev_dc;
                        }
                        prev_dc = coef[0];
                        encode_block(bw, coef, last_dc[c], dc[t], ac[t]);
                    }
                }
            }
        }
    }
    bw.flush();
    o.push_back(0xFF);
    o.push_back(0xD9);

    const int64_t n = (int64_t)o.size();
    if (n > cap) return -n;
    std::memcpy(out, o.data(), (size_t)n);
    return n;
}

}  // extern "C"
