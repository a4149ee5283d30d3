// JPEG decoding for the training loader, bit for bit as libjpeg-turbo's
// defaults decode it (what PIL's Image.open(...).convert("RGB") returns):
//   * sequential (SOF0, SOF1) and progressive (SOF2) Huffman coding, 8-bit
//     samples, 1 or 3 components, any integer sampling ratio, DRI restarts
//   * JDCT_ISLOW: jidctint.c's fixed-point IDCT with its descale and its
//     post-IDCT range-limit table
//   * fancy upsampling: jdsample.c's h2v1 / h1v2 / h2v2 triangle filters with
//     their rounding biases, edge samples repeated (jdmainct.c's context
//     rows); plain replication where libjpeg-turbo uses it (chroma 2 samples
//     wide or less, other ratios)
//   * jdcolor.c's fixed-point YCbCr -> RGB tables; gray replicated to RGB
// Anything else (arithmetic coding, lossless, hierarchical, 12-bit, CMYK)
// is refused with a message naming it.
//
// C interface (ctypes, instancediffusion_tpu_torch/data/_native.py):
//   idt_jpeg_info(data, n, out[4], err, errcap): width, height, channels of
//       the decoded image before RGB (1 or 3), SOF marker
//   idt_jpeg_decode(data, n, out, err, errcap): (height, width, 3) uint8 RGB
// Both return 0, or 1 with a message in err.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct JpegError {
    std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw JpegError{msg}; }

// zig-zag index -> natural (row-major) index, padded as libjpeg pads it so
// a corrupt run past 63 lands on 63
const int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
    bool defined = false;
    // lookahead: (length << 8) | symbol for codes of <= 9 bits, 0 otherwise
    uint16_t look[1 << 9];
    int32_t maxcode[18];  // largest code of each length, -1 if none
    int32_t valoffset[18];
    uint8_t vals[256];
};

void build_huffman(Huffman& h, const uint8_t bits[17], const uint8_t* vals, int nvals) {
    std::memcpy(h.vals, vals, nvals);
    std::memset(h.look, 0, sizeof(h.look));
    int code = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
        h.valoffset[len] = k - code;
        if (bits[len]) {
            for (int i = 0; i < bits[len]; ++i, ++code, ++k) {
                if (len <= 9) {
                    int shift = 9 - len;
                    for (int j = 0; j < (1 << shift); ++j)
                        h.look[(code << shift) | j] = (uint16_t)((len << 8) | vals[k]);
                }
            }
            h.maxcode[len] = code - 1;
        } else {
            h.maxcode[len] = -1;
        }
        if (code > (1 << len)) fail("bad Huffman table");
        code <<= 1;
    }
    h.maxcode[17] = 0x7fffffff;
    h.defined = true;
}

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int bw = 0, bh = 0;        // blocks allocated (the interleaved, padded grid)
    int width = 0, height = 0; // downsampled_width / downsampled_height
    int dc_tbl = 0, ac_tbl = 0;
    bool latched = false;
    uint16_t quant[64];        // natural order, latched at the first scan
    std::vector<int16_t> coef; // bh * bw blocks of 64, natural order
    int dc_pred = 0;
};

class BitReader {
public:
    BitReader(const uint8_t* p, const uint8_t* end) : p_(p), end_(end) {}

    // libjpeg's jpeg_fill_bit_buffer: 0xFF 0x00 is a data 0xFF, any other
    // marker ends the data and zeros are supplied from then on
    void fill() {
        while (bits_ <= 56) {
            uint32_t byte = 0;
            if (!marker_ && p_ < end_) {
                byte = *p_;
                if (byte == 0xFF) {
                    const uint8_t* q = p_ + 1;
                    while (q < end_ && *q == 0xFF) ++q;
                    if (q < end_ && *q == 0x00) {
                        p_ = q + 1;
                    } else {
                        marker_ = true;
                        p_ = q - 1;  // at the last 0xFF before the marker code
                        byte = 0;
                    }
                } else {
                    ++p_;
                }
            }
            buf_ |= (uint64_t)byte << (56 - bits_);
            bits_ += 8;
        }
    }

    int get_bits(int n) {
        if (n == 0) return 0;
        if (bits_ < n) fill();
        int v = (int)(buf_ >> (64 - n));
        buf_ <<= n;
        bits_ -= n;
        return v;
    }

    int get_bit() { return get_bits(1); }

    int decode(const Huffman& h) {
        if (!h.defined) fail("scan uses an undefined Huffman table");
        if (bits_ < 16) fill();
        uint16_t e = h.look[buf_ >> (64 - 9)];
        if (e) {
            int len = e >> 8;
            buf_ <<= len;
            bits_ -= len;
            return e & 0xFF;
        }
        int code = (int)(buf_ >> (64 - 10));
        int len = 10;
        while (len <= 16 && code > h.maxcode[len]) {
            ++len;
            code = (int)(buf_ >> (64 - len));
        }
        if (len > 16) {  // corrupt data: libjpeg returns symbol 0
            buf_ <<= 16;
            bits_ -= 16;
            return 0;
        }
        buf_ <<= len;
        bits_ -= len;
        return h.vals[(code + h.valoffset[len]) & 0xFF];
    }

    // restart: drop the buffered bits, skip to and over the RSTn marker
    void restart() {
        buf_ = 0;
        bits_ = 0;
        marker_ = false;
        while (p_ + 1 < end_) {
            if (p_[0] == 0xFF && p_[1] >= 0xD0 && p_[1] <= 0xD7) {
                p_ += 2;
                return;
            }
            if (p_[0] == 0xFF && p_[1] != 0x00 && p_[1] != 0xFF) return;  // another marker
            ++p_;
        }
    }

    const uint8_t* pos() const { return p_; }

private:
    const uint8_t* p_;
    const uint8_t* end_;
    uint64_t buf_ = 0;
    int bits_ = 0;
    bool marker_ = false;
};

inline int extend(int v, int t) { return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v; }

class Decoder {
public:
    Decoder(const uint8_t* data, int64_t n) : data_(data), end_(data + n) {}

    void parse(bool headers_only);
    void output(uint8_t* rgb);  // (height, width, 3)

    int width = 0, height = 0, sof = 0;
    int channels() const { return ncomp_ == 1 ? 1 : 3; }

private:
    int u8() {
        if (p_ >= end_) fail("unexpected end of JPEG data");
        return *p_++;
    }
    int u16() {
        int hi = u8();
        return (hi << 8) | u8();
    }
    void read_sof(int marker);
    void read_dht();
    void read_dqt();
    void read_sos();
    void decode_scan(const std::vector<int>& comps, int ss, int se, int ah, int al);
    void upsample_and_convert(uint8_t* rgb);

    const uint8_t* data_;
    const uint8_t* end_;
    const uint8_t* p_ = nullptr;
    bool progressive_ = false;
    int ncomp_ = 0, hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
    int restart_interval_ = 0;
    bool jfif_ = false, adobe_ = false;
    int adobe_transform_ = -1;
    Component comp_[3];
    uint16_t qt_[4][64];
    bool qt_defined_[4] = {false, false, false, false};
    Huffman dc_[4], ac_[4];
    bool frame_ = false;
    int eobrun_ = 0;
};

void Decoder::read_sof(int marker) {
    if (frame_) fail("more than one frame (SOF) marker");
    const char* kinds[16] = {
        "baseline", "extended sequential", "progressive", "lossless",
        "", "differential sequential (hierarchical)", "differential progressive (hierarchical)",
        "differential lossless (hierarchical)", "", "arithmetic-coded sequential",
        "arithmetic-coded progressive", "arithmetic-coded lossless", "",
        "arithmetic-coded differential sequential", "arithmetic-coded differential progressive",
        "arithmetic-coded differential lossless"};
    int kind = marker - 0xC0;
    if (marker != 0xC0 && marker != 0xC1 && marker != 0xC2) {
        char buf[160];
        std::snprintf(buf, sizeof buf, "unsupported JPEG: SOF%d (0xFF%02X, %s)", kind, marker,
                      kinds[kind]);
        fail(buf);
    }
    sof = marker;
    progressive_ = marker == 0xC2;
    int len = u16();
    const uint8_t* seg_end = p_ + len - 2;
    int precision = u8();
    height = u16();
    width = u16();
    ncomp_ = u8();
    if (precision != 8) {
        char buf[96];
        std::snprintf(buf, sizeof buf, "unsupported JPEG: %d-bit samples (SOF%d)", precision,
                      kind);
        fail(buf);
    }
    if (height == 0) fail("unsupported JPEG: height 0 (DNL marker)");
    if (width == 0) fail("JPEG width 0");
    if (ncomp_ != 1 && ncomp_ != 3) {
        char buf[96];
        std::snprintf(buf, sizeof buf, "unsupported JPEG: %d components (CMYK / YCCK)", ncomp_);
        fail(buf);
    }
    for (int i = 0; i < ncomp_; ++i) {
        Component& c = comp_[i];
        c.id = u8();
        int hv = u8();
        c.h = hv >> 4;
        c.v = hv & 15;
        c.tq = u8();
        if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
            fail("bad JPEG component sampling factors or quantization table");
        hmax_ = c.h > hmax_ ? c.h : hmax_;
        vmax_ = c.v > vmax_ ? c.v : vmax_;
    }
    if (p_ != seg_end) fail("bad SOF segment length");
    mcux_ = (width + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (height + 8 * vmax_ - 1) / (8 * vmax_);
    for (int i = 0; i < ncomp_; ++i) {
        Component& c = comp_[i];
        if (hmax_ % c.h || vmax_ % c.v)
            fail("unsupported JPEG: fractional sampling ratio");
        c.bw = mcux_ * c.h;
        c.bh = mcuy_ * c.v;
        c.width = (int)(((int64_t)width * c.h + hmax_ - 1) / hmax_);
        c.height = (int)(((int64_t)height * c.v + vmax_ - 1) / vmax_);
    }
    frame_ = true;
}

void Decoder::read_dht() {
    int len = u16();
    const uint8_t* seg_end = p_ + len - 2;
    while (p_ < seg_end) {
        int tc_th = u8();
        int tc = tc_th >> 4, th = tc_th & 15;
        if (tc > 1 || th > 3) fail("bad Huffman table class or index");
        uint8_t bits[17] = {0};
        int total = 0;
        for (int i = 1; i <= 16; ++i) {
            bits[i] = (uint8_t)u8();
            total += bits[i];
        }
        if (total > 256) fail("bad Huffman table");
        uint8_t vals[256];
        for (int i = 0; i < total; ++i) vals[i] = (uint8_t)u8();
        build_huffman(tc == 0 ? dc_[th] : ac_[th], bits, vals, total);
    }
    if (p_ != seg_end) fail("bad DHT segment length");
}

void Decoder::read_dqt() {
    int len = u16();
    const uint8_t* seg_end = p_ + len - 2;
    while (p_ < seg_end) {
        int pq_tq = u8();
        int pq = pq_tq >> 4, tq = pq_tq & 15;
        if (tq > 3) fail("bad quantization table index");
        for (int i = 0; i < 64; ++i)
            qt_[tq][kNaturalOrder[i]] = (uint16_t)(pq ? u16() : u8());
        qt_defined_[tq] = true;
    }
    if (p_ != seg_end) fail("bad DQT segment length");
}

void Decoder::read_sos() {
    if (!frame_) fail("scan before the frame header");
    int len = u16();
    const uint8_t* seg_end = p_ + len - 2;
    int ns = u8();
    if (ns < 1 || ns > ncomp_) fail("bad number of components in a scan");
    std::vector<int> comps;
    for (int i = 0; i < ns; ++i) {
        int id = u8();
        int tables = u8();
        int ci = -1;
        for (int j = 0; j < ncomp_; ++j)
            if (comp_[j].id == id) ci = j;
        if (ci < 0) fail("scan names an unknown component");
        comp_[ci].dc_tbl = tables >> 4;
        comp_[ci].ac_tbl = tables & 15;
        if (comp_[ci].dc_tbl > 3 || comp_[ci].ac_tbl > 3) fail("bad Huffman table index");
        comps.push_back(ci);
    }
    int ss = u8(), se = u8(), ahal = u8();
    if (p_ != seg_end) fail("bad SOS segment length");
    int ah = ahal >> 4, al = ahal & 15;
    if (progressive_) {
        if (ss > se || se > 63 || (ss == 0 && se != 0) || (ss > 0 && ns != 1) || al > 13)
            fail("bad progressive scan parameters");
    } else {
        ss = 0;
        se = 63;
        ah = al = 0;
    }
    for (int ci : comps) {  // libjpeg latches each table at a component's first scan
        Component& c = comp_[ci];
        if (!c.latched) {
            if (!qt_defined_[c.tq]) fail("scan before its quantization table");
            std::memcpy(c.quant, qt_[c.tq], sizeof c.quant);
            c.latched = true;
        }
        if (c.coef.empty()) c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    }
    decode_scan(comps, ss, se, ah, al);
}

void Decoder::decode_scan(const std::vector<int>& comps, int ss, int se, int ah, int al) {
    BitReader br(p_, end_);
    for (int ci : comps) comp_[ci].dc_pred = 0;
    eobrun_ = 0;
    const bool single = comps.size() == 1;
    // a scan of one component is not interleaved: one block per MCU over
    // that component's own blocks
    int mx, my;
    if (single) {
        const Component& c = comp_[comps[0]];
        mx = (c.width + 7) / 8;
        my = (c.height + 7) / 8;
    } else {
        mx = mcux_;
        my = mcuy_;
    }
    const int64_t total = (int64_t)mx * my;
    int restarts_left = restart_interval_;

    auto block = [&](Component& c, int16_t* blk) {
        if (!progressive_) {
            int t = br.decode(dc_[c.dc_tbl]);
            int diff = t ? extend(br.get_bits(t), t) : 0;
            c.dc_pred += diff;
            blk[0] = (int16_t)c.dc_pred;
            const Huffman& ac = ac_[c.ac_tbl];
            for (int k = 1; k < 64; ++k) {
                int rs = br.decode(ac);
                int r = rs >> 4, s = rs & 15;
                if (s) {
                    k += r;
                    blk[kNaturalOrder[k]] = (int16_t)extend(br.get_bits(s), s);
                } else {
                    if (r != 15) break;
                    k += 15;
                }
            }
            return;
        }
        if (ss == 0) {  // DC scans
            if (ah == 0) {
                int t = br.decode(dc_[c.dc_tbl]);
                int diff = t ? extend(br.get_bits(t), t) : 0;
                c.dc_pred += diff;
                blk[0] = (int16_t)((unsigned)c.dc_pred << al);
            } else if (br.get_bit()) {
                blk[0] |= (int16_t)(1 << al);
            }
            return;
        }
        const Huffman& ac = ac_[c.ac_tbl];
        if (ah == 0) {  // AC first pass
            if (eobrun_ > 0) {
                --eobrun_;
                return;
            }
            for (int k = ss; k <= se; ++k) {
                int rs = br.decode(ac);
                int r = rs >> 4, s = rs & 15;
                if (s) {
                    k += r;
                    blk[kNaturalOrder[k]] = (int16_t)((unsigned)extend(br.get_bits(s), s) << al);
                } else if (r == 15) {
                    k += 15;
                } else {
                    eobrun_ = 1 << r;
                    if (r) eobrun_ += br.get_bits(r);
                    --eobrun_;
                    break;
                }
            }
            return;
        }
        // AC refinement (jdphuff.c decode_mcu_AC_refine)
        const int p1 = 1 << al, m1 = -1 * (1 << al);
        int k = ss;
        if (eobrun_ == 0) {
            for (; k <= se; ++k) {
                int rs = br.decode(ac);
                int r = rs >> 4, s = rs & 15;
                if (s) {
                    s = br.get_bit() ? p1 : m1;
                } else if (r != 15) {
                    eobrun_ = 1 << r;
                    if (r) eobrun_ += br.get_bits(r);
                    break;
                }
                do {
                    int16_t* coef = blk + kNaturalOrder[k];
                    if (*coef != 0) {
                        if (br.get_bit() && (*coef & p1) == 0)
                            *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
                    } else {
                        if (--r < 0) break;
                    }
                    ++k;
                } while (k <= se);
                if (s) blk[kNaturalOrder[k]] = (int16_t)s;
            }
        }
        if (eobrun_ > 0) {
            for (; k <= se; ++k) {
                int16_t* coef = blk + kNaturalOrder[k];
                if (*coef != 0 && br.get_bit() && (*coef & p1) == 0)
                    *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
            }
            --eobrun_;
        }
    };

    for (int64_t m = 0; m < total; ++m) {
        if (restart_interval_) {
            if (restarts_left == 0) {
                br.restart();
                for (int ci : comps) comp_[ci].dc_pred = 0;
                eobrun_ = 0;
                restarts_left = restart_interval_;
            }
            --restarts_left;
        }
        const int mrow = (int)(m / mx), mcol = (int)(m % mx);
        if (single) {
            Component& c = comp_[comps[0]];
            block(c, &c.coef[((size_t)mrow * c.bw + mcol) * 64]);
        } else {
            for (int ci : comps) {
                Component& c = comp_[ci];
                for (int by = 0; by < c.v; ++by)
                    for (int bx = 0; bx < c.h; ++bx) {
                        size_t row = (size_t)mrow * c.v + by, col = (size_t)mcol * c.h + bx;
                        block(c, &c.coef[(row * c.bw + col) * 64]);
                    }
            }
        }
    }
    p_ = br.pos();
}

void Decoder::parse(bool headers_only) {
    p_ = data_;
    if (end_ - p_ < 2 || p_[0] != 0xFF || p_[1] != 0xD8) fail("not a JPEG (no SOI marker)");
    p_ += 2;
    for (;;) {
        // next marker (libjpeg's next_marker skips stray bytes, stuffed
        // 0xFF 0x00 pairs and fill 0xFFs)
        for (;;) {
            while (p_ < end_ && *p_ != 0xFF) ++p_;
            while (p_ < end_ && *p_ == 0xFF) ++p_;
            if (p_ >= end_ || *p_ != 0x00) break;
            ++p_;
        }
        if (p_ >= end_) {
            if (frame_ && !headers_only) return;  // no EOI: libjpeg warns and stops
            fail("unexpected end of JPEG data");
        }
        int marker = *p_++;
        if (marker == 0xD9) return;                  // EOI
        if (marker >= 0xD0 && marker <= 0xD7) continue;  // stray RSTn
        if (marker == 0x01) continue;                 // TEM
        switch (marker) {
            case 0xC4: read_dht(); break;
            case 0xDB: read_dqt(); break;
            case 0xDD: {
                if (u16() != 4) fail("bad DRI segment length");
                restart_interval_ = u16();
                break;
            }
            case 0xCC: fail("unsupported JPEG: arithmetic coding (DAC marker)");
            case 0xDA:
                if (headers_only) return;
                read_sos();
                break;
            case 0xDC: fail("unsupported JPEG: DNL marker");
            case 0xE0: case 0xEE: {
                int len = u16();
                if (len < 2 || end_ - p_ < len - 2) fail("unexpected end of JPEG data");
                if (marker == 0xE0 && len - 2 >= 14 && std::memcmp(p_, "JFIF\0", 5) == 0) jfif_ = true;
                if (marker == 0xEE && len >= 14 && std::memcmp(p_, "Adobe", 5) == 0) {
                    adobe_ = true;
                    adobe_transform_ = p_[11];
                }
                p_ += len - 2;
                break;
            }
            default:
                if (marker >= 0xC0 && marker <= 0xCF) {
                    read_sof(marker);
                } else {
                    int len = u16();
                    if (len < 2 || end_ - p_ < len - 2) fail("unexpected end of JPEG data");
                    p_ += len - 2;
                }
        }
    }
}

// ---------------------------------------------------------------------------
// IDCT (jidctint.c, jpeg_idct_islow)
// ---------------------------------------------------------------------------

constexpr int CONST_BITS = 13, PASS1_BITS = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

struct RangeLimit {
    // jdmaster.c prepare_range_limit_table; idct[] is the post-IDCT view
    // (sample_range_limit + CENTERJSAMPLE), read with & RANGE_MASK
    uint8_t table[5 * 256 + 128];
    const uint8_t* simple;  // sample_range_limit: clamp to 0..255
    const uint8_t* idct;
    RangeLimit() {
        uint8_t* t = table + 256;
        std::memset(table, 0, 256);
        for (int i = 0; i <= 255; ++i) t[i] = (uint8_t)i;
        simple = t;
        t += 128;
        for (int i = 128; i < 512; ++i) t[i] = 255;
        std::memset(t + 512, 0, 512 - 128);
        std::memcpy(t + 1024 - 128, simple, 128);
        idct = t;
    }
};

const RangeLimit kRange;

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
    int ws[64];
    const uint8_t* range = kRange.idct;
    for (int c = 0; c < 8; ++c) {
        const int16_t* ip = in + c;
        const uint16_t* qp = q + c;
        int* wp = ws + c;
        if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
            int dc = (int)((int64_t)ip[0] * qp[0] * (1 << PASS1_BITS));
            for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
            continue;
        }
        int64_t z2 = (int64_t)ip[16] * qp[16], z3 = (int64_t)ip[48] * qp[48];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        z2 = (int64_t)ip[0] * qp[0];
        z3 = (int64_t)ip[32] * qp[32];
        int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
        int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = (int64_t)ip[56] * qp[56];
        tmp1 = (int64_t)ip[40] * qp[40];
        tmp2 = (int64_t)ip[24] * qp[24];
        tmp3 = (int64_t)ip[8] * qp[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
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
        const int n = CONST_BITS - PASS1_BITS;
        wp[0] = (int)descale(tmp10 + tmp3, n);
        wp[56] = (int)descale(tmp10 - tmp3, n);
        wp[8] = (int)descale(tmp11 + tmp2, n);
        wp[48] = (int)descale(tmp11 - tmp2, n);
        wp[16] = (int)descale(tmp12 + tmp1, n);
        wp[40] = (int)descale(tmp12 - tmp1, n);
        wp[24] = (int)descale(tmp13 + tmp0, n);
        wp[32] = (int)descale(tmp13 - tmp0, n);
    }
    for (int r = 0; r < 8; ++r) {
        const int* wp = ws + 8 * r;
        uint8_t* op = out + (size_t)r * stride;
        if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
            uint8_t v = range[(int)descale(wp[0], PASS1_BITS + 3) & 1023];
            for (int c = 0; c < 8; ++c) op[c] = v;
            continue;
        }
        int64_t z2 = wp[2], z3 = wp[6];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << CONST_BITS);
        int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << CONST_BITS);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = wp[7];
        tmp1 = wp[5];
        tmp2 = wp[3];
        tmp3 = wp[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
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
        const int n = CONST_BITS + PASS1_BITS + 3;
        op[0] = range[(int)descale(tmp10 + tmp3, n) & 1023];
        op[7] = range[(int)descale(tmp10 - tmp3, n) & 1023];
        op[1] = range[(int)descale(tmp11 + tmp2, n) & 1023];
        op[6] = range[(int)descale(tmp11 - tmp2, n) & 1023];
        op[2] = range[(int)descale(tmp12 + tmp1, n) & 1023];
        op[5] = range[(int)descale(tmp12 - tmp1, n) & 1023];
        op[3] = range[(int)descale(tmp13 + tmp0, n) & 1023];
        op[4] = range[(int)descale(tmp13 - tmp0, n) & 1023];
    }
}

// ---------------------------------------------------------------------------
// Upsampling (jdsample.c) and colour conversion (jdcolor.c)
// ---------------------------------------------------------------------------

// A component's samples, (height, width) with the given row stride.
struct Plane {
    const uint8_t* p;
    int width, height, stride;
    const uint8_t* row(int y) const {  // rows past either edge repeat the edge row
        y = y < 0 ? 0 : (y >= height ? height - 1 : y);
        return p + (size_t)y * stride;
    }
};

// Upsample one component by (fh, fv) to (height * fv, width * fh) samples.
std::vector<uint8_t> upsample(const Plane& in, int fh, int fv, bool fancy) {
    const int ow = in.width * fh, oh = in.height * fv;
    std::vector<uint8_t> out((size_t)ow * oh);
    const int w = in.width;
    if (fancy && fh == 2 && fv == 1 && w > 2) {  // h2v1_fancy_upsample
        for (int y = 0; y < in.height; ++y) {
            const uint8_t* ip = in.row(y);
            uint8_t* op = &out[(size_t)y * ow];
            op[0] = ip[0];
            op[1] = (uint8_t)((ip[0] * 3 + ip[1] + 2) >> 2);
            for (int x = 1; x < w - 1; ++x) {
                int v = ip[x] * 3;
                op[2 * x] = (uint8_t)((v + ip[x - 1] + 1) >> 2);
                op[2 * x + 1] = (uint8_t)((v + ip[x + 1] + 2) >> 2);
            }
            op[2 * w - 2] = (uint8_t)((ip[w - 1] * 3 + ip[w - 2] + 1) >> 2);
            op[2 * w - 1] = ip[w - 1];
        }
        return out;
    }
    if (fancy && fh == 1 && fv == 2) {  // h1v2_fancy_upsample
        for (int y = 0; y < in.height; ++y) {
            const uint8_t* i0 = in.row(y);
            for (int v = 0; v < 2; ++v) {
                const uint8_t* i1 = in.row(v == 0 ? y - 1 : y + 1);
                const int bias = v == 0 ? 1 : 2;
                uint8_t* op = &out[(size_t)(2 * y + v) * ow];
                for (int x = 0; x < w; ++x) op[x] = (uint8_t)((i0[x] * 3 + i1[x] + bias) >> 2);
            }
        }
        return out;
    }
    if (fancy && fh == 2 && fv == 2 && w > 2) {  // h2v2_fancy_upsample
        for (int y = 0; y < in.height; ++y) {
            const uint8_t* i0 = in.row(y);
            for (int v = 0; v < 2; ++v) {
                const uint8_t* i1 = in.row(v == 0 ? y - 1 : y + 1);
                uint8_t* op = &out[(size_t)(2 * y + v) * ow];
                int this_sum = i0[0] * 3 + i1[0];
                int next_sum = i0[1] * 3 + i1[1];
                op[0] = (uint8_t)((this_sum * 4 + 8) >> 4);
                op[1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
                int last_sum = this_sum;
                this_sum = next_sum;
                for (int x = 2; x < w; ++x) {
                    next_sum = i0[x] * 3 + i1[x];
                    op[2 * x - 2] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
                    op[2 * x - 1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
                    last_sum = this_sum;
                    this_sum = next_sum;
                }
                op[2 * w - 2] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
                op[2 * w - 1] = (uint8_t)((this_sum * 4 + 7) >> 4);
            }
        }
        return out;
    }
    // int_upsample / h2v1_upsample / h2v2_upsample: replication
    for (int y = 0; y < oh; ++y) {
        const uint8_t* ip = in.row(y / fv);
        uint8_t* op = &out[(size_t)y * ow];
        for (int x = 0; x < ow; ++x) op[x] = ip[x / fh];
    }
    return out;
}

struct ColorTables {
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    ColorTables() {
        const int SCALEBITS = 16;
        const int64_t ONE_HALF = (int64_t)1 << (SCALEBITS - 1);
        auto fix = [](double x) { return (int64_t)(x * (1L << 16) + 0.5); };
        for (int i = 0, x = -128; i <= 255; ++i, ++x) {
            cr_r[i] = (int)((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
            cb_b[i] = (int)((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
            cr_g[i] = -fix(0.71414) * x;
            cb_g[i] = -fix(0.34414) * x + ONE_HALF;
        }
    }
};

const ColorTables kColor;

void Decoder::output(uint8_t* rgb) {
    for (int ci = 0; ci < ncomp_; ++ci)
        if (comp_[ci].coef.empty()) fail("JPEG component without any scan data");
    // IDCT every block into a padded plane per component
    std::vector<std::vector<uint8_t>> planes(ncomp_);
    std::vector<Plane> views(ncomp_);
    for (int ci = 0; ci < ncomp_; ++ci) {
        Component& c = comp_[ci];
        const int stride = c.bw * 8;
        std::vector<uint8_t>& pl = planes[ci];
        pl.assign((size_t)stride * c.bh * 8, 0);
        const int used_bw = (c.width + 7) / 8, used_bh = (c.height + 7) / 8;
        for (int by = 0; by < used_bh; ++by)
            for (int bx = 0; bx < used_bw; ++bx)
                idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], c.quant,
                           &pl[(size_t)by * 8 * stride + bx * 8], stride);
        views[ci] = Plane{pl.data(), c.width, c.height, stride};
    }
    // upsample each component to the full grid
    std::vector<std::vector<uint8_t>> full(ncomp_);
    std::vector<Plane> fviews(ncomp_);
    for (int ci = 0; ci < ncomp_; ++ci) {
        const Component& c = comp_[ci];
        const int fh = hmax_ / c.h, fv = vmax_ / c.v;
        if (fh == 1 && fv == 1) {
            fviews[ci] = views[ci];
            continue;
        }
        full[ci] = upsample(views[ci], fh, fv, true);
        fviews[ci] = Plane{full[ci].data(), c.width * fh, c.height * fv, c.width * fh};
    }
    const uint8_t* range = kRange.simple;
    bool ycc = ncomp_ == 3;
    if (ncomp_ == 3 && !jfif_) {
        if (adobe_) {
            ycc = adobe_transform_ != 0;
        } else if (comp_[0].id == 82 && comp_[1].id == 71 && comp_[2].id == 66) {
            ycc = false;  // component ids 'R', 'G', 'B'
        }
    }
    for (int y = 0; y < height; ++y) {
        uint8_t* op = rgb + (size_t)y * width * 3;
        if (ncomp_ == 1) {
            const uint8_t* g = fviews[0].row(y);
            for (int x = 0; x < width; ++x) op[3 * x] = op[3 * x + 1] = op[3 * x + 2] = g[x];
            continue;
        }
        const uint8_t* c0 = fviews[0].row(y);
        const uint8_t* c1 = fviews[1].row(y);
        const uint8_t* c2 = fviews[2].row(y);
        if (!ycc) {
            for (int x = 0; x < width; ++x) {
                op[3 * x] = c0[x];
                op[3 * x + 1] = c1[x];
                op[3 * x + 2] = c2[x];
            }
            continue;
        }
        for (int x = 0; x < width; ++x) {
            int yy = c0[x], cb = c1[x], cr = c2[x];
            op[3 * x] = range[yy + kColor.cr_r[cr]];
            op[3 * x + 1] = range[yy + (int)((kColor.cb_g[cb] + kColor.cr_g[cr]) >> 16)];
            op[3 * x + 2] = range[yy + kColor.cb_b[cb]];
        }
    }
}

void set_error(char* err, int errcap, const std::string& msg) {
    if (err && errcap > 0) {
        std::snprintf(err, (size_t)errcap, "%s", msg.c_str());
    }
}

}  // namespace

extern "C" {

int idt_jpeg_info(const uint8_t* data, int64_t n, int32_t* out, char* err, int errcap) {
    try {
        Decoder d(data, n);
        d.parse(true);
        if (!d.width) fail("JPEG without a frame header");
        out[0] = d.width;
        out[1] = d.height;
        out[2] = d.channels();
        out[3] = d.sof;
        return 0;
    } catch (const JpegError& e) {
        set_error(err, errcap, e.msg);
        return 1;
    } catch (const std::bad_alloc&) {
        set_error(err, errcap, "out of memory decoding a JPEG");
        return 1;
    }
}

int idt_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, char* err, int errcap) {
    try {
        Decoder d(data, n);
        d.parse(false);
        if (!d.width) fail("JPEG without a frame header");
        d.output(out);
        return 0;
    } catch (const JpegError& e) {
        set_error(err, errcap, e.msg);
        return 1;
    } catch (const std::bad_alloc&) {
        set_error(err, errcap, "out of memory decoding a JPEG");
        return 1;
    }
}

}  // extern "C"
