// The two 8-bit passes of PIL's BOX / BICUBIC resize (Resample.c,
// ImagingResampleHorizontal_8bpc / ImagingResampleVertical_8bpc) for the
// training loader, on coefficients `data/resample.coefficients` computes:
// bounds (out, 2) of (first tap, tap count) and fixed-point weights (out,
// ksize) with 22 fractional bits. Sums start at 1 << 21, are shifted right
// by 22 and clipped to 0..255, as `data/resample._pass` (numpy) does.
//
// C interface (ctypes, instancediffusion_tpu_torch/data/_native.py):
//   idt_resample_h(src, rows, in_w, ch, bounds, weights, ksize, out_w, dst)
//     (rows, in_w, ch) -> (rows, out_w, ch)
//   idt_resample_v(src, row_len, bounds, weights, ksize, out_h, dst)
//     (in_h, row_len) -> (out_h, row_len)

#include <cstdint>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;

inline uint8_t clip8(int64_t v) {
    v >>= kPrecisionBits;
    return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

}  // namespace

extern "C" {

void idt_resample_h(const uint8_t* src, int64_t rows, int64_t in_w, int64_t ch,
                    const int64_t* bounds, const int64_t* weights, int64_t ksize, int64_t out_w,
                    uint8_t* dst) {
    for (int64_t y = 0; y < rows; ++y) {
        const uint8_t* in = src + y * in_w * ch;
        uint8_t* out = dst + y * out_w * ch;
        for (int64_t x = 0; x < out_w; ++x) {
            const int64_t xmin = bounds[2 * x], n = bounds[2 * x + 1];
            const int64_t* k = weights + x * ksize;
            for (int64_t c = 0; c < ch; ++c) {
                int64_t ss = (int64_t)1 << (kPrecisionBits - 1);
                for (int64_t t = 0; t < n; ++t) ss += in[(xmin + t) * ch + c] * k[t];
                out[x * ch + c] = clip8(ss);
            }
        }
    }
}

void idt_resample_v(const uint8_t* src, int64_t row_len, const int64_t* bounds,
                    const int64_t* weights, int64_t ksize, int64_t out_h, uint8_t* dst) {
    for (int64_t y = 0; y < out_h; ++y) {
        const int64_t ymin = bounds[2 * y], n = bounds[2 * y + 1];
        const int64_t* k = weights + y * ksize;
        uint8_t* out = dst + y * row_len;
        for (int64_t i = 0; i < row_len; ++i) {
            int64_t ss = (int64_t)1 << (kPrecisionBits - 1);
            for (int64_t t = 0; t < n; ++t) ss += src[(ymin + t) * row_len + i] * k[t];
            out[i] = clip8(ss);
        }
    }
}

}  // extern "C"
