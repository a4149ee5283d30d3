// The two 8-bit passes of PIL's BOX / BICUBIC / LANCZOS resize (Resample.c,
// ImagingResampleHorizontal_8bpc / ImagingResampleVertical_8bpc) for the
// training loader and the CLI's --img2img, on coefficients `data/resample.coefficients` computes:
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

// OpenCV's cv::resize(INTER_CUBIC) passes on uint8 (resizeGeneric_ with
// HResizeCubic and VResizeCubic), on taps and 11-bit weights that
// `data/geometry._cubic_coefficients` computes:
//   idt_resize_cubic(src, in_h, in_w, ch, xofs, alpha, out_w, yofs, beta, out_h, dst)
//     xofs (out_w, 4) / yofs (out_h, 4) int64 source columns / rows (the
//     border already replicated), alpha / beta (.., 4) int64 weights.
// The horizontal pass sums int taps; the vertical pass takes, over the
// first whole groups of 8 values of each output row, OpenCV's SIMD float
// path (each row times weight / 2048^2 in float32, from the last tap to the
// first, rounded to even) and the integer path (+ 2^21 >> 22) over the
// rest; both saturate to 0..255.

#include <cmath>
#include <vector>

extern "C" void idt_resize_cubic(const uint8_t* src, int64_t in_h, int64_t in_w, int64_t ch,
                                 const int64_t* xofs, const int64_t* alpha, int64_t out_w,
                                 const int64_t* yofs, const int64_t* beta, int64_t out_h,
                                 uint8_t* dst) {
    const int64_t row = out_w * ch;
    std::vector<int32_t> hor((size_t)(in_h * row));
    for (int64_t y = 0; y < in_h; ++y) {
        const uint8_t* s = src + y * in_w * ch;
        int32_t* d = hor.data() + y * row;
        for (int64_t x = 0; x < out_w; ++x) {
            const int64_t* o = xofs + 4 * x;
            const int64_t* a = alpha + 4 * x;
            for (int64_t c = 0; c < ch; ++c) {
                int32_t v = 0;
                for (int k = 0; k < 4; ++k) v += (int32_t)s[o[k] * ch + c] * (int32_t)a[k];
                d[x * ch + c] = v;
            }
        }
    }
    const int64_t n_vec = row / 8 * 8;
    const float scale = 1.0f / (2048 * 2048);
    for (int64_t y = 0; y < out_h; ++y) {
        const int32_t* r[4];
        for (int k = 0; k < 4; ++k) r[k] = hor.data() + yofs[4 * y + k] * row;
        const int64_t* b = beta + 4 * y;
        float bf[4];
        for (int k = 0; k < 4; ++k) bf[k] = (float)b[k] * scale;
        uint8_t* d = dst + y * row;
        for (int64_t i = 0; i < row; ++i) {
            int64_t v;
            if (i < n_vec) {
                float acc = (float)r[3][i] * bf[3];
                acc = (float)r[2][i] * bf[2] + acc;
                acc = (float)r[1][i] * bf[1] + acc;
                acc = (float)r[0][i] * bf[0] + acc;
                v = (int64_t)std::nearbyint(acc);
            } else {
                v = ((int64_t)r[0][i] * b[0] + (int64_t)r[1][i] * b[1] + (int64_t)r[2][i] * b[2] +
                     (int64_t)r[3][i] * b[3] + ((int64_t)1 << 21)) >> 22;
            }
            d[i] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
        }
    }
}
