// Native host-side data ops for the InstanceDiffusion-TPU loader.
//
// The reference delegates these to pycocotools' C extension (RLE) and
// python loops; here they are standalone C++ behind a C ABI consumed via
// ctypes (instancediffusion_tpu/data/_native.py). Hot per-sample work in
// the training input pipeline:
//   * COCO compressed-RLE decode (30 instance masks x 512x512 per sample)
//   * RLE encode (dataset generation tooling)
//   * batched box rasterization (attention-mask rasters)
//   * uint8 image -> [-1,1] float32 normalize + HWC passthrough
//
// Build: make -C native   (g++ -O3 -march=native -shared -fPIC)

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Decode COCO compressed RLE 'counts' (LEB128-style 5-bit packing with
// delta coding from run 3 on) into a row-major uint8 mask of shape (h, w).
// Returns 0 on success.
int rle_decode(const char* counts, int64_t counts_len, int64_t h, int64_t w,
               uint8_t* out /* h*w, row-major */) {
    std::vector<int64_t> runs;
    runs.reserve(256);
    int64_t i = 0;
    while (i < counts_len) {
        int64_t x = 0;
        int k = 0;
        bool more = true;
        while (more) {
            if (i >= counts_len) return 1;
            int64_t c = (int64_t)counts[i] - 48;
            x |= (c & 0x1f) << (5 * k);
            more = (c & 0x20) != 0;
            ++i;
            ++k;
            if (!more && (c & 0x10)) x |= (int64_t)(-1) << (5 * k);
        }
        if (runs.size() > 2) x += runs[runs.size() - 2];
        runs.push_back(x);
    }
    // expand column-major, write transposed into row-major out
    std::memset(out, 0, (size_t)(h * w));
    int64_t pos = 0;  // column-major linear index
    uint8_t val = 0;
    const int64_t total = h * w;
    for (int64_t r = 0; r < (int64_t)runs.size(); ++r) {
        int64_t n = runs[r];
        if (val) {
            int64_t end = pos + n;
            if (end > total) end = total;
            for (int64_t p = pos; p < end; ++p) {
                const int64_t col = p / h;
                const int64_t row = p % h;
                out[row * w + col] = 1;
            }
        }
        pos += n;
        val ^= 1;
        if (pos >= total) break;
    }
    return 0;
}

// Encode a row-major (h, w) uint8 mask into COCO compressed RLE.
// Writes at most out_cap chars; returns the number written, or -1 if the
// buffer is too small.
int64_t rle_encode(const uint8_t* mask, int64_t h, int64_t w, char* out,
                   int64_t out_cap) {
    // column-major runs
    std::vector<int64_t> runs;
    runs.reserve(256);
    int64_t count = 0;
    uint8_t cur = 0;
    for (int64_t col = 0; col < w; ++col) {
        for (int64_t row = 0; row < h; ++row) {
            const uint8_t v = mask[row * w + col] ? 1 : 0;
            if (v != cur) {
                runs.push_back(count);
                count = 0;
                cur = v;
            }
            ++count;
        }
    }
    runs.push_back(count);

    int64_t n_out = 0;
    for (size_t r = 0; r < runs.size(); ++r) {
        int64_t x = runs[r];
        if (r > 2) x -= runs[r - 2];
        bool more = true;
        while (more) {
            int64_t c = x & 0x1f;
            x >>= 5;
            more = !((x == 0 && !(c & 0x10)) || (x == -1 && (c & 0x10)));
            if (more) c |= 0x20;
            if (n_out >= out_cap) return -1;
            out[n_out++] = (char)(c + 48);
        }
    }
    return n_out;
}

// Rasterize n boxes (xyxy in [0,1]) into (n, s, s) uint8 masks with the
// reference's row=x / col=y indexing (utils/input.py:34-37).
void rasterize_boxes(const float* boxes /* n*4 */, int64_t n, int64_t s,
                     uint8_t* out /* n*s*s */) {
    std::memset(out, 0, (size_t)(n * s * s));
    for (int64_t i = 0; i < n; ++i) {
        const float* b = boxes + i * 4;
        auto clampi = [s](long v) {
            if (v < 0) return (long)0;
            if (v > s) return (long)s;
            return v;
        };
        const long x1 = clampi(lroundf(b[0] * s));
        const long y1 = clampi(lroundf(b[1] * s));
        const long x2 = clampi(lroundf(b[2] * s));
        const long y2 = clampi(lroundf(b[3] * s));
        uint8_t* m = out + i * s * s;
        for (long r = x1; r < x2; ++r)
            for (long c = y1; c < y2; ++c) m[r * s + c] = 1;
    }
}

// uint8 HWC image -> float32 in [-1, 1] (decode_item.py:570: /127.5 - 1)
void normalize_image(const uint8_t* src, int64_t n, float* dst) {
    for (int64_t i = 0; i < n; ++i) dst[i] = (float)src[i] / 127.5f - 1.0f;
}

}  // extern "C"
