// The training loader's polygon points. Border following: the same traces,
// points and order as `data/geometry.find_contours_numpy`, which follows
// cv2.findContours(RETR_LIST, CHAIN_APPROX_NONE) (Suzuki and Abe). Interior
// points: `idt_uniform_sparse_points`, below.
//
// C interface (ctypes, instancediffusion_tpu_torch/data/_native.py):
//   idt_find_contours(mask, h, w, points, points_cap, lengths, lengths_cap)
//     mask: (h, w) uint8, nonzero = foreground
//     points: (points_cap, 2) int32 (x, y); lengths: (lengths_cap,) int64
//     returns the number of contours, in the order they were found (the
//     numpy version lists them last found first), or -1 when a buffer is
//     too small; lengths[0] and lengths[1] then hold the points and
//     contours needed
//   idt_uniform_sparse_points(mask, h, w, k, out): see below

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

// (dy, dx), counter-clockwise from the right with y growing downwards
const int kDy[8] = {0, -1, -1, -1, 0, 1, 1, 1};
const int kDx[8] = {1, 1, 0, -1, -1, -1, 0, 1};
const int8_t kVisited = 2;
const int8_t kRightEdge = -126;

struct Tracer {
    std::vector<int8_t> img;  // (h + 2, w + 2), zero-padded
    int64_t stride;
    std::vector<int32_t> pts;
    std::vector<int64_t> lengths;

    int8_t& at(int64_t y, int64_t x) { return img[y * stride + x]; }

    void follow(int64_t y0, int64_t x0, bool is_hole) {
        const size_t start = pts.size();
        int s_end = is_hole ? 0 : 4;
        int s = s_end;
        int64_t dy = 0, dx = 0;
        for (;;) {  // clockwise for the first foreground neighbour
            s = (s - 1) & 7;
            dy = kDy[s];
            dx = kDx[s];
            if (at(y0 + dy, x0 + dx) != 0 || s == s_end) break;
        }
        if (s == s_end) {  // an isolated pixel
            at(y0, x0) = kRightEdge;
            pts.push_back((int32_t)(x0 - 1));
            pts.push_back((int32_t)(y0 - 1));
            lengths.push_back(1);
            return;
        }
        const int64_t y1 = y0 + dy, x1 = x0 + dx;
        int64_t y3 = y0, x3 = x0, y4, x4;
        for (;;) {
            s_end = s;
            for (;;) {  // counter-clockwise from the pixel we came from
                ++s;
                y4 = y3 + kDy[s & 7];
                x4 = x3 + kDx[s & 7];
                if (at(y4, x4) != 0) break;
            }
            s &= 7;
            if (1 <= s && s <= s_end) {
                at(y3, x3) = kRightEdge;
            } else if (at(y3, x3) == 1) {
                at(y3, x3) = kVisited;
            }
            pts.push_back((int32_t)(x3 - 1));
            pts.push_back((int32_t)(y3 - 1));
            if (y4 == y0 && x4 == x0 && y3 == y1 && x3 == x1) break;
            y3 = y4;
            x3 = x4;
            s = (s + 4) & 7;
        }
        lengths.push_back((int64_t)(pts.size() - start) / 2);
    }
};

struct Ranked {
    double dist;
    int64_t index;
    bool operator<(const Ranked& o) const {
        return dist < o.dist || (dist == o.dist && index < o.index);
    }
};

using It = std::vector<Ranked>::iterator;

// Put the elements of the sorted order's ranks [r0, r1) (ascending, counted
// from base, all within [lo, hi)) in their places.
void select_ranks(It base, It lo, It hi, const int64_t* r0, const int64_t* r1) {
    if (r0 >= r1 || hi - lo <= 1) return;
    const int64_t* mid = r0 + (r1 - r0) / 2;
    It nth = base + *mid;
    std::nth_element(lo, nth, hi);
    select_ranks(base, lo, nth, r0, mid);
    select_ranks(base, nth + 1, hi, mid + 1, r1);
}

}  // namespace

extern "C" int64_t idt_find_contours(const uint8_t* mask, int64_t h, int64_t w, int32_t* points,
                                     int64_t points_cap, int64_t* lengths, int64_t lengths_cap) {
    Tracer t;
    t.stride = w + 2;
    t.img.assign((size_t)((h + 2) * (w + 2)), 0);
    for (int64_t y = 0; y < h; ++y)
        for (int64_t x = 0; x < w; ++x) t.at(y + 1, x + 1) = mask[y * w + x] != 0;
    for (int64_t y = 1; y <= h; ++y) {
        for (int64_t x = 1; x <= w; ++x) {
            const int8_t p = t.at(y, x), prev = t.at(y, x - 1);
            if (prev == 0 && p == 1) {
                t.follow(y, x, false);  // an outer border, not yet traced
            } else if (p == 0 && prev >= 1) {
                t.follow(y, x - 1, true);  // a hole border
            }
        }
    }
    const int64_t n_pts = (int64_t)t.pts.size() / 2, n = (int64_t)t.lengths.size();
    if (n_pts > points_cap || n > lengths_cap) {
        if (lengths_cap >= 2) {
            lengths[0] = n_pts;
            lengths[1] = n;
        }
        return -1;
    }
    for (size_t i = 0; i < t.pts.size(); ++i) points[i] = t.pts[i];
    for (int64_t i = 0; i < n; ++i) lengths[i] = t.lengths[i];
    return n;
}

// `data/geometry.sample_uniform_sparse_points_numpy` without its RNG branch:
// the foreground pixels of a (h, w) mask in raster order, ranked (stably) by
// distance to their centroid, cut into k equal segments; each segment's
// middle pixel, as (x, y) doubles into out (k, 2). Returns the number of
// foreground pixels; out is written only when there are at least k.
extern "C" int64_t idt_uniform_sparse_points(const uint8_t* mask, int64_t h, int64_t w,
                                             int64_t k, double* out) {
    std::vector<int64_t> rows, cols;
    int64_t sum_r = 0, sum_c = 0;
    for (int64_t y = 0; y < h; ++y)
        for (int64_t x = 0; x < w; ++x)
            if (mask[y * w + x] == 1) {
                rows.push_back(y);
                cols.push_back(x);
                sum_r += y;
                sum_c += x;
            }
    const int64_t n = (int64_t)rows.size();
    if (n == 0 || n < k) return n;
    // numpy: fg.mean(axis=0) (integer sums, exact in float64), then
    // np.linalg.norm(fg - center, axis=1)
    const double cr = (double)sum_r / (double)n, cc = (double)sum_c / (double)n;
    // the pixels at the k wanted ranks of numpy's stable argsort: rank by
    // (distance, raster index), which no two pixels share, and select those
    // ranks alone (nth_element on halves) rather than sorting all n
    std::vector<Ranked> px(n);
    for (int64_t i = 0; i < n; ++i) {
        const double dr = (double)rows[i] - cr, dc = (double)cols[i] - cc;
        px[i] = Ranked{std::sqrt(dr * dr + dc * dc), i};
    }
    const int64_t per = n / k;
    std::vector<int64_t> ranks(k);
    for (int64_t i = 0; i < k; ++i) ranks[i] = i * per + per / 2;
    select_ranks(px.begin(), px.begin(), px.end(), ranks.data(), ranks.data() + k);
    for (int64_t i = 0; i < k; ++i) {
        const int64_t j = px[ranks[i]].index;
        out[2 * i] = (double)cols[j];
        out[2 * i + 1] = (double)rows[j];
    }
    return n;
}
