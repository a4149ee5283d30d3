// cv2.fillPoly(mask, polygons, value) on a uint8 (H, W) mask with integer
// vertices, shift 0 and LINE_8, as OpenCV's drawing.cpp does it:
//   * CollectPolyEdges: each edge, from the last vertex to the first and
//     then in order, is first drawn as an 8-connected line (LineIterator,
//     left to right, clipped with clipLine); its scan edge keeps its rows
//     and has x in 16.16 fixed point; an edge with an end off the image
//     takes the x of its clipped ends (and their rows, unless clipping left
//     both ends on one row), even where clipLine found it outside;
//     horizontal edges add no scan edge
//   * FillEdgeCollection: edges sorted by (y0, x, dx), an active list kept
//     in x order by bubble sort, each row filled between pairs of active
//     edges from ceil(x_left) to floor(x_right), both inclusive, clipped to
//     the row
// Every polygon of one call goes into one edge collection, so overlapping
// parts cancel by parity as in OpenCV.
//
// C interface (ctypes, instancediffusion_tpu_torch/data/_native.py):
//   void idt_fill_poly(mask, h, w, points, counts, n_polys, value)
//     points: (sum(counts), 2) int64 (x, y); counts: (n_polys,) int64

#include <algorithm>
#include <climits>
#include <cstdint>
#include <vector>

namespace {

constexpr int kShift = 16;
constexpr int64_t kOne = (int64_t)1 << kShift;

struct Pt {
    int64_t x, y;
};

struct Edge {
    int y0, y1;
    int64_t x, dx;
    Edge* next;
};

// OpenCV's clipLine on a (w, h) image; true when some of the line is inside
bool clip_line(int64_t w, int64_t h, Pt& p1, Pt& p2) {
    if (w <= 0 || h <= 0) return false;
    const int64_t right = w - 1, bottom = h - 1;
    int64_t &x1 = p1.x, &y1 = p1.y, &x2 = p2.x, &y2 = p2.y;
    int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
    int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
        int64_t a;
        if (c1 & 12) {
            a = c1 < 8 ? 0 : bottom;
            x1 += (int64_t)((double)(a - y1) * (x2 - x1) / (y2 - y1));
            y1 = a;
            c1 = (x1 < 0) + (x1 > right) * 2;
        }
        if (c2 & 12) {
            a = c2 < 8 ? 0 : bottom;
            x2 += (int64_t)((double)(a - y2) * (x2 - x1) / (y2 - y1));
            y2 = a;
            c2 = (x2 < 0) + (x2 > right) * 2;
        }
        if ((c1 & c2) == 0 && (c1 | c2) != 0) {
            if (c1) {
                a = c1 == 1 ? 0 : right;
                y1 += (int64_t)((double)(a - x1) * (y2 - y1) / (x2 - x1));
                x1 = a;
                c1 = 0;
            }
            if (c2) {
                a = c2 == 1 ? 0 : right;
                y2 += (int64_t)((double)(a - x2) * (y2 - y1) / (x2 - x1));
                x2 = a;
                c2 = 0;
            }
        }
    }
    return (c1 | c2) == 0;
}

// Line(img, p1, p2, color, 8): LineIterator with leftToRight, clipped to
// the image (its ends converted to int, as cv::Point holds them)
void draw_line(uint8_t* img, int64_t w, int64_t h, Pt a, Pt b, uint8_t value) {
    Pt p1{(int)a.x, (int)a.y}, p2{(int)b.x, (int)b.y};
    if ((uint64_t)p1.x >= (uint64_t)w || (uint64_t)p2.x >= (uint64_t)w ||
        (uint64_t)p1.y >= (uint64_t)h || (uint64_t)p2.y >= (uint64_t)h) {
        Pt q1{p1.x, p1.y}, q2{p2.x, p2.y};
        if (!clip_line(w, h, q1, q2)) return;
        p1 = Pt{(int)q1.x, (int)q1.y};
        p2 = Pt{(int)q2.x, (int)q2.y};
    }
    int64_t delta_x = 1, delta_y = 1;
    int64_t dx = p2.x - p1.x, dy = p2.y - p1.y;
    if (dx < 0) {  // left to right
        dx = -dx;
        dy = -dy;
        std::swap(p1, p2);
    }
    if (dy < 0) {
        dy = -dy;
        delta_y = -1;
    }
    const bool vert = dy > dx;
    if (vert) {
        std::swap(dx, dy);
        std::swap(delta_x, delta_y);
    }
    int64_t err = dx - (dy + dy);
    const int64_t plus_delta = dx + dx, minus_delta = -(dy + dy);
    // the major axis steps every pixel, the minor one when err was negative
    int64_t major = delta_x, minor = delta_y;
    int64_t x = p1.x, y = p1.y;
    for (int64_t i = 0; i <= dx; ++i) {
        img[y * w + x] = value;
        const bool step = err < 0;
        err += minus_delta + (step ? plus_delta : 0);
        if (vert) {
            y += major;
            if (step) x += minor;
        } else {
            x += major;
            if (step) y += minor;
        }
    }
}

void collect_edges(uint8_t* img, int64_t w, int64_t h, const Pt* v, int64_t count,
                   std::vector<Edge>& edges, uint8_t value) {
    Pt pt0 = v[count - 1];
    pt0.x <<= kShift;
    for (int64_t i = 0; i < count; ++i) {
        Pt pt1 = v[i];
        pt1.x <<= kShift;
        Pt pt0c = pt0, pt1c = pt1;
        Pt t0{(pt0.x + (kOne >> 1)) >> kShift, pt0.y};
        Pt t1{(pt1.x + (kOne >> 1)) >> kShift, pt1.y};
        draw_line(img, w, h, t0, t1, value);
        if ((uint64_t)t0.x >= (uint64_t)w || (uint64_t)t1.x >= (uint64_t)w ||
            (uint64_t)t0.y >= (uint64_t)h || (uint64_t)t1.y >= (uint64_t)h) {
            clip_line(w, h, t0, t1);
            if (t0.y != t1.y) {
                pt0c.y = t0.y;
                pt1c.y = t1.y;
            }
            pt0c.x = t0.x << kShift;
            pt1c.x = t1.x << kShift;
        }
        if (pt0.y != pt1.y) {
            Edge e;
            e.dx = (pt1c.x - pt0c.x) / (pt1c.y - pt0c.y);
            if (pt0.y < pt1.y) {
                e.y0 = (int)pt0.y;
                e.y1 = (int)pt1.y;
                e.x = pt0c.x + (pt0.y - pt0c.y) * e.dx;
            } else {
                e.y0 = (int)pt1.y;
                e.y1 = (int)pt0.y;
                e.x = pt1c.x + (pt1.y - pt1c.y) * e.dx;
            }
            e.next = nullptr;
            edges.push_back(e);
        }
        pt0 = pt1;
    }
}

void fill_edges(uint8_t* img, int64_t w, int64_t h, std::vector<Edge>& edges, uint8_t value) {
    const int total = (int)edges.size();
    if (total < 2) return;
    int y_max = INT_MIN, y_min = INT_MAX;
    int64_t x_max = INT64_MIN, x_min = INT64_MAX;
    for (const Edge& e : edges) {
        const int64_t x1 = e.x + (e.y1 - e.y0) * e.dx;
        y_min = std::min(y_min, e.y0);
        y_max = std::max(y_max, e.y1);
        x_min = std::min({x_min, e.x, x1});
        x_max = std::max({x_max, e.x, x1});
    }
    if (y_max < 0 || y_min >= h || x_max < 0 || x_min >= (w << kShift)) return;
    std::sort(edges.begin(), edges.end(), [](const Edge& a, const Edge& b) {
        if (a.y0 != b.y0) return a.y0 < b.y0;
        if (a.x != b.x) return a.x < b.x;
        return a.dx < b.dx;
    });
    Edge head;
    head.y0 = INT_MAX;
    edges.push_back(head);  // the sentinel
    head.next = nullptr;
    int i = 0;
    Edge* e = &edges[0];
    y_max = std::min<int64_t>(y_max, h);
    for (int y = e->y0; y < y_max; ++y) {
        Edge *last, *prelast, *keep_prelast;
        int draw = 0;
        const bool clipline = y < 0;
        prelast = &head;
        last = head.next;
        while (last || e->y0 == y) {
            if (last && last->y1 == y) {  // the edge ends: drop it
                prelast->next = last->next;
                last = last->next;
                continue;
            }
            keep_prelast = prelast;
            if (last && (e->y0 > y || last->x < e->x)) {
                prelast = last;
                last = last->next;
            } else if (i < total) {  // the next edge starts: insert it
                prelast->next = e;
                e->next = last;
                prelast = e;
                e = &edges[++i];
            } else {
                break;
            }
            if (draw) {
                if (!clipline) {
                    int64_t x1, x2;
                    if (keep_prelast->x > prelast->x) {
                        x1 = (prelast->x + kOne - 1) >> kShift;
                        x2 = keep_prelast->x >> kShift;
                    } else {
                        x1 = (keep_prelast->x + kOne - 1) >> kShift;
                        x2 = prelast->x >> kShift;
                    }
                    if (x1 < w && x2 >= 0) {
                        x1 = std::max<int64_t>(x1, 0);
                        x2 = std::min<int64_t>(x2, w - 1);
                        if (x1 <= x2) std::fill(img + y * w + x1, img + y * w + x2 + 1, value);
                    }
                }
                keep_prelast->x += keep_prelast->dx;
                prelast->x += prelast->dx;
            }
            draw ^= 1;
        }
        // bubble sort of the active list by x
        keep_prelast = nullptr;
        do {
            prelast = &head;
            last = head.next;
            Edge* last_exchange = nullptr;
            while (last != keep_prelast && last->next != nullptr) {
                Edge* te = last->next;
                if (last->x > te->x) {
                    prelast->next = te;
                    last->next = te->next;
                    te->next = last;
                    prelast = te;
                    last_exchange = prelast;
                } else {
                    prelast = last;
                    last = te;
                }
            }
            if (last_exchange == nullptr) break;
            keep_prelast = last_exchange;
        } while (keep_prelast != head.next && keep_prelast != &head);
    }
}

}  // namespace

extern "C" {

void idt_fill_poly(uint8_t* mask, int64_t h, int64_t w, const int64_t* points,
                   const int64_t* counts, int64_t n_polys, int64_t value) {
    std::vector<Edge> edges;
    int64_t off = 0;
    for (int64_t p = 0; p < n_polys; ++p) {
        std::vector<Pt> v((size_t)counts[p]);
        for (int64_t k = 0; k < counts[p]; ++k) {
            v[k] = Pt{points[2 * (off + k)], points[2 * (off + k) + 1]};
        }
        if (counts[p] > 0) collect_edges(mask, w, h, v.data(), counts[p], edges, (uint8_t)value);
        off += counts[p];
    }
    fill_edges(mask, w, h, edges, (uint8_t)value);
}

}  // extern "C"
