// Host-side assignment solver and letterbox of the PyTorch port
// (aicamera_tpu_torch/native), the port's own copy of the JAX package's
// native/aicam_host.cpp, with the same semantics:
//
//  - lapjv_solve: Jonker-Volgenant shortest-augmenting-path optimal
//    assignment (a CPU associator and an oracle for the tracker's solver).
//  - letterbox_u8: fused bilinear resize + pad + BGR->RGB + [0,1]
//    normalize producing HWC float32 (a CPU path; the GPU runs
//    csrc/letterbox.cu).
//  - blend_glyphs: the text of utils/visualization.py: glyph alpha masks
//    blended into a frame one after another, as OpenCV's putText does.
//
// Built by aicamera_tpu_torch/ops/host_build.py; loaded with ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

extern "C" {

// Solve the rectangular assignment problem: minimize sum of cost[i, col_i]
// over distinct columns. cost is row-major (nr x nc), nr <= nc required
// (transpose on the caller side otherwise). Writes col4row[nr] (assigned
// column per row). Returns 0 on success.
int lapjv_solve(const float* cost, int nr, int nc, int* col4row) {
    if (nr <= 0 || nc <= 0 || nr > nc) return -1;
    const double INF = std::numeric_limits<double>::infinity();

    std::vector<double> u(nr, 0.0), v(nc, 0.0);
    std::vector<int> row4col(nc, -1);
    std::vector<int> path(nc, -1);
    std::vector<double> shortest(nc);
    std::vector<char> sr(nr), sc(nc);

    for (int cur = 0; cur < nr; ++cur) {
        std::fill(shortest.begin(), shortest.end(), INF);
        std::fill(sr.begin(), sr.end(), 0);
        std::fill(sc.begin(), sc.end(), 0);

        double min_val = 0.0;
        int i = cur;
        int sink = -1;
        while (sink == -1) {
            sr[i] = 1;
            int j_min = -1;
            double lowest = INF;
            for (int j = 0; j < nc; ++j) {
                if (sc[j]) continue;
                double r = min_val + (double)cost[(size_t)i * nc + j]
                           - u[i] - v[j];
                if (r < shortest[j]) {
                    shortest[j] = r;
                    path[j] = i;
                }
                if (shortest[j] < lowest ||
                    (shortest[j] == lowest && row4col[j] == -1)) {
                    lowest = shortest[j];
                    j_min = j;
                }
            }
            if (j_min < 0 || lowest == INF) return -2;  // infeasible
            min_val = lowest;
            sc[j_min] = 1;
            if (row4col[j_min] == -1) {
                sink = j_min;
            } else {
                i = row4col[j_min];
            }
        }

        // dual updates (col4row is maintained incrementally in the output)
        u[cur] += min_val;
        for (int r = 0; r < nr; ++r) {
            if (sr[r] && r != cur) {
                u[r] += min_val - shortest[col4row[r]];
            }
        }
        for (int j = 0; j < nc; ++j) {
            if (sc[j]) v[j] -= min_val - shortest[j];
        }

        // augment along the alternating path back from the sink
        int j = sink;
        while (true) {
            int pi = path[j];
            row4col[j] = pi;
            int tmp = col4row[pi];
            col4row[pi] = j;
            if (pi == cur) break;
            j = tmp;
        }
    }
    return 0;
}

// Fused letterbox: uint8 BGR HWC (src_h x src_w x 3) -> float32 RGB NHWC
// (dst_h x dst_w x 3), bilinear (cv2 half-pixel convention, no
// antialiasing), 114-padding outside the content box, values in [0, 1].
// unpad_h/unpad_w/top/left define the content placement (computed by the
// Python letterbox_spec — reference image_processing.py:37-67 semantics).
void letterbox_u8(const uint8_t* src, int src_h, int src_w,
                  float* dst, int dst_h, int dst_w,
                  int unpad_h, int unpad_w, int top, int left) {
    const float pad = 114.0f / 255.0f;
    const float inv255 = 1.0f / 255.0f;
    const float sy_scale = (float)src_h / (float)unpad_h;
    const float sx_scale = (float)src_w / (float)unpad_w;

    // precompute horizontal taps
    std::vector<int> x0(unpad_w);
    std::vector<float> fx(unpad_w);
    for (int x = 0; x < unpad_w; ++x) {
        float sx = (x + 0.5f) * sx_scale - 0.5f;
        sx = std::min(std::max(sx, 0.0f), (float)(src_w - 1));
        int i0 = (int)sx;
        i0 = std::min(i0, src_w - 1);
        x0[x] = i0;
        fx[x] = sx - (float)i0;
    }

    for (int y = 0; y < dst_h; ++y) {
        float* out_row = dst + (size_t)y * dst_w * 3;
        if (y < top || y >= top + unpad_h) {
            for (int x = 0; x < dst_w * 3; ++x) out_row[x] = pad;
            continue;
        }
        float sy = (y - top + 0.5f) * sy_scale - 0.5f;
        sy = std::min(std::max(sy, 0.0f), (float)(src_h - 1));
        int y0i = std::min((int)sy, src_h - 1);
        int y1i = std::min(y0i + 1, src_h - 1);
        float fy = sy - (float)y0i;
        const uint8_t* r0 = src + (size_t)y0i * src_w * 3;
        const uint8_t* r1 = src + (size_t)y1i * src_w * 3;

        for (int x = 0; x < left; ++x)
            for (int c = 0; c < 3; ++c) out_row[x * 3 + c] = pad;
        for (int x = 0; x < unpad_w; ++x) {
            int i0 = x0[x];
            int i1 = std::min(i0 + 1, src_w - 1);
            float f = fx[x];
            float* o = out_row + (size_t)(left + x) * 3;
            for (int c = 0; c < 3; ++c) {
                float a = (1.0f - fy) * r0[i0 * 3 + c] + fy * r1[i0 * 3 + c];
                float b = (1.0f - fy) * r0[i1 * 3 + c] + fy * r1[i1 * 3 + c];
                float val = (1.0f - f) * a + f * b;
                // BGR -> RGB: channel c of output takes source channel 2-c
                o[2 - c] = std::nearbyint(val) * inv255;
            }
        }
        for (int x = left + unpad_w; x < dst_w; ++x)
            for (int c = 0; c < 3; ++c) out_row[x * 3 + c] = pad;
    }
}

// Blend `n` glyph masks into an (h, w, 3) uint8 frame, in order:
// pixel = (pixel * (255 - a) + color * a + 127) / 255 per channel, each
// mask clipped to the frame. glyphs holds n rows of (y0, x0, rows, cols,
// offset of the mask in alpha).
void blend_glyphs(uint8_t* frame, int h, int w, const uint8_t* alpha,
                  const int32_t* glyphs, int n, const int32_t* color) {
    for (int g = 0; g < n; ++g) {
        const int32_t* q = glyphs + 5 * g;
        const int y0 = q[0], x0 = q[1], gh = q[2], gw = q[3];
        const uint8_t* a = alpha + q[4];
        const int ya = std::max(y0, 0), yb = std::min(y0 + gh, h);
        const int xa = std::max(x0, 0), xb = std::min(x0 + gw, w);
        for (int y = ya; y < yb; ++y) {
            const uint8_t* ar = a + (size_t)(y - y0) * gw - x0;
            uint8_t* px = frame + ((size_t)y * w) * 3;
            for (int x = xa; x < xb; ++x) {
                const int m = ar[x];
                if (m == 0) continue;  // (p * 255 + 127) / 255 == p
                for (int c = 0; c < 3; ++c) {
                    const int p = px[3 * x + c];
                    px[3 * x + c] =
                        (uint8_t)((p * (255 - m) + color[c] * m + 127) / 255);
                }
            }
        }
    }
}

// Undo PNG's scanline filters (PNG spec, section 9). `raw` holds h rows of
// (filter type, stride bytes), `out` receives h * stride bytes; bpp is the
// bytes a pixel. Returns 0, or 1 + the row of an unknown filter type.
int png_unfilter(const uint8_t* raw, int h, int64_t stride, int bpp,
                 uint8_t* out) {
    for (int y = 0; y < h; ++y) {
        const uint8_t* cur = raw + (size_t)y * (stride + 1);
        const int kind = *cur++;
        if (kind > 4) return y + 1;
        uint8_t* o = out + (size_t)y * stride;
        const uint8_t* up = y ? o - stride : nullptr;
        for (int64_t i = 0; i < stride; ++i) {
            const int a = i >= bpp ? o[i - bpp] : 0;
            const int b = up ? up[i] : 0;
            int pred = 0;
            if (kind == 1) {
                pred = a;
            } else if (kind == 2) {
                pred = b;
            } else if (kind == 3) {
                pred = (a + b) >> 1;
            } else if (kind == 4) {  // Paeth
                const int c = up && i >= bpp ? up[i - bpp] : 0;
                const int pa = std::abs(b - c), pb = std::abs(a - c),
                          pc = std::abs(a + b - 2 * c);
                pred = pa <= pb && pa <= pc ? a : pb <= pc ? b : c;
            }
            o[i] = (uint8_t)(cur[i] + pred);
        }
    }
    return 0;
}

}  // extern "C"
