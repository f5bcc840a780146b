// Native multi-channel 3-D affine resampler for the data pipeline.
//
// Replaces the per-channel scipy.ndimage.affine_transform loop in
// RandAffined (the dominant host cost per training case, see
// PERFORMANCE.md "Host input pipeline"): the output->input coordinate
// transform and the trilinear corner weights are computed ONCE per output
// voxel and reused across all C channels, and the output volume is chunked
// over worker threads.  Semantics match scipy.ndimage.affine_transform
// (order 0/1, mode nearest/constant, prefilter=False): for output index
// o = (z, y, x), the sample point is  i = M @ o + offset.
//
// Reference context: the torch pipeline runs MONAI RandAffined inside 8
// loader processes (reference model_zoo train.yaml:190); this is the
// native single-process equivalent hot loop.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

inline int64_t clampi(int64_t v, int64_t hi) {
    return v < 0 ? 0 : (v > hi ? hi : v);
}

struct Task {
    const float* src;
    float* dst;
    int64_t C, D0, D1, D2;   // input spatial dims (per channel)
    int64_t O0, O1, O2;      // output spatial dims
    const double* m;         // 3x3 row-major, output -> input
    const double* off;       // 3
    int order;               // 0 nearest, 1 trilinear
    int pad_mode;            // 0 nearest(border clamp), 1 constant
    float cval;
};

void run_rows(const Task& t, int64_t z_begin, int64_t z_end) {
    const int64_t in_ch = t.D0 * t.D1 * t.D2;
    const int64_t out_ch = t.O0 * t.O1 * t.O2;
    const int64_t s0 = t.D1 * t.D2, s1 = t.D2;
    for (int64_t z = z_begin; z < z_end; ++z) {
        for (int64_t y = 0; y < t.O1; ++y) {
            // linear part along x is constant: precompute the base point
            double bz = t.m[0] * z + t.m[1] * y + t.off[0];
            double by = t.m[3] * z + t.m[4] * y + t.off[1];
            double bx = t.m[6] * z + t.m[7] * y + t.off[2];
            float* out_row = t.dst + (z * t.O1 + y) * t.O2;
            for (int64_t x = 0; x < t.O2; ++x) {
                const double iz = bz + t.m[2] * x;
                const double iy = by + t.m[5] * x;
                const double ix = bx + t.m[8] * x;
                float* out = out_row + x;
                // scipy mode='constant' (both orders): a coordinate outside
                // [0, size-1] in ANY dim yields cval outright, no blending.
                if (t.pad_mode == 1 &&
                    (iz < 0 || iz > t.D0 - 1 || iy < 0 || iy > t.D1 - 1 ||
                     ix < 0 || ix > t.D2 - 1)) {
                    for (int64_t c = 0; c < t.C; ++c) out[c * out_ch] = t.cval;
                    continue;
                }
                if (t.order == 0) {
                    const int64_t idx =
                        clampi((int64_t)std::floor(iz + 0.5), t.D0 - 1) * s0 +
                        clampi((int64_t)std::floor(iy + 0.5), t.D1 - 1) * s1 +
                        clampi((int64_t)std::floor(ix + 0.5), t.D2 - 1);
                    for (int64_t c = 0; c < t.C; ++c)
                        out[c * out_ch] = t.src[c * in_ch + idx];
                    continue;
                }
                // trilinear (corner indices clamped; at in-domain points a
                // clamped corner always carries zero weight)
                const double fz0 = std::floor(iz), fy0 = std::floor(iy),
                             fx0 = std::floor(ix);
                const double wz = iz - fz0, wy = iy - fy0, wx = ix - fx0;
                const int64_t z0 = (int64_t)fz0, y0 = (int64_t)fy0,
                              x0 = (int64_t)fx0;
                const double w[8] = {
                    (1 - wz) * (1 - wy) * (1 - wx), (1 - wz) * (1 - wy) * wx,
                    (1 - wz) * wy * (1 - wx),       (1 - wz) * wy * wx,
                    wz * (1 - wy) * (1 - wx),       wz * (1 - wy) * wx,
                    wz * wy * (1 - wx),             wz * wy * wx,
                };
                int64_t idx[8];
                for (int k = 0; k < 8; ++k) {
                    idx[k] = clampi(z0 + (k >> 2), t.D0 - 1) * s0 +
                             clampi(y0 + ((k >> 1) & 1), t.D1 - 1) * s1 +
                             clampi(x0 + (k & 1), t.D2 - 1);
                }
                for (int64_t c = 0; c < t.C; ++c) {
                    const float* s = t.src + c * in_ch;
                    double acc = 0.0;
                    for (int k = 0; k < 8; ++k) acc += w[k] * s[idx[k]];
                    out[c * out_ch] = (float)acc;
                }
            }
        }
    }
}

}  // namespace

extern "C" int ftx_affine_resample(
    const float* src, int64_t C, int64_t D0, int64_t D1, int64_t D2,
    const double* m, const double* off, float* dst, int64_t O0, int64_t O1,
    int64_t O2, int order, int pad_mode, float cval, int num_threads) {
    if (!src || !dst || C <= 0 || D0 <= 0 || D1 <= 0 || D2 <= 0 || O0 <= 0 ||
        O1 <= 0 || O2 <= 0)
        return 1;
    if (order != 0 && order != 1) return 2;
    if (pad_mode != 0 && pad_mode != 1) return 3;
    Task t{src, dst, C, D0, D1, D2, O0, O1, O2, m, off, order, pad_mode, cval};
    int nt = num_threads > 0
                 ? num_threads
                 : (int)std::max(1u, std::thread::hardware_concurrency());
    nt = (int)std::min<int64_t>(nt, O0);
    if (nt <= 1) {
        run_rows(t, 0, O0);
        return 0;
    }
    std::vector<std::thread> threads;
    const int64_t chunk = (O0 + nt - 1) / nt;
    for (int i = 0; i < nt; ++i) {
        const int64_t b = i * chunk, e = std::min<int64_t>(b + chunk, O0);
        if (b >= e) break;
        threads.emplace_back([&t, b, e] { run_rows(t, b, e); });
    }
    for (auto& th : threads) th.join();
    return 0;
}
