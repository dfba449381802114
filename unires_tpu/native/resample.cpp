// Native CPU resampling trio: pull / push / pull_grad.
//
// Independent reference implementation of the framework's resampling
// semantics (trilinear/nearest, zero bound, extrapolate=False with the
// [-0.5, n-0.5] FOV convention) — the same contract the reference pins on
// nitorch's compiled backend (unires/_project.py:164-188). Used as:
//   * an oracle for the XLA paths (tests/test_native.py, chip_smoke.py), and
//   * a fast host-side path for CPU-only utilities.
//
// Built by unires_tpu/native/build.py with g++ -O3 -shared; bound via ctypes.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Dims {
    int64_t x, y, z;
};

inline float sample_zero(const float* vol, const Dims& d, int64_t i,
                         int64_t j, int64_t k) {
    if (i < 0 || i >= d.x || j < 0 || j >= d.y || k < 0 || k >= d.z)
        return 0.0f;
    return vol[(i * d.y + j) * d.z + k];
}

template <typename Fn>
void parallel_for(int64_t n, Fn&& fn) {
    unsigned hw = std::thread::hardware_concurrency();
    int64_t nthread = hw ? static_cast<int64_t>(hw) : 4;
    if (nthread > n) nthread = n > 0 ? n : 1;
    std::vector<std::thread> threads;
    int64_t chunk = (n + nthread - 1) / nthread;
    for (int64_t t = 0; t < nthread; ++t) {
        int64_t lo = t * chunk;
        int64_t hi = lo + chunk < n ? lo + chunk : n;
        if (lo >= hi) break;
        threads.emplace_back([=, &fn]() { fn(lo, hi); });
    }
    for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// out[(i,j,k)] = vol sampled at g = M @ (i,j,k,1); M is (3,4) row-major.
void unires_pull_f32(const float* vol, const int64_t* in_dim, const float* M,
                     const int64_t* out_dim, int order, float* out) {
    Dims di{in_dim[0], in_dim[1], in_dim[2]};
    Dims dq{out_dim[0], out_dim[1], out_dim[2]};
    parallel_for(dq.x, [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i)
            for (int64_t j = 0; j < dq.y; ++j)
                for (int64_t k = 0; k < dq.z; ++k) {
                    float g[3];
                    for (int d = 0; d < 3; ++d)
                        g[d] = M[4 * d + 0] * (float)i + M[4 * d + 1] * (float)j +
                               M[4 * d + 2] * (float)k + M[4 * d + 3];
                    bool fov = g[0] >= -0.5f && g[0] <= (float)di.x - 0.5f &&
                               g[1] >= -0.5f && g[1] <= (float)di.y - 0.5f &&
                               g[2] >= -0.5f && g[2] <= (float)di.z - 0.5f;
                    float val = 0.0f;
                    if (fov) {
                        if (order == 0) {
                            int64_t ii = (int64_t)std::floor(g[0] + 0.5f);
                            int64_t jj = (int64_t)std::floor(g[1] + 0.5f);
                            int64_t kk = (int64_t)std::floor(g[2] + 0.5f);
                            val = sample_zero(vol, di, ii, jj, kk);
                        } else {
                            int64_t i0 = (int64_t)std::floor(g[0]);
                            int64_t j0 = (int64_t)std::floor(g[1]);
                            int64_t k0 = (int64_t)std::floor(g[2]);
                            float fx = g[0] - (float)i0;
                            float fy = g[1] - (float)j0;
                            float fz = g[2] - (float)k0;
                            for (int a = 0; a < 2; ++a)
                                for (int b = 0; b < 2; ++b)
                                    for (int c = 0; c < 2; ++c) {
                                        float w = (a ? fx : 1.0f - fx) *
                                                  (b ? fy : 1.0f - fy) *
                                                  (c ? fz : 1.0f - fz);
                                        val += w * sample_zero(vol, di, i0 + a,
                                                               j0 + b, k0 + c);
                                    }
                        }
                    }
                    out[(i * dq.y + j) * dq.z + k] = val;
                }
    });
}

// Exact adjoint of pull: out (vol_dim) accumulates w * vals over the pull's
// sampling pattern. Serial scatter per thread-private buffer, then reduce.
void unires_push_f32(const float* vals, const int64_t* vals_dim,
                     const float* M, const int64_t* vol_dim, int order,
                     float* out) {
    Dims dv{vals_dim[0], vals_dim[1], vals_dim[2]};
    Dims dq{vol_dim[0], vol_dim[1], vol_dim[2]};
    int64_t n_out = dq.x * dq.y * dq.z;
    std::memset(out, 0, sizeof(float) * n_out);

    unsigned hw = std::thread::hardware_concurrency();
    int64_t nthread = hw ? static_cast<int64_t>(hw) : 4;
    if (nthread > dv.x) nthread = dv.x > 0 ? dv.x : 1;
    std::vector<std::vector<float>> partial(
        (size_t)nthread, std::vector<float>((size_t)n_out, 0.0f));
    std::vector<std::thread> threads;
    int64_t chunk = (dv.x + nthread - 1) / nthread;
    for (int64_t t = 0; t < nthread; ++t) {
        int64_t lo = t * chunk;
        int64_t hi = lo + chunk < dv.x ? lo + chunk : dv.x;
        if (lo >= hi) break;
        threads.emplace_back([&, t, lo, hi]() {
            float* acc = partial[(size_t)t].data();
            for (int64_t i = lo; i < hi; ++i)
                for (int64_t j = 0; j < dv.y; ++j)
                    for (int64_t k = 0; k < dv.z; ++k) {
                        float g[3];
                        for (int d = 0; d < 3; ++d)
                            g[d] = M[4 * d + 0] * (float)i +
                                   M[4 * d + 1] * (float)j +
                                   M[4 * d + 2] * (float)k + M[4 * d + 3];
                        bool fov = g[0] >= -0.5f && g[0] <= (float)dq.x - 0.5f &&
                                   g[1] >= -0.5f && g[1] <= (float)dq.y - 0.5f &&
                                   g[2] >= -0.5f && g[2] <= (float)dq.z - 0.5f;
                        if (!fov) continue;
                        float v = vals[(i * dv.y + j) * dv.z + k];
                        if (order == 0) {
                            int64_t ii = (int64_t)std::floor(g[0] + 0.5f);
                            int64_t jj = (int64_t)std::floor(g[1] + 0.5f);
                            int64_t kk = (int64_t)std::floor(g[2] + 0.5f);
                            if (ii >= 0 && ii < dq.x && jj >= 0 && jj < dq.y &&
                                kk >= 0 && kk < dq.z)
                                acc[(ii * dq.y + jj) * dq.z + kk] += v;
                            continue;
                        }
                        int64_t i0 = (int64_t)std::floor(g[0]);
                        int64_t j0 = (int64_t)std::floor(g[1]);
                        int64_t k0 = (int64_t)std::floor(g[2]);
                        float fx = g[0] - (float)i0;
                        float fy = g[1] - (float)j0;
                        float fz = g[2] - (float)k0;
                        for (int a = 0; a < 2; ++a)
                            for (int b = 0; b < 2; ++b)
                                for (int c = 0; c < 2; ++c) {
                                    int64_t ii = i0 + a, jj = j0 + b, kk = k0 + c;
                                    if (ii < 0 || ii >= dq.x || jj < 0 ||
                                        jj >= dq.y || kk < 0 || kk >= dq.z)
                                        continue;
                                    float w = (a ? fx : 1.0f - fx) *
                                              (b ? fy : 1.0f - fy) *
                                              (c ? fz : 1.0f - fz);
                                    acc[(ii * dq.y + jj) * dq.z + kk] += w * v;
                                }
                    }
        });
    }
    for (auto& th : threads) th.join();
    for (auto& buf : partial)
        for (int64_t n = 0; n < n_out; ++n) out[n] += buf[(size_t)n];
}

// d pull / d g: out shape out_dim x 3 (trilinear only).
void unires_pull_grad_f32(const float* vol, const int64_t* in_dim,
                          const float* M, const int64_t* out_dim, float* out) {
    Dims di{in_dim[0], in_dim[1], in_dim[2]};
    Dims dq{out_dim[0], out_dim[1], out_dim[2]};
    parallel_for(dq.x, [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i)
            for (int64_t j = 0; j < dq.y; ++j)
                for (int64_t k = 0; k < dq.z; ++k) {
                    float g[3];
                    for (int d = 0; d < 3; ++d)
                        g[d] = M[4 * d + 0] * (float)i + M[4 * d + 1] * (float)j +
                               M[4 * d + 2] * (float)k + M[4 * d + 3];
                    bool fov = g[0] >= -0.5f && g[0] <= (float)di.x - 0.5f &&
                               g[1] >= -0.5f && g[1] <= (float)di.y - 0.5f &&
                               g[2] >= -0.5f && g[2] <= (float)di.z - 0.5f;
                    float gr[3] = {0.0f, 0.0f, 0.0f};
                    if (fov) {
                        int64_t i0 = (int64_t)std::floor(g[0]);
                        int64_t j0 = (int64_t)std::floor(g[1]);
                        int64_t k0 = (int64_t)std::floor(g[2]);
                        float fx = g[0] - (float)i0;
                        float fy = g[1] - (float)j0;
                        float fz = g[2] - (float)k0;
                        for (int a = 0; a < 2; ++a)
                            for (int b = 0; b < 2; ++b)
                                for (int c = 0; c < 2; ++c) {
                                    float v = sample_zero(vol, di, i0 + a,
                                                          j0 + b, k0 + c);
                                    float wx = a ? fx : 1.0f - fx;
                                    float wy = b ? fy : 1.0f - fy;
                                    float wz = c ? fz : 1.0f - fz;
                                    gr[0] += (a ? 1.0f : -1.0f) * wy * wz * v;
                                    gr[1] += wx * (b ? 1.0f : -1.0f) * wz * v;
                                    gr[2] += wx * wy * (c ? 1.0f : -1.0f) * v;
                                }
                    }
                    int64_t base = ((i * dq.y + j) * dq.z + k) * 3;
                    out[base + 0] = gr[0];
                    out[base + 1] = gr[1];
                    out[base + 2] = gr[2];
                }
    });
}

}  // extern "C"
