// Symmetric Chamfer loss on Hopper: nearest-neighbour forward and the
// deterministic backward, for (B, N, 3) float32 point clouds.
//
// Replaces (TPU): pointcloududa_tpu/ops/chamfer_pallas.py
//   - _chamfer_fwd_kernel / _chamfer_fwd   (whole N x M matrix in VMEM)
//   - _nn_tiled_kernel / _nn_directional_tiled (512-wide column tiles)
//   - _vjp_bwd (jnp: gathers + one-hot einsum / segment_sum scatter)
//
// What bounds it here: neither bytes nor FLOPs. A 300-point cloud is 3.6 KB;
// the N x M distance matrix is 360 KB per batch element, more than one
// block's 227 KB of shared memory. So the matrix never exists: each thread
// owns one query point, the partner cloud streams through shared memory in
// 256-point tiles, and only the running (min, argmin) stays in registers.
// At B=16, N=300 the launch is 32 blocks, so the kernel is latency-bound
// (one block per SM, few warps); it is simple on purpose.
//
// Numerics: the squared distance is |a|^2 + |b|^2 - 2 a.b, clamped at 0,
// with every product and sum rounded on its own (no FMA contraction) in the
// order of the plain PyTorch expansion (ops/losses.py:batch_pairwise_dist),
// so the kernel and its plain version pick the same argmin even on
// near-ties. The minimum is replaced only on a strict '<': ties keep the
// lowest index, as jnp.argmin and torch.min do.
//
// The backward scatter is built without atomics: each query point scans the
// partner cloud's argmin list for the entries that point back at it and
// sums their unit vectors in index order, so repeat runs give the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // query points per block
constexpr int kTile = 256;     // partner points staged per shared-memory tile
constexpr float kEps = 1e-5f;  // reference loss.py:68

__device__ __forceinline__ float sq3(float a0, float a1, float a2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, a0), __fmul_rn(a1, a1)), __fmul_rn(a2, a2));
}

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1,
                                      float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)), __fmul_rn(a2, b2));
}

// For each query a[b, i]: min over j of the clamped squared distance to
// c[b, j], and the lowest j that attains it.
__global__ void __launch_bounds__(kThreads)
    nn_kernel(const float* __restrict__ a, const float* __restrict__ c,
              float* __restrict__ min_out, int* __restrict__ idx_out, int n, int m) {
  __shared__ float cs[kTile * 3];
  __shared__ float ccs[kTile];
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const float* ab = a + static_cast<size_t>(b) * n * 3;
  const float* cb = c + static_cast<size_t>(b) * m * 3;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  if (i < n) {
    a0 = ab[3 * i];
    a1 = ab[3 * i + 1];
    a2 = ab[3 * i + 2];
  }
  const float aa = sq3(a0, a1, a2);
  float best = __int_as_float(0x7f800000);  // +inf
  int best_j = 0;
  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int cnt = min(kTile, m - t0);
    __syncthreads();  // the previous tile is fully consumed
    for (int k = threadIdx.x; k < cnt * 3; k += kThreads) cs[k] = cb[3 * t0 + k];
    __syncthreads();
    for (int k = threadIdx.x; k < cnt; k += kThreads)
      ccs[k] = sq3(cs[3 * k], cs[3 * k + 1], cs[3 * k + 2]);
    __syncthreads();
    for (int k = 0; k < cnt; ++k) {
      const float ac = dot3(a0, a1, a2, cs[3 * k], cs[3 * k + 1], cs[3 * k + 2]);
      float p = __fsub_rn(__fadd_rn(aa, ccs[k]), __fmul_rn(2.0f, ac));
      p = p < 0.f ? 0.f : p;
      if (p < best) {
        best = p;
        best_j = t0 + k;
      }
    }
  }
  if (i < n) {
    min_out[static_cast<size_t>(b) * n + i] = best;
    idx_out[static_cast<size_t>(b) * n + i] = best_j;
  }
}

// Gradient of the loss with respect to one cloud a (n points), given the
// other cloud c (m points), a's argmins into c (idx_ac) and c's argmins into
// a (idx_ca):  da_i = g/(B n) * u_i - g/(B m) * sum_{k: idx_ca[k] == i} v_k,
// u_i = (a_i - c_{idx_ac[i]}) / sqrt(|.|^2 + eps),
// v_k = (c_k - a_i) / sqrt(|.|^2 + eps).
__global__ void __launch_bounds__(kThreads)
    side_grad_kernel(const float* __restrict__ a, const float* __restrict__ c,
                     const int* __restrict__ idx_ac, const int* __restrict__ idx_ca,
                     const float* __restrict__ g, float* __restrict__ da, int batch, int n,
                     int m) {
  __shared__ float cs[kTile * 3];
  __shared__ int ids[kTile];
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const float* ab = a + static_cast<size_t>(b) * n * 3;
  const float* cb = c + static_cast<size_t>(b) * m * 3;
  const int* icb = idx_ca + static_cast<size_t>(b) * m;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  float u0 = 0.f, u1 = 0.f, u2 = 0.f;
  if (i < n) {
    a0 = ab[3 * i];
    a1 = ab[3 * i + 1];
    a2 = ab[3 * i + 2];
    const int j = idx_ac[static_cast<size_t>(b) * n + i];
    const float d0 = __fsub_rn(a0, cb[3 * j]);
    const float d1 = __fsub_rn(a1, cb[3 * j + 1]);
    const float d2 = __fsub_rn(a2, cb[3 * j + 2]);
    const float d = __fsqrt_rn(__fadd_rn(sq3(d0, d1, d2), kEps));
    u0 = __fdiv_rn(d0, d);
    u1 = __fdiv_rn(d1, d);
    u2 = __fdiv_rn(d2, d);
  }
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int cnt = min(kTile, m - t0);
    __syncthreads();
    for (int k = threadIdx.x; k < cnt * 3; k += kThreads) cs[k] = cb[3 * t0 + k];
    for (int k = threadIdx.x; k < cnt; k += kThreads) ids[k] = icb[t0 + k];
    __syncthreads();
    for (int k = 0; k < cnt; ++k) {
      if (ids[k] == i) {
        const float d0 = __fsub_rn(cs[3 * k], a0);
        const float d1 = __fsub_rn(cs[3 * k + 1], a1);
        const float d2 = __fsub_rn(cs[3 * k + 2], a2);
        const float d = __fsqrt_rn(__fadd_rn(sq3(d0, d1, d2), kEps));
        s0 = __fadd_rn(s0, __fdiv_rn(d0, d));
        s1 = __fadd_rn(s1, __fdiv_rn(d1, d));
        s2 = __fadd_rn(s2, __fdiv_rn(d2, d));
      }
    }
  }
  if (i < n) {
    const float gv = g[0];
    const float g_self = __fdiv_rn(gv, static_cast<float>(batch) * static_cast<float>(n));
    const float g_other = __fdiv_rn(gv, static_cast<float>(batch) * static_cast<float>(m));
    float* out = da + (static_cast<size_t>(b) * n + i) * 3;
    out[0] = __fsub_rn(__fmul_rn(g_self, u0), __fmul_rn(g_other, s0));
    out[1] = __fsub_rn(__fmul_rn(g_self, u1), __fmul_rn(g_other, s1));
    out[2] = __fsub_rn(__fmul_rn(g_self, u2), __fmul_rn(g_other, s2));
  }
}

}  // namespace

extern "C" {

// a (batch, n, 3), c (batch, m, 3) -> min_out (batch, n) f32, idx_out (batch, n) i32.
int pcuda_chamfer_nn(const float* a, const float* c, float* min_out, int* idx_out, int batch,
                     int n, int m, cudaStream_t stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, batch);
  nn_kernel<<<grid, kThreads, 0, stream>>>(a, c, min_out, idx_out, n, m);
  return static_cast<int>(cudaGetLastError());
}

// a (batch, n, 3), c (batch, m, 3), idx_ac (batch, n), idx_ca (batch, m),
// g: one f32 on the device -> da (batch, n, 3).
int pcuda_chamfer_side_grad(const float* a, const float* c, const int* idx_ac,
                            const int* idx_ca, const float* g, float* da, int batch, int n,
                            int m, cudaStream_t stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, batch);
  side_grad_kernel<<<grid, kThreads, 0, stream>>>(a, c, idx_ac, idx_ca, g, da, batch, n, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
