// BatchNorm batch statistics on Hopper: per-channel mean and mean of
// squares (forward) and their gradient (backward).
//
// Replaces (TPU): pointcloududa_tpu/ops/bn_pallas.py
//   - _stats_kernel / _stats_fwd_impl (one pass over (rows, C) blocks,
//     (C,) partials carried across the sequential grid in VMEM)
//   - _bn_stats_bwd (jnp: dx = g_m / N + 2 x g_q / N)
//
// What bounds it here: device-memory bandwidth. Each element is read once
// (forward) or read and written once (backward) and takes two FMAs, far
// below the card's FLOP/byte balance. The TPU kernel carried its partial
// sums from one grid step to the next; blocks on this card run in parallel
// and in no order, so the forward is two launches instead: block (s, c)
// reduces chunk s of channel c into a partial buffer in a fixed
// thread/warp order, and a second small launch adds the partials of each
// channel in index order. No atomics, so repeat runs give the same bits.
//
// Layout: x is read as (outer, C, inner), contiguous. The model's NCHW
// activations are (N, C, H*W), whose per-channel planes are contiguous, so
// neighbouring threads read neighbouring addresses. A (rows, C) matrix is
// the case inner == 1 (correct, but its reads are strided by C). float32
// only: the port computes in float32.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Block (s, c): sum and sum of squares of elements [s*chunk, (s+1)*chunk) of
// channel c, where a channel's element e sits at (e / inner, c, e % inner).
__global__ void __launch_bounds__(kThreads)
    stats_partial_kernel(const float* __restrict__ x, float* __restrict__ part_s,
                         float* __restrict__ part_q, unsigned c_dim, unsigned inner,
                         unsigned per_chan, unsigned chunk) {
  const unsigned s = blockIdx.x;
  const unsigned c = blockIdx.y;
  const unsigned begin = s * chunk;
  const unsigned end = min(begin + chunk, per_chan);
  float acc_s = 0.f, acc_q = 0.f;
  for (unsigned e = begin + threadIdx.x; e < end; e += kThreads) {
    const unsigned o = e / inner;
    const unsigned i = e - o * inner;
    const float v = x[(static_cast<size_t>(o) * c_dim + c) * inner + i];
    acc_s += v;
    acc_q = fmaf(v, v, acc_q);
  }
  __shared__ float ws[kThreads / 32];
  __shared__ float wq[kThreads / 32];
  acc_s = warp_sum(acc_s);
  acc_q = warp_sum(acc_q);
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    ws[warp] = acc_s;
    wq[warp] = acc_q;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ts = 0.f, tq = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) {
      ts += ws[w];
      tq += wq[w];
    }
    part_s[static_cast<size_t>(c) * gridDim.x + s] = ts;
    part_q[static_cast<size_t>(c) * gridDim.x + s] = tq;
  }
}

// One thread per channel adds its partials in index order.
__global__ void stats_final_kernel(const float* __restrict__ part_s,
                                   const float* __restrict__ part_q, float* __restrict__ mean,
                                   float* __restrict__ meansq, unsigned c_dim, unsigned splits,
                                   float inv_n) {
  const unsigned c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= c_dim) return;
  float ts = 0.f, tq = 0.f;
  for (unsigned s = 0; s < splits; ++s) {
    ts += part_s[static_cast<size_t>(c) * splits + s];
    tq += part_q[static_cast<size_t>(c) * splits + s];
  }
  mean[c] = ts * inv_n;
  meansq[c] = tq * inv_n;
}

// dx = g_m[c] / N + x * (2 / N) * g_q[c], in f32.
__global__ void __launch_bounds__(kThreads)
    stats_backward_kernel(const float* __restrict__ x, const float* __restrict__ g_mean,
                          const float* __restrict__ g_meansq, float* __restrict__ dx,
                          unsigned c_dim, unsigned inner, unsigned total, float inv_n) {
  const float two_inv_n = 2.0f * inv_n;
  for (unsigned e = blockIdx.x * kThreads + threadIdx.x; e < total; e += gridDim.x * kThreads) {
    const unsigned c = (e / inner) % c_dim;
    dx[e] = __fadd_rn(__fmul_rn(g_mean[c], inv_n), __fmul_rn(__fmul_rn(x[e], two_inv_n), g_meansq[c]));
  }
}

}  // namespace

extern "C" {

// x (outer, c_dim, inner) contiguous f32; part_s, part_q: c_dim * splits f32
// scratch; mean, meansq: c_dim f32.
int pcuda_bn_stats_forward(const float* x, float* part_s, float* part_q, float* mean,
                           float* meansq, int outer, int c_dim, int inner, int splits,
                           cudaStream_t stream) {
  const unsigned per_chan = static_cast<unsigned>(outer) * static_cast<unsigned>(inner);
  const unsigned chunk = (per_chan + splits - 1) / splits;
  stats_partial_kernel<<<dim3(splits, c_dim), kThreads, 0, stream>>>(x, part_s, part_q, c_dim,
                                                                     inner, per_chan, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_final_kernel<<<(c_dim + 127) / 128, 128, 0, stream>>>(
      part_s, part_q, mean, meansq, c_dim, splits, 1.0f / static_cast<float>(per_chan));
  return static_cast<int>(cudaGetLastError());
}

// g_mean, g_meansq: c_dim f32; dx has x's shape.
int pcuda_bn_stats_backward(const float* x, const float* g_mean, const float* g_meansq,
                            float* dx, int outer, int c_dim, int inner, cudaStream_t stream) {
  const unsigned per_chan = static_cast<unsigned>(outer) * static_cast<unsigned>(inner);
  const unsigned total = per_chan * static_cast<unsigned>(c_dim);
  const unsigned blocks = min((total + kThreads - 1) / kThreads, 132u * 16u);
  stats_backward_kernel<<<blocks, kThreads, 0, stream>>>(x, g_mean, g_meansq, dx, c_dim, inner,
                                                         total, 1.0f / static_cast<float>(per_chan));
  return static_cast<int>(cudaGetLastError());
}

const char* pcuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
