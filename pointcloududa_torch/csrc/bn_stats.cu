// BatchNorm batch statistics on Hopper: per-channel mean and mean of
// squares (forward) and their gradient (backward).
//
// Replaces (TPU): pointcloududa_tpu/ops/bn_pallas.py
//   - _stats_kernel / _stats_fwd_impl (one pass over (rows, C) blocks,
//     (C,) partials carried across the sequential grid in VMEM; x read in
//     its own dtype and widened to f32 in-register)
//   - _bn_stats_bwd (jnp: dx = g_m / N + 2 x g_q / N in f32, cast to x's
//     dtype)
//
// What bounds it here: device-memory bandwidth. Each element is read once
// (forward) or read and written once (backward) and takes two or three
// flops, far below the card's FLOP/byte balance. What keeps a kernel from
// that bound is the instructions around each byte and too few bytes in
// flight, so both kernels move 16 bytes a load or store (8 bfloat16 or 4
// float32 values) with several loads in flight per thread, and neither
// divides per element: a thread finds its place in the tensor with one
// division when it starts and then carries (plane, position) forward with a
// compare and a subtract.
//
// Forward, one launch. The TPU kernel carried its partial sums from one
// grid step to the next; blocks on this card run in parallel and in no
// order. Here each channel is shared by a thread-block cluster of S blocks
// (S in 1..8, chosen by ops/bn_kernel.py:forward_plan so that C x S blocks
// fill the card about twice in one wave). Rank r reduces the contiguous
// groups [r*chunk, (r+1)*chunk) of its channel in a fixed thread, unroll
// and warp order into a pair in its shared memory; after a cluster barrier
// rank 0 reads the S pairs through distributed shared memory and adds them
// in a fixed order. No atomics and no partial buffer in device memory, so
// repeat runs give the same bits; a second barrier keeps every block's
// shared memory alive until rank 0 has read it.
//
// Backward, one launch over the flattened tensor: thread t of the grid
// takes vectors t, t + T, t + 2T, ... (T threads in all), kBackwardUnroll
// of them in flight (the grid is sized for one such round a thread), and carries its channel forward from vector to
// vector. The per-element arithmetic and its rounding are those of the plain
// version on the card: __fadd_rn(__fmul_rn(g_m, 1/N), __fmul_rn(__fmul_rn(v, 2/N),
// g_q)), rounded once to x's type; no FMA contraction.
//
// Layout: x is read as (outer, C, inner), contiguous. The model's NCHW
// activations are (N, C, H*W), whose per-channel planes are contiguous. A
// (rows, C) matrix is the case inner == 1 (correct, but strided by C).
// Vectors are used where inner is a multiple of the vector width and the
// tensors are 16-byte aligned, so that every vector lies inside one plane;
// otherwise the same kernels run one value at a time (VEC == 1).
//
// Types: x is float32 or bfloat16 (the port's two compute dtypes); the
// statistics, their gradients and every sum are float32. A bfloat16 value
// is widened by shifting its 16 bits into a float's top half; dx is rounded
// to bfloat16 to nearest even, as the TPU kernel's astype does.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // a block of either kernel (ops/bn_kernel.py: THREADS)
constexpr int kWarps = kThreads / 32;
// vectors a thread has in flight: the forward runs ~2 blocks an SM, so 8;
// the backward takes at most 64 registers a thread, so that 4 blocks share
// an SM (ops/bn_kernel.py: BACKWARD_UNROLL)
constexpr int kForwardUnroll = 8;
constexpr int kBackwardUnroll = 4;
constexpr int kBackwardBlocksPerSm = 4;
constexpr int kMaxCluster = 8;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

// lo and hi rounded to bfloat16 (nearest even), lo in the low half
__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// VEC consecutive values of x at p, widened to f32, in index order.
template <typename T, int VEC>
__device__ __forceinline__ void load(const T* __restrict__ p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    if constexpr (sizeof(T) == 4) v[0] = __ldg(p);
    else v[0] = __bfloat162float(__ldg(p));
  } else if constexpr (sizeof(T) == 4) {
    static_assert(VEC == 4, "float32 vectors are 4 values");
    const float4 r = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  } else {
    static_assert(VEC == 8, "bfloat16 vectors are 8 values");
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // little endian: element 2k is the low half of word k; a bfloat16 is
      // the top half of the float32 with the same value
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}

// VEC f32 values rounded to x's type and stored at p.
template <typename T, int VEC>
__device__ __forceinline__ void store(T* __restrict__ p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    *p = narrow<T>(v[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    uint4 r;
    r.x = bf16_pair(v[0], v[1]);
    r.y = bf16_pair(v[2], v[3]);
    r.z = bf16_pair(v[4], v[5]);
    r.w = bf16_pair(v[6], v[7]);
    *reinterpret_cast<uint4*>(p) = r;
  }
}

template <int VEC>
__device__ __forceinline__ void accumulate(const float (&v)[VEC], float& s, float& q) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    s += v[e];
    q = fmaf(v[e], v[e], q);
  }
}

// Grid (S, C), clusters of (S, 1, 1): rank r of the cluster in column c sums
// the groups [r*chunk, min((r+1)*chunk, groups)) of channel c, where group g
// is the VEC values at (g / inner_v, c, (g % inner_v) * VEC); rank 0 adds
// the S pairs and writes out[c] = mean, out[C + c] = mean of squares.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    stats_forward_kernel(const T* __restrict__ x, float* __restrict__ out, unsigned c_dim, unsigned inner_v,
                         unsigned groups, unsigned chunk, float inv_n) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const unsigned c = blockIdx.y;
  const unsigned begin = static_cast<unsigned>(
      min(static_cast<unsigned long long>(rank) * chunk, static_cast<unsigned long long>(groups)));
  const unsigned end = min(begin + chunk, groups);
  constexpr int kUnroll = kForwardUnroll;
  float s[kUnroll] = {}, q[kUnroll] = {};

  unsigned g = begin + threadIdx.x;
  if (g < end) {
    // the thread's first group, then a step of kThreads groups carried as
    // (planes, position) with one compare: no division inside the loop
    unsigned o = g / inner_v;
    unsigned i = g - o * inner_v;
    const size_t plane = static_cast<size_t>(c_dim) * inner_v * VEC;  // elements from one plane of c to the next
    size_t off = (static_cast<size_t>(o) * c_dim + c) * inner_v * VEC + static_cast<size_t>(i) * VEC;
    const unsigned step_o = kThreads / inner_v;
    const unsigned step_i = kThreads - step_o * inner_v;
    const size_t step = step_o * plane + static_cast<size_t>(step_i) * VEC;
    const size_t wrap = plane - static_cast<size_t>(inner_v) * VEC;
    auto advance = [&]() {
      off += step;
      i += step_i;
      if (i >= inner_v) {
        i -= inner_v;
        off += wrap;
      }
    };
    for (; g + (kUnroll - 1) * kThreads < end; g += kUnroll * kThreads) {
      float v[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        load<T, VEC>(x + off, v[u]);
        advance();
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) accumulate<VEC>(v[u], s[u], q[u]);
    }
    for (; g < end; g += kThreads) {
      float v[VEC];
      load<T, VEC>(x + off, v);
      advance();
      accumulate<VEC>(v, s[0], q[0]);
    }
  }

  float ts = s[0], tq = q[0];
#pragma unroll
  for (int u = 1; u < kUnroll; ++u) {
    ts += s[u];
    tq += q[u];
  }
  __shared__ float ws[kWarps];
  __shared__ float wq[kWarps];
  __shared__ float2 pair;  // this block's (sum, sum of squares), read by rank 0
  ts = warp_sum(ts);
  tq = warp_sum(tq);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    ws[warp] = ts;
    wq[warp] = tq;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bs = 0.f, bq = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      bs += ws[w];
      bq += wq[w];
    }
    pair = make_float2(bs, bq);
  }
  cluster.sync();  // every rank's pair is written
  if (rank == 0 && warp == 0) {
    float2 p = make_float2(0.f, 0.f);
    if (lane < static_cast<int>(cluster.num_blocks())) p = *cluster.map_shared_rank(&pair, lane);
    p.x = warp_sum(p.x);
    p.y = warp_sum(p.y);
    if (lane == 0) {
      out[c] = p.x * inv_n;
      out[c_dim + c] = p.y * inv_n;
    }
  }
  cluster.sync();  // no block leaves while rank 0 may still read its pair
}

// dx = g_m[c] / N + x * (2 / N) * g_q[c], in f32, stored in x's type; the
// tensor as total_v groups of VEC values, inner_v groups to a plane.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kBackwardBlocksPerSm)
    stats_backward_kernel(const T* __restrict__ x, const float* __restrict__ g_mean,
                          const float* __restrict__ g_meansq, T* __restrict__ dx, unsigned c_dim,
                          unsigned inner_v, unsigned total_v, float inv_n) {
  constexpr int kUnroll = kBackwardUnroll;
  const float two_inv_n = 2.0f * inv_n;
  const unsigned stride = gridDim.x * kThreads;
  unsigned g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= total_v) return;
  // (channel, position in the plane) of the first group, and the stride as
  // (channels, positions): carried forward without dividing
  const unsigned p0 = g / inner_v;
  unsigned i = g - p0 * inner_v;
  unsigned c = p0 % c_dim;
  const unsigned step_p = stride / inner_v;
  const unsigned step_i = stride - step_p * inner_v;
  const unsigned step_c = step_p % c_dim;
  auto advance = [&]() {
    i += step_i;
    c += step_c;
    if (i >= inner_v) {
      i -= inner_v;
      ++c;
    }
    if (c >= c_dim) c -= c_dim;
  };
  auto grad = [&](float (&v)[VEC], unsigned ch) {
    const float a = __fmul_rn(__ldg(g_mean + ch), inv_n);
    const float b = __ldg(g_meansq + ch);
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = __fadd_rn(a, __fmul_rn(__fmul_rn(v[e], two_inv_n), b));
  };
  for (; g + (kUnroll - 1) * stride < total_v; g += kUnroll * stride) {
    float v[kUnroll][VEC];
    unsigned ch[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      load<T, VEC>(x + static_cast<size_t>(g + u * stride) * VEC, v[u]);
      ch[u] = c;
      advance();
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      grad(v[u], ch[u]);
      store<T, VEC>(dx + static_cast<size_t>(g + u * stride) * VEC, v[u]);
    }
  }
  for (; g < total_v; g += stride) {
    float v[VEC];
    load<T, VEC>(x + static_cast<size_t>(g) * VEC, v);
    grad(v, c);
    store<T, VEC>(dx + static_cast<size_t>(g) * VEC, v);
    advance();
  }
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

cudaLaunchConfig_t forward_config(int c_dim, int cluster, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(cluster), static_cast<unsigned>(c_dim));
  config.blockDim = dim3(kThreads);
  config.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

template <typename T, int VEC>
cudaError_t launch_forward(const T* x, float* out, int outer, int c_dim, int inner, int cluster, int chunk,
                           cudaStream_t stream) {
  const unsigned inner_v = static_cast<unsigned>(inner) / VEC;
  const unsigned groups = static_cast<unsigned>(outer) * inner_v;
  if (static_cast<unsigned long long>(chunk) * static_cast<unsigned>(cluster) < groups)
    return cudaErrorInvalidValue;  // the ranks' ranges would leave groups out
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config = forward_config(c_dim, cluster, stream, &attr);
  const float inv_n = 1.0f / static_cast<float>(static_cast<unsigned>(outer) * static_cast<unsigned>(inner));
  const cudaError_t err = cudaLaunchKernelEx(&config, stats_forward_kernel<T, VEC>, x, out,
                                             static_cast<unsigned>(c_dim), inner_v, groups,
                                             static_cast<unsigned>(chunk), inv_n);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch is reported once, not left pending
    return err;
  }
  return cudaGetLastError();
}

// vec: values per load, 1 or the type's vector width (4 float32, 8 bfloat16),
// which needs inner % vec == 0 and x 16-byte aligned.
template <typename T>
int stats_forward(const T* x, float* out, int outer, int c_dim, int inner, int cluster, int vec, int chunk,
                  cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (outer < 1 || inner < 1 || c_dim < 1 || c_dim > 65535 || cluster < 1 || cluster > kMaxCluster || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec == kVec && inner % kVec == 0 && aligned(x))
    return static_cast<int>(launch_forward<T, kVec>(x, out, outer, c_dim, inner, cluster, chunk, stream));
  if (vec == 1) return static_cast<int>(launch_forward<T, 1>(x, out, outer, c_dim, inner, cluster, chunk, stream));
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int stats_backward(const T* x, const float* g_mean, const float* g_meansq, T* dx, int outer, int c_dim,
                   int inner, int vec, int blocks, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (outer < 1 || inner < 1 || c_dim < 1 || blocks < 1 || blocks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float inv_n = 1.0f / static_cast<float>(static_cast<unsigned>(outer) * static_cast<unsigned>(inner));
  const unsigned total = static_cast<unsigned>(outer) * static_cast<unsigned>(c_dim) * static_cast<unsigned>(inner);
  if (vec == kVec && inner % kVec == 0 && aligned(x) && aligned(dx)) {
    stats_backward_kernel<T, kVec><<<blocks, kThreads, 0, stream>>>(
        x, g_mean, g_meansq, dx, static_cast<unsigned>(c_dim), static_cast<unsigned>(inner) / kVec, total / kVec,
        inv_n);
  } else if (vec == 1) {
    stats_backward_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(
        x, g_mean, g_meansq, dx, static_cast<unsigned>(c_dim), static_cast<unsigned>(inner), total, inv_n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
cudaError_t forward_clusters(int cluster, int* clusters) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config = forward_config(1, cluster, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(clusters, stats_forward_kernel<T, VEC>, &config);
}

}  // namespace

extern "C" {

// x (outer, c_dim, inner) contiguous -> out (2, c_dim) f32: mean, mean of
// squares. cluster: blocks per channel (1..8); vec: values per load; chunk:
// vec-groups per block, chunk * cluster >= outer * inner / vec.
int pcuda_bn_stats_forward(const float* x, float* out, int outer, int c_dim, int inner, int cluster, int vec,
                           int chunk, cudaStream_t stream) {
  return stats_forward(x, out, outer, c_dim, inner, cluster, vec, chunk, stream);
}

int pcuda_bn_stats_forward_bf16(const __nv_bfloat16* x, float* out, int outer, int c_dim, int inner, int cluster,
                                int vec, int chunk, cudaStream_t stream) {
  return stats_forward(x, out, outer, c_dim, inner, cluster, vec, chunk, stream);
}

// g_mean, g_meansq: c_dim f32; dx has x's shape and type. vec as above (x and
// dx 16-byte aligned); blocks: the grid, 1..65535 blocks of 256 threads.
int pcuda_bn_stats_backward(const float* x, const float* g_mean, const float* g_meansq, float* dx, int outer,
                            int c_dim, int inner, int vec, int blocks, cudaStream_t stream) {
  return stats_backward(x, g_mean, g_meansq, dx, outer, c_dim, inner, vec, blocks, stream);
}

int pcuda_bn_stats_backward_bf16(const __nv_bfloat16* x, const float* g_mean, const float* g_meansq,
                                 __nv_bfloat16* dx, int outer, int c_dim, int inner, int vec, int blocks,
                                 cudaStream_t stream) {
  return stats_backward(x, g_mean, g_meansq, dx, outer, c_dim, inner, vec, blocks, stream);
}

// Outside any stream capture: clusters of `cluster` forward blocks (this
// kernel's own block size and shared memory) the current device runs at
// once, for x in bfloat16 (bf16 != 0) or float32, read vec values a load.
int pcuda_bn_stats_forward_clusters(int bf16, int vec, int cluster, int* clusters) {
  cudaError_t err;
  if (bf16)
    err = vec == 1 ? forward_clusters<__nv_bfloat16, 1>(cluster, clusters)
                   : forward_clusters<__nv_bfloat16, 8>(cluster, clusters);
  else
    err = vec == 1 ? forward_clusters<float, 1>(cluster, clusters) : forward_clusters<float, 4>(cluster, clusters);
  return static_cast<int>(err);
}

const char* pcuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
