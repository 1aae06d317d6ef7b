// Symmetric Chamfer loss on Hopper: the whole forward in one launch, the
// one-direction nearest-neighbour search for large clouds, and the
// deterministic backward, for (B, N, 3) float32 point clouds.
//
// Replaces (TPU): pointcloududa_tpu/ops/chamfer_pallas.py
//   - _chamfer_fwd_kernel / _chamfer_fwd   -> fused_forward_kernel
//     (both directions' argmins and the per-item means of sqrt(min + 1e-5)
//     in one call; the TPU kernel holds the whole N x M matrix in VMEM)
//   - _nn_tiled_kernel / _nn_directional_tiled -> nn_kernel
//     (one direction's running (min, argmin) over column tiles)
//   - _vjp_bwd (jnp: gathers + one-hot einsum / segment_sum scatter)
//     -> side_grad_kernel
//
// What bounds them here: neither bytes nor FLOPs. A 300-point cloud is
// 3.6 KB and the card does the 16 x 300 x 300 pairs of a batch in about a
// microsecond if they are spread over its SMs; an empty kernel's launch alone
// costs one, a cluster's launch and its two barriers about four. So the
// forward is bound by the number of launches and by how long one thread's
// chain of pairs is. The N x M distance matrix (360 KB per item, more than a
// block's 227 KB of shared memory) never exists: the partner cloud sits in
// shared memory and only a running (min, argmin) stays in registers.
//
// fused_forward_kernel does in one launch what took two nn_kernel launches
// and five PyTorch launches (+ eps, sqrt, mean, twice, and a sum):
//
//  * A cluster of up to 8 blocks of 512 threads per item shares the item's
//    N + M queries (x's points against y, then y's points against x) in
//    contiguous shares. The wrapper takes the largest cluster of which the
//    card runs the whole batch at once with one block to an SM (device.cu):
//    an H100 of 132 SMs runs 15 such clusters of 8 but 17 of 6. That rule is
//    empirical here. These blocks are small and the occupancy calculator
//    promises several times as many clusters of them, yet the time steps
//    where the whole-SM count runs out (measured with 16 items: 7.7 us in
//    clusters of 6, 10.1 us in clusters of 7), as if a cluster's blocks were
//    placed one to an SM whatever their size. The smoke test prints the time
//    by cluster size, so a card that behaves otherwise shows.
//  * Several threads share one query, so a thread's chain is short. With
//    N = M = 300 in clusters of 6 a block has 100 queries and 512 threads:
//    4 adjacent lanes take a query, lane s scans partners s, s + 4, ... (75
//    pairs instead of 300), and two shuffles settle the smallest distance
//    and, among equals, the lowest index. The lanes a query gets is the
//    largest power of two with which a block takes all its queries in one
//    pass; a long cloud (2048 points) has one lane a query as before.
//  * Both clouds are staged in shared memory in tiles of 512 points
//    (N = M = 300 is one tile, 7.2 KB + the squared norms; longer clouds
//    stream tile after tile, so any N and M are served).
//  * The first lane of a query adds sqrt(min + 1e-5) to its thread's sum, a
//    block sums its threads by a shuffle tree and then its warps in order,
//    writes its two partial sums into block 0's shared memory through
//    distributed shared memory, and after cluster.sync() block 0 adds the
//    partials in rank order and divides by N and M: no atomics, so repeat
//    runs give the same bits.
//
// Numerics: the squared distance is |a|^2 + |b|^2 - 2 a.b, clamped at 0,
// with every product and sum rounded on its own (no FMA contraction) in the
// order of the plain PyTorch expansion (ops/losses.py:batch_pairwise_dist),
// so the kernels and their plain versions pick the same argmin even on
// near-ties. The minimum is replaced only on a strict '<' over increasing
// indices, and lanes that share a query compare (distance, index): ties keep
// the lowest index, as jnp.argmin and torch.min do.
//
// The backward scatter is built without atomics: each query point scans the
// partner cloud's argmin list for the entries that point back at it and
// sums their unit vectors in index order, so repeat runs give the same bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

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

// Fold the cnt partner points staged in cs (rows of 3) with squared norms ccs,
// whose first has index t0, into the running (best, best_j) of the query
// (a0, a1, a2) with squared norm aa.
__device__ __forceinline__ void scan_tile(float a0, float a1, float a2, float aa, const float* cs,
                                          const float* ccs, int cnt, int t0, float& best,
                                          int& best_j) {
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
    scan_tile(a0, a1, a2, aa, cs, ccs, cnt, t0, best, best_j);
  }
  if (i < n) {
    min_out[static_cast<size_t>(b) * n + i] = best;
    idx_out[static_cast<size_t>(b) * n + i] = best_j;
  }
}

constexpr int kMaxCluster = 8;  // blocks that share one item's queries, at most (the portable maximum)
constexpr int kFusedThreads = 512;
constexpr int kFusedTile = 512;  // points of either cloud staged per tile

// The two halves of a cluster barrier (cluster.sync() is one after the other),
// apart so that the work between them hides the wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Stage points [t0, t0 + cnt) of a cloud and their squared norms: thread k
// brings point k, so no barrier stands between the copy and the norm.
__device__ __forceinline__ void stage_tile(const float* __restrict__ cloud, int t0, int cnt,
                                           float* cs, float* ccs) {
  for (int k = threadIdx.x; k < cnt; k += kFusedThreads) {
    const float c0 = cloud[3 * (t0 + k)], c1 = cloud[3 * (t0 + k) + 1], c2 = cloud[3 * (t0 + k) + 2];
    cs[3 * k] = c0;
    cs[3 * k + 1] = c1;
    cs[3 * k + 2] = c2;
    ccs[k] = sq3(c0, c1, c2);
  }
}

// The whole forward for item blockIdx.x / 8: idx1[i] = argmin_j |x_i - y_j|^2,
// idx2[j] = argmin_i |y_j - x_i|^2, loss_parts = (mean_i sqrt(min1 + eps),
// mean_j sqrt(min2 + eps)). Query q < n is x_q, query q >= n is y_{q - n}.
// kLanes (a power of two, 1..32) adjacent threads share one query: lane s
// scans partners s, s + kLanes, ... and the lanes then agree on the smallest
// distance and, among equals, the lowest index.
template <int kLanes>
__global__ void __launch_bounds__(kFusedThreads)
    fused_forward_kernel(const float* __restrict__ x, const float* __restrict__ y,
                         int* __restrict__ idx1, int* __restrict__ idx2,
                         float* __restrict__ loss_parts, int n, int m) {
  __shared__ float xs[kFusedTile * 3], ys[kFusedTile * 3];
  __shared__ float xxs[kFusedTile], yys[kFusedTile];
  __shared__ float warp_sum[2][kFusedThreads / 32];
  __shared__ float partial[kMaxCluster][2];  // filled in block 0 only

  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive();  // waited for just before the one remote write
  const int rank = static_cast<int>(cluster.block_rank());
  const int blocks = static_cast<int>(cluster.num_blocks());
  const int b = blockIdx.x / blocks;
  const float* xb = x + static_cast<size_t>(b) * n * 3;
  const float* yb = y + static_cast<size_t>(b) * m * 3;
  const int per = (n + m + blocks - 1) / blocks;  // queries of this block
  const int q_begin = rank * per;
  const int q_end = min(q_begin + per, n + m);
  const int longest = max(n, m);
  const int sub = static_cast<int>(threadIdx.x) % kLanes;  // this thread's lane of its query
  const int group = static_cast<int>(threadIdx.x) / kLanes;
  constexpr int groups = kFusedThreads / kLanes;  // queries in flight at once

  float sum1 = 0.f, sum2 = 0.f;  // the queries this thread reports, in order
  for (int q0 = q_begin; q0 < q_begin + per; q0 += groups) {  // the same trips for every thread
    const int q = q0 + group;
    const bool active = q < q_end;
    const bool second = active && q >= n;  // a point of y, searched in x
    const int i = second ? q - n : q;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
    if (active) {
      const float* ab = second ? yb : xb;
      a0 = ab[3 * i];
      a1 = ab[3 * i + 1];
      a2 = ab[3 * i + 2];
    }
    const float aa = sq3(a0, a1, a2);
    float best = __int_as_float(0x7f800000);  // +inf
    int best_j = 0;
    for (int t0 = 0; t0 < longest; t0 += kFusedTile) {
      const int cnt_x = min(max(n - t0, 0), kFusedTile);
      const int cnt_y = min(max(m - t0, 0), kFusedTile);
      __syncthreads();  // the previous tile is fully consumed
      stage_tile(xb, t0, cnt_x, xs, xxs);
      stage_tile(yb, t0, cnt_y, ys, yys);
      __syncthreads();
      if (active) {
        const float* cs = second ? xs : ys;
        const float* ccs = second ? xxs : yys;
        const int cnt = second ? cnt_x : cnt_y;
#pragma unroll 4
        for (int k = sub; k < cnt; k += kLanes) {  // increasing k, strict '<': the lowest of a tie stays
          const float ac = dot3(a0, a1, a2, cs[3 * k], cs[3 * k + 1], cs[3 * k + 2]);
          float p = __fsub_rn(__fadd_rn(aa, ccs[k]), __fmul_rn(2.0f, ac));
          p = p < 0.f ? 0.f : p;
          if (p < best) {
            best = p;
            best_j = t0 + k;
          }
        }
      }
    }
    // the lanes of a query agree: smallest distance, then lowest index
#pragma unroll
    for (int off = kLanes >> 1; off > 0; off >>= 1) {
      const float other = __shfl_xor_sync(0xffffffffu, best, off);
      const int other_j = __shfl_xor_sync(0xffffffffu, best_j, off);
      if (other < best || (other == best && other_j < best_j)) {
        best = other;
        best_j = other_j;
      }
    }
    if (active && sub == 0) {
      const float dist = __fsqrt_rn(__fadd_rn(best, kEps));
      if (second) {
        idx2[static_cast<size_t>(b) * m + i] = best_j;
        sum2 = __fadd_rn(sum2, dist);
      } else {
        idx1[static_cast<size_t>(b) * n + i] = best_j;
        sum1 = __fadd_rn(sum1, dist);
      }
    }
  }

  // block sums in a fixed order: a shuffle tree, then the warps in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum1 = __fadd_rn(sum1, __shfl_down_sync(0xffffffffu, sum1, off));
    sum2 = __fadd_rn(sum2, __shfl_down_sync(0xffffffffu, sum2, off));
  }
  if ((threadIdx.x & 31) == 0) {
    warp_sum[0][threadIdx.x >> 5] = sum1;
    warp_sum[1][threadIdx.x >> 5] = sum2;
  }
  __syncthreads();
  cluster_wait();  // every block of the cluster runs: block 0's memory can be written
  if (threadIdx.x == 0) {
    float t1 = 0.f, t2 = 0.f;
    for (int w = 0; w < kFusedThreads / 32; ++w) {
      t1 = __fadd_rn(t1, warp_sum[0][w]);
      t2 = __fadd_rn(t2, warp_sum[1][w]);
    }
    float* theirs = cluster.map_shared_rank(&partial[0][0], 0);
    theirs[2 * rank] = t1;
    theirs[2 * rank + 1] = t2;
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    float t1 = 0.f, t2 = 0.f;
    for (int r = 0; r < blocks; ++r) {  // rank order
      t1 = __fadd_rn(t1, partial[r][0]);
      t2 = __fadd_rn(t2, partial[r][1]);
    }
    loss_parts[2 * static_cast<size_t>(b)] = __fdiv_rn(t1, static_cast<float>(n));
    loss_parts[2 * static_cast<size_t>(b) + 1] = __fdiv_rn(t2, static_cast<float>(m));
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

using FusedKernel = void (*)(const float*, const float*, int*, int*, float*, int, int);

// As many lanes a query as let a block take all its queries in one pass.
FusedKernel fused_kernel(int n, int m, int cluster) {
  const int per = (n + m + cluster - 1) / cluster;
  int lanes = 1;
  while (lanes < 32 && per * lanes * 2 <= kFusedThreads) lanes *= 2;
  switch (lanes) {
    case 2: return fused_forward_kernel<2>;
    case 4: return fused_forward_kernel<4>;
    case 8: return fused_forward_kernel<8>;
    case 16: return fused_forward_kernel<16>;
    case 32: return fused_forward_kernel<32>;
    default: return fused_forward_kernel<1>;
  }
}

cudaLaunchConfig_t fused_config(int batch, int cluster, cudaStream_t stream,
                                cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(batch) * static_cast<unsigned>(cluster));
  config.blockDim = dim3(kFusedThreads);
  config.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
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

// x (batch, n, 3), y (batch, m, 3) -> idx1 (batch, n) i32, idx2 (batch, m) i32,
// loss_parts (batch, 2) f32; one launch, a cluster of `cluster` blocks (1..8)
// per item.
int pcuda_chamfer_forward(const float* x, const float* y, int* idx1, int* idx2, float* loss_parts,
                          int batch, int n, int m, int cluster, cudaStream_t stream) {
  if (cluster < 1 || cluster > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config = fused_config(batch, cluster, stream, &attr);
  const cudaError_t err =
      cudaLaunchKernelEx(&config, fused_kernel(n, m, cluster), x, y, idx1, idx2, loss_parts, n, m);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch is reported once, not left pending
    return static_cast<int>(err);
  }
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
