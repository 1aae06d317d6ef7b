// Greedy farthest-point sampling on Hopper: k points out of P candidates per
// cloud, from a given start, for a batch of clouds.
//
// Replaces (TPU): pointcloududa_tpu/ops/fps_pallas.py
//   - _fps_kernel / fps_pallas (one program per cloud, the running distances
//     and three coordinate planes resident in VMEM for all k rounds)
//
// What bounds it here: neither bytes nor FLOPs but the serial chain. The
// compulsory traffic is the validity bytes in and k points out; the work is
// k-1 rounds that depend on each other, each one pass over the cloud's P
// running distances followed by a block-wide argmax. The design keeps that
// chain short and simple: one block of 1024 threads per cloud; the running
// distances live in a (B, P) f32 global scratch buffer that the wrapper
// allocates (768 KB per cloud at P = 3 * 256 * 256, so a batch stays in the
// 50 MB L2); thread t owns the entries t, t + 1024, ... for the whole
// launch, so the distances need no synchronisation at all; the pass that
// folds the newly chosen point into the distances also finds the thread's
// local maximum for the next round, and a warp-shuffle plus shared-memory
// reduction picks the round's point with two __syncthreads(). A thread
// takes its entries eight at a time, all loads of a batch started before any
// is used: taken one by one, each entry cost an L2 round trip and the pass
// was bound by that latency. An invalid
// candidate costs one byte read per round: its distance is the sentinel by
// definition and is neither read nor written. A launch has only B blocks
// for 132 SMs: clusters with the distances in distributed shared memory, or
// compacting the valid candidates first, are the levers of a later speed
// pass. The TPU kernel's (R, 128) planes and its masked-sum gather were
// workarounds of its compiler and are not carried over; there is no
// P % 128 rule.
//
// Numerics: squared distance dz*dz + dy*dy + dx*dx, every product and sum
// rounded on its own in that order (no FMA contraction), as the plain
// PyTorch version beside the wrapper computes it, so both choose the same
// sequence on any float coordinates. The argmax breaks ties at the lowest
// index, as jnp.argmax does: within a thread by strict '>' over increasing
// indices, across threads by comparing (value, index) pairs.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;  // candidates a thread has in flight at once
constexpr float kNeg = -1e30f;  // running distance of an invalid candidate

// (va, ia) <- the better of (va, ia) and (vb, ib): larger value, then lower index
__device__ __forceinline__ void take_better(float& va, int& ia, float vb, int ib) {
  if (vb > va || (vb == va && ib < ia)) {
    va = vb;
    ia = ib;
  }
}

__global__ void __launch_bounds__(kThreads)
    fps_kernel(const unsigned char* __restrict__ valid, const float* __restrict__ coords,
               long long coords_batch_stride, const int* __restrict__ starts,
               float* __restrict__ dist, float* __restrict__ out, int p, int k) {
  __shared__ float warp_val[kWarps];
  __shared__ int warp_idx[kWarps];
  __shared__ int chosen;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned char* vb = valid + static_cast<size_t>(b) * p;
  const float* cb = coords + static_cast<size_t>(b) * static_cast<size_t>(coords_batch_stride);
  float* db = dist + static_cast<size_t>(b) * p;
  float* ob = out + static_cast<size_t>(b) * k * 3;

  // a start outside the cloud is not the caller's contract; stay in bounds
  int cur = min(max(starts[b], 0), p - 1);

  for (int round = 0; round < k; ++round) {
    const float pz = cb[3 * static_cast<size_t>(cur)];
    const float py = cb[3 * static_cast<size_t>(cur) + 1];
    const float px = cb[3 * static_cast<size_t>(cur) + 2];
    if (tid == 0) {
      ob[3 * round] = pz;
      ob[3 * round + 1] = py;
      ob[3 * round + 2] = px;
    }
    if (round == k - 1) break;

    // fold the chosen point into this thread's distances, keep its maximum.
    // kUnroll entries at a time: first all their validity bytes, then the
    // distances and coordinates of the valid ones, so that the loads of one
    // batch are in flight together instead of one L2 round trip each.
    float best = __int_as_float(0xff800000);  // -inf: any candidate beats it
    int best_i = p;
    for (int i0 = tid; i0 < p; i0 += kThreads * kUnroll) {
      bool ok[kUnroll];
      float old[kUnroll], cz[kUnroll], cy[kUnroll], cx[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kThreads;
        ok[u] = i < p && vb[i];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const size_t i = static_cast<size_t>(i0 + u * kThreads);
        old[u] = (ok[u] && round > 0) ? db[i] : 0.f;
        cz[u] = ok[u] ? cb[3 * i] : 0.f;
        cy[u] = ok[u] ? cb[3 * i + 1] : 0.f;
        cx[u] = ok[u] ? cb[3 * i + 2] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kThreads;
        if (i >= p) break;
        float d = kNeg;
        if (ok[u]) {
          const float dz = __fsub_rn(cz[u], pz);
          const float dy = __fsub_rn(cy[u], py);
          const float dx = __fsub_rn(cx[u], px);
          d = __fadd_rn(__fadd_rn(__fmul_rn(dz, dz), __fmul_rn(dy, dy)), __fmul_rn(dx, dx));
          if (round > 0) d = fminf(old[u], d);
          db[i] = d;
        }
        if (d > best) {  // strict, over increasing indices: the lowest index of a tie stays
          best = d;
          best_i = i;
        }
      }
    }

    // block-wide argmax over (value desc, index asc)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, best, off);
      const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
      take_better(best, best_i, ov, oi);
    }
    if (lane == 0) {
      warp_val[warp] = best;
      warp_idx[warp] = best_i;
    }
    __syncthreads();
    if (warp == 0) {
      best = warp_val[lane];
      best_i = warp_idx[lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, best, off);
        const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
        take_better(best, best_i, ov, oi);
      }
      // p >= 1, so some thread saw a candidate and best_i < p
      if (lane == 0) chosen = best_i;
    }
    __syncthreads();
    cur = chosen;
  }
}

}  // namespace

extern "C" {

// valid (batch, p) u8; coords f32 with rows of 3 and coords_batch_stride floats
// between clouds (0: one grid shared by all); starts (batch,) i32; dist
// (batch, p) f32 scratch -> out (batch, k, 3) f32.
int pcuda_fps(const unsigned char* valid, const float* coords, long long coords_batch_stride,
              const int* starts, float* dist, float* out, int batch, int p, int k,
              cudaStream_t stream) {
  fps_kernel<<<batch, kThreads, 0, stream>>>(valid, coords, coords_batch_stride, starts, dist,
                                            out, p, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
