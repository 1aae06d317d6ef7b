// Greedy farthest-point sampling on Hopper: k points out of P candidates per
// cloud, from a given start, for a batch of clouds.
//
// Replaces (TPU): pointcloududa_tpu/ops/fps_pallas.py
//   - _fps_kernel / fps_pallas (one program per cloud, the running distances
//     and three coordinate planes resident in VMEM for all k rounds)
//
// What bounds it here: neither bytes nor FLOPs but the serial chain. The
// compulsory traffic is the validity bytes in and k points out; the work is
// k-1 rounds that depend on each other, each one pass over the cloud's valid
// candidates followed by an argmax over all of them. So a round has to be
// short, and everything a round touches has to be close:
//
//  * Compact once, scan never. At the start of the launch the validity bytes
//    are read once and the valid candidates are gathered; from then on a
//    round touches valid candidates only (a cardiac mask covers 10-20% of a
//    slice, so most of the P grid positions are never looked at again).
//  * A thread-block cluster per cloud: up to 8 blocks (the portable maximum)
//    of 1024 threads share a cloud's candidates. The wrapper takes the
//    largest cluster of which the device runs the whole batch at once: a
//    cluster lies inside one GPC, so a card of 132 SMs may run only 15
//    clusters of 8, and a 16th cloud would wait for a whole second wave.
//    Original indices are dealt to the blocks in chunks of 1024,
//    round-robin, so that a mask in the middle of each plane is shared out
//    evenly; contiguous slices of P would not be.
//  * A block's candidates stay resident in its shared memory for all k
//    rounds: z, y, x, the running distance and the original index, 20 bytes
//    a candidate, as five arrays (a record of four floats would make the
//    write-back of the distance alone a 4-way bank conflict; five arrays of
//    4-byte words are conflict-free both ways). The capacity is fixed at
//    launch (the count of valid candidates is known only on the device), so
//    what exceeds it lives in a global scratch row that stays in L2, in a
//    branch of its own: `sweep` runs once over the shared arrays and once
//    over the scratch arrays. Thread t owns positions t, t + 1024, ... of
//    either for the whole launch, so the distances need no synchronisation.
//    Either array is filled up to a whole number of block-wide passes with
//    entries that can never win, so the sweep carries no guard per entry:
//    with 32 warps a block, a round is bound by the operations it executes.
//  * One cluster barrier a round and no dependent global load. The sweep
//    that folds the new point into the distances also finds the thread's
//    maximum for the next round. A warp reduces with two redux operations
//    (max of the distance bits, then min of the position among the lanes
//    that hold that maximum), warp 0 reduces the 32 warp results the same
//    way after one __syncthreads(), and its first lanes write the block's
//    (distance, original index, z, y, x) into a slot of every block of the
//    cluster through distributed shared memory. After cluster.sync() every
//    warp reduces the cluster's slots itself. The winner's coordinates travel
//    with it, so the next round starts at once. Two sets of slots, used by
//    round parity, make the one barrier enough: a block can only run one
//    round ahead of the slowest reader.
//
// Numerics: squared distance dz*dz + dy*dy + dx*dx, every product and sum
// rounded on its own in that order (no FMA contraction), as the plain
// PyTorch version beside the wrapper computes it, so both choose the same
// sequence on any float coordinates. Distances are >= 0, so their bit
// patterns order like the floats and an unsigned max finds the largest.
// Ties go to the lowest ORIGINAL index, as jnp.argmax decides: a block's
// candidates are compacted in increasing original index, a thread visits its
// positions in increasing order and replaces on strict '>', the block
// reductions take the lowest position among equal distances, and the cluster
// reduction takes the lowest original index (never the block's rank). A
// cloud with no valid candidate repeats coords[0] from round 1 on, as the
// argmax of an all-sentinel row is index 0.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;  // also the chunk of original indices dealt to one block at a time
constexpr int kWarps = kThreads / 32;
static_assert(kWarps == 32, "the block reductions hold one warp result per lane");
constexpr int kMaxCluster = 8;
constexpr int kUnroll = 4;  // candidates a thread has in flight at once
constexpr int kBytesPerCandidate = 20;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;  // "no candidate": loses every lowest-position/index contest

// one block's result of a round, as every block of the cluster sees it
struct Slots {
  unsigned bits[2][kMaxCluster];  // the distance's bit pattern
  unsigned index[2][kMaxCluster];  // original index, kNone if the block holds no candidate
  float z[2][kMaxCluster], y[2][kMaxCluster], x[2][kMaxCluster];
};

// Fold the point (pz, py, px) into the running distances of the n entries
// held in the arrays z, y, x, d, thread tid taking tid, tid + kThreads, ...; n
// is a whole number of such passes, so no entry needs a guard. (best,
// best_pos) keeps the thread's largest distance and base + its lowest
// position. The pointers are plain on purpose: the scratch row is written
// earlier in the same launch, so no load may take the read-only path.
__device__ __forceinline__ void sweep(const float* z, const float* y, const float* x, float* d,
                                      int n, unsigned base, int tid, float pz, float py, float px,
                                      float& best, unsigned& best_pos) {
  int j0 = tid;
  for (; j0 + (kUnroll - 1) * kThreads < n; j0 += kThreads * kUnroll) {
    // all loads of a batch are started before any is used
    float cz[kUnroll], cy[kUnroll], cx[kUnroll], old[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kThreads;
      cz[u] = z[j];
      cy[u] = y[j];
      cx[u] = x[j];
      old[u] = d[j];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kThreads;
      const float dz = __fsub_rn(cz[u], pz);
      const float dy = __fsub_rn(cy[u], py);
      const float dx = __fsub_rn(cx[u], px);
      const float nd = fminf(
          old[u], __fadd_rn(__fadd_rn(__fmul_rn(dz, dz), __fmul_rn(dy, dy)), __fmul_rn(dx, dx)));
      d[j] = nd;
      if (nd > best) {  // strict, over increasing positions: the lowest of a tie stays
        best = nd;
        best_pos = base + static_cast<unsigned>(j);
      }
    }
  }
  for (; j0 < n; j0 += kThreads) {
    const float dz = __fsub_rn(z[j0], pz);
    const float dy = __fsub_rn(y[j0], py);
    const float dx = __fsub_rn(x[j0], px);
    const float nd = fminf(
        d[j0], __fadd_rn(__fadd_rn(__fmul_rn(dz, dz), __fmul_rn(dy, dy)), __fmul_rn(dx, dx)));
    d[j0] = nd;
    if (nd > best) {
      best = nd;
      best_pos = base + static_cast<unsigned>(j0);
    }
  }
}

// The largest bits over the warp and, among the lanes that hold it, the
// lowest pos; every lane gets both.
__device__ __forceinline__ void warp_argmax(unsigned& bits, unsigned& pos) {
  const unsigned top = __reduce_max_sync(kFull, bits);
  pos = __reduce_min_sync(kFull, bits == top ? pos : kNone);
  bits = top;
}

__global__ void __launch_bounds__(kThreads)
    fps_kernel(const unsigned char* __restrict__ valid, const float* __restrict__ coords,
               long long coords_batch_stride, const int* __restrict__ starts, float* scratch,
               float* __restrict__ out, int p, int k, int cap, int overflow) {
  extern __shared__ float resident[];  // z, y, x, distance, original index: cap words each
  __shared__ Slots slots;
  __shared__ unsigned warp_bits[kWarps];
  __shared__ unsigned warp_pos[kWarps];
  __shared__ int warp_count[kWarps];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int blocks = static_cast<int>(cluster.num_blocks());
  const int b = blockIdx.x / blocks;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned char* vb = valid + static_cast<size_t>(b) * p;
  const float* cb = coords + static_cast<size_t>(b) * static_cast<size_t>(coords_batch_stride);
  float* ob = out + static_cast<size_t>(b) * k * 3;

  float* sz = resident;
  float* sy = sz + cap;
  float* sx = sy + cap;
  float* sd = sx + cap;
  int* si = reinterpret_cast<int*>(sd + cap);
  // this block's row of the scratch, laid out like the resident arrays
  float* gz = scratch + static_cast<size_t>(blockIdx.x) * 5 * overflow;
  float* gy = gz + overflow;
  float* gx = gy + overflow;
  float* gd = gx + overflow;
  int* gi = reinterpret_cast<int*>(gd + overflow);

  // Gather this block's valid candidates, in increasing original index:
  // chunks rank, rank + blocks, ... of 1024 indices. n counts them.
  int n = 0;
  for (int c0 = rank * kThreads; c0 < p; c0 += blocks * kThreads) {
    const int i = c0 + tid;
    const bool ok = i < p && vb[i];
    const unsigned mask = __ballot_sync(kFull, ok);
    if (lane == 0) warp_count[warp] = __popc(mask);
    __syncthreads();
    const int count = warp_count[lane];
    const int before = __reduce_add_sync(kFull, lane < warp ? count : 0);
    const int total = __reduce_add_sync(kFull, count);
    if (ok) {
      const int pos = n + before + __popc(mask & ((1u << lane) - 1u));
      const size_t c = 3 * static_cast<size_t>(i);
      const float inf = __int_as_float(0x7f800000);  // no point chosen yet
      if (pos < cap) {
        sz[pos] = cb[c];
        sy[pos] = cb[c + 1];
        sx[pos] = cb[c + 2];
        sd[pos] = inf;
        si[pos] = i;
      } else {
        gz[pos - cap] = cb[c];
        gy[pos - cap] = cb[c + 1];
        gx[pos - cap] = cb[c + 2];
        gd[pos - cap] = inf;
        gi[pos - cap] = i;
      }
    }
    n += total;
    __syncthreads();  // the next chunk rewrites warp_count
  }
  // Fill either array up to a whole number of block-wide passes (cap and
  // overflow are such numbers) with entries that never win: their distance
  // is -1 and stays -1 under the minimum, below any real distance.
  const int n_resident = min((n + kThreads - 1) / kThreads * kThreads, cap);
  for (int j = n + tid; j < n_resident; j += kThreads) {
    sz[j] = sy[j] = sx[j] = 0.f;
    sd[j] = -1.f;
  }
  const int n_beyond = n > cap ? (n - cap + kThreads - 1) / kThreads * kThreads : 0;
  for (int j = max(n - cap, 0) + tid; j < n_beyond; j += kThreads) {
    gz[j] = gy[j] = gx[j] = 0.f;
    gd[j] = -1.f;
  }
  __syncthreads();

  // a start outside the cloud is not the caller's contract; stay in bounds
  const int start = min(max(starts[b], 0), p - 1);
  float pz = cb[3 * static_cast<size_t>(start)];
  float py = cb[3 * static_cast<size_t>(start) + 1];
  float px = cb[3 * static_cast<size_t>(start) + 2];
  const float z0 = cb[0], y0 = cb[1], x0 = cb[2];  // the pick of a cloud with no candidate

  // every block of the cluster runs before any writes into another's slots
  cluster.sync();

  for (int round = 0; round < k; ++round) {
    if (rank == 0 && tid == 0) {
      ob[3 * round] = pz;
      ob[3 * round + 1] = py;
      ob[3 * round + 2] = px;
    }
    if (round == k - 1) break;
    const int parity = round & 1;

    float best = -1.f;  // distances are >= 0: any candidate beats it
    unsigned pos = kNone;
    sweep(sz, sy, sx, sd, n_resident, 0u, tid, pz, py, px, best, pos);
    // beyond the shared-memory capacity: the same sweep over the scratch row
    if (n_beyond > 0)
      sweep(gz, gy, gx, gd, n_beyond, static_cast<unsigned>(cap), tid, pz, py, px, best, pos);

    unsigned bits = pos == kNone ? 0u : __float_as_uint(best);
    warp_argmax(bits, pos);
    if (lane == 0) {
      warp_bits[warp] = bits;
      warp_pos[warp] = pos;
    }
    __syncthreads();
    if (warp == 0) {
      bits = warp_bits[lane];
      pos = warp_pos[lane];
      warp_argmax(bits, pos);
      if (lane < blocks) {  // lane r hands this block's result to block r
        unsigned index = kNone;
        float cz = 0.f, cy = 0.f, cx = 0.f;
        if (pos != kNone) {
          const bool here = pos < static_cast<unsigned>(cap);
          const unsigned j = here ? pos : pos - static_cast<unsigned>(cap);
          index = static_cast<unsigned>(here ? si[j] : gi[j]);
          cz = here ? sz[j] : gz[j];
          cy = here ? sy[j] : gy[j];
          cx = here ? sx[j] : gx[j];
        }
        Slots* theirs = cluster.map_shared_rank(&slots, lane);
        theirs->bits[parity][rank] = bits;
        theirs->index[parity][rank] = index;
        theirs->z[parity][rank] = cz;
        theirs->y[parity][rank] = cy;
        theirs->x[parity][rank] = cx;
      }
    }
    cluster.sync();  // reached by every thread of every block, whatever its share

    // every warp reduces the cluster's slots: (distance desc, original index asc)
    const bool has = lane < blocks;
    const unsigned mine = has ? slots.bits[parity][lane] : 0u;
    const unsigned mine_index = has ? slots.index[parity][lane] : kNone;
    const unsigned top = __reduce_max_sync(kFull, mine);
    const unsigned winner = __reduce_min_sync(kFull, mine == top ? mine_index : kNone);
    const unsigned holder = __ballot_sync(kFull, has && mine == top && mine_index == winner);
    if (winner == kNone) {  // no valid candidate in the whole cloud
      pz = z0;
      py = y0;
      px = x0;
    } else {
      const int slot = __ffs(holder) - 1;
      pz = slots.z[parity][slot];
      py = slots.y[parity][slot];
      px = slots.x[parity][slot];
    }
  }
}

cudaLaunchConfig_t launch_config(int batch, int cap, int cluster, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(batch) * static_cast<unsigned>(cluster));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = static_cast<size_t>(cap) * kBytesPerCandidate;
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

// Once per device, outside any stream capture: lets the kernel use all the
// dynamic shared memory a block may have on this device, and reports how many
// candidates that holds.
int pcuda_fps_configure(int* capacity) {
  int device = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, fps_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int dynamic = optin - static_cast<int>(fa.sharedSizeBytes);
  err = cudaFuncSetAttribute(fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic);
  *capacity = dynamic / kBytesPerCandidate;
  return static_cast<int>(err);
}

// valid (batch, p) u8; coords f32 with rows of 3 and coords_batch_stride floats
// between clouds (0: one grid shared by all); starts (batch,) i32; cluster:
// blocks per cloud, 1..8; cap: the candidates a block keeps in shared memory;
// scratch: batch * cluster rows of 5 * overflow 4-byte words for a block's
// candidates beyond cap; cap and overflow are multiples of 1024 and cap +
// overflow >= the indices dealt to one block -> out (batch, k, 3) f32.
int pcuda_fps(const unsigned char* valid, const float* coords, long long coords_batch_stride,
              const int* starts, float* scratch, float* out, int batch, int p, int k, int cap,
              int overflow, int cluster, cudaStream_t stream) {
  if (cluster < 1 || cluster > kMaxCluster || cap < kThreads || cap % kThreads || overflow < 0 ||
      overflow % kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config = launch_config(batch, cap, cluster, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(&config, fps_kernel, valid, coords,
                                             coords_batch_stride, starts, scratch, out, p, k, cap,
                                             overflow);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch is reported once, not left pending
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
