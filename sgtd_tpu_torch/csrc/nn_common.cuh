// Device functions shared by the nearest-neighbour kernels (nn.cu: B4 nn1,
// B5 knn) and the fused GICP linearization (gicp.cu: B7), so that all of
// them rank reference points by bit-identical distances.
//
//   d(q, r) = (|q|^2 + |r|^2) - 2 q.r,  with
//   |p|^2 = fma(p2, p2, fma(p1, p1, p0*p0)),
//   q.r   = fma(q2, r2, fma(q1, r1, q0*r0)),
//
// every operation a round-to-nearest intrinsic, so nvcc cannot
// re-associate or contract it. The last step is one FMA,
// fma(-2, q.r, |q|^2 + |r|^2): doubling a float is exact (subnormals
// included), so it rounds once, as the subtraction of the doubled product
// does, to the same bits.
//
// The nearest-neighbour scan (nearest, below: B4 and B7).
//
// What bounds it on this card is the rate at which the CUDA cores start
// instructions, not bytes: the rerank's 64 x 1,024 x 4,096 = 268M
// distances come from 1 MB of points, and the distance is a fixed chain of
// float32 FMAs that the tensor cores cannot take. A scheduler starts one
// warp instruction a cycle, so the time is instruction slots a distance;
// the five arithmetic instructions of d are the floor. The first design (one query
// a thread, one reference a loop trip, a compare and two selects on the
// running (best, arg) at every reference) spent ten slots a distance and
// left one loop-carried chain a thread to hide every latency.
//
// Design:
//  - A thread holds Q queries in registers (4 when the batch fills the
//    card, else 1), so one 16-byte broadcast read of a tile entry
//    (x, y, z, |r|^2) feeds Q distances and Q independent chains.
//  - A deferred argmin over groups of kGroup = 16 consecutive references.
//    In the loop a query keeps only the minimum of the current group
//    (fminf: one instruction a distance) and, once a group, compares it
//    with the running minimum and records the group's number on a strict
//    <: three instructions a group, no branch, no divergence. Groups
//    ascend, so the recorded group is the first that attains the minimum.
//    After the scan the thread computes that one group's 16 distances
//    again (the same intrinsics on the same inputs, so the same bits) in
//    ascending index with the strict < of a plain sequential scan: the
//    lowest index attaining the minimum wins, with the distance bits of
//    that very reference (+0.0 or -0.0 as it came), and a NaN distance
//    never wins (fminf drops it, < rejects it). In the SASS that is 5
//    FFMA/FMUL/FADD + 15/16 FMNMX + 3/16 compare-and-select + 1/4 LDS.128
//    a distance: 6.5 instruction slots with the loop's own.
//  - The warps of a block split the reference range: all of them hold the
//    same 32 x Q queries, and warp w takes groups w, w + W, w + 2W, ... of
//    every tile. Each warp's groups ascend, and the warps' (minimum,
//    group) pairs are combined through shared memory by (smaller minimum,
//    then lower group), so the result does not depend on W. W is chosen
//    at launch (scan_plan) so that about 4,096 warps are in flight at any
//    batch size: a chunk's 64 problems run 512 blocks of 8 warps, one
//    query's 4 problems 128 blocks of 16 where the first design ran 32
//    blocks of 4.
//  - A one-dimensional grid over (problem, query tile): no 65,535 limit.
//  - A tile's ragged tail is padded to a whole group with entries whose
//    |r|^2 is +inf: their distance is +inf and never below a minimum.
//  - A thread starts the loads of four reference points before it stores
//    any into the tile (load_tile_groups).
// Tried and lost, on the same card in turns (PERF.md has the times):
//  - the rescan inside the loop (keep the group's distances and, where the
//    group's minimum beats the running one, rescan it there and then with
//    the strict <): a warp rescans when any of its lanes does (14% of the
//    groups of 8 on random clouds, 23% of the groups of 16), and the kept
//    distances cost registers; a quarter slower than the deferred group
//    number;
//  - 2 queries a thread (4% slower: twice the shared-memory reads);
//    groups of 4 (7% slower), 8 (level for nn1, 8% slower for the
//    linearization) and 32 (8% slower: 32 distances to compute again);
//    2,048 warps wanted, that is 4 warps a block at 64 problems (7%
//    slower at groups of 16); tiles of 2,048 references (level);
//  - the next tile's coordinates fetched into registers while the current
//    tile is scanned (88 registers; a tenth slower for nn1): the loads'
//    latency is not what the scan waits for;
//  - 4 or 8 tile entries read from shared memory ahead of their use (nvcc
//    reads each entry a few instructions before it: level either way).
// What remains is the instruction rate itself: at the card's 1,980 MHz the
// kernels start about 0.7 instructions a cycle a scheduler (6.5 slots a
// distance in the SASS, 9.4 cycles measured), the first design 0.55 (10
// slots, 18 cycles), and variants that differ only in how nvcc schedules
// the same loop spread by a tenth.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace sgtd {

constexpr int kTile = 1024;  // reference points per shared-memory tile

// The scan's launch shape (ops/nn.py mirrors these in scan_plan).
constexpr int kGroup = 16;           // references a group of the deferred argmin
constexpr int kWideQueries = 4;      // queries a thread when the batch fills the card
constexpr int kWideBlocks = 132;     // ... that is, with a block for every SM
constexpr int kMinWarps = 4;         // warps a block: a power of two in
constexpr int kMaxWarps = 16;        //   [kMinWarps, kMaxWarps]
constexpr int kWarpsWanted = 4096;   // warps in flight the plan aims for
constexpr int kMaxThreads = 32 * kMaxWarps;

static_assert(kTile % kGroup == 0, "a tile is whole groups");
static_assert(kMinWarps >= kWideQueries, "thread t resolves slot t: 32 Q slots need 32 Q threads");
static_assert(kMaxWarps * 32 * kWideQueries * 8 <= kTile * 16, "the combine reuses the tile");

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
}

__device__ __forceinline__ float sq_dist(const float4 q, const float4 r) {
  const float cross = __fmaf_rn(q.z, r.z, __fmaf_rn(q.y, r.y, __fmul_rn(q.x, r.x)));
  return __fmaf_rn(-2.0f, cross, __fadd_rn(q.w, r.w));
}

// Point i of a (n, 3) cloud with its |p|^2 in .w (zeros where !live).
__device__ __forceinline__ float4 load_point(const float* __restrict__ pts,
                                             int64_t i, bool live) {
  float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live) {
    p.x = pts[3 * i];
    p.y = pts[3 * i + 1];
    p.z = pts[3 * i + 2];
    p.w = sq_norm(p.x, p.y, p.z);
  }
  return p;
}

// Reference points [base, base + n) of one problem into shared memory as
// (x, y, z, |r|^2): B5's loader.
__device__ __forceinline__ void load_tile(const float* __restrict__ ref,
                                          int base, int n, float4* tile) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float* p = ref + 3 * static_cast<int64_t>(base + i);
    const float x = p[0], y = p[1], z = p[2];
    tile[i] = make_float4(x, y, z, sq_norm(x, y, z));
  }
}

// The scan's loader: reference points [base, base + n) of one problem into
// shared memory as (x, y, z, |r|^2), and behind them entries up to a
// multiple of `group` whose |r|^2 is +inf (their distance to any finite
// query is +inf). A thread takes four points a pass and starts their
// twelve loads before it stores any, so a pass waits for device memory
// once, not four times.
__device__ __forceinline__ void load_tile_groups(const float* __restrict__ ref,
                                                 int base, int n, int group,
                                                 float4* tile) {
  constexpr int kBatch = 4;
  const int padded = (n + group - 1) / group * group;
  const int step = blockDim.x;
  for (int i0 = threadIdx.x; i0 < padded; i0 += kBatch * step) {
    float4 p[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      p[k] = load_point(ref, base + i0 + k * step, i0 + k * step < n);
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * step;
      if (i >= n) p[k].w = __int_as_float(0x7f800000);  // +inf
      if (i < padded) tile[i] = p[k];
    }
  }
}

// How a batch of P problems of N queries is laid over the card: queries a
// thread, warps a block, query tiles (of 32 x queries) a problem, blocks.
struct ScanPlan {
  int queries, warps, tiles;
  int64_t blocks;
};

inline ScanPlan scan_plan(int P, int N) {
  const int wide = 32 * kWideQueries;
  const bool fills = N >= wide && static_cast<int64_t>(P) * ((N + wide - 1) / wide) >= kWideBlocks;
  ScanPlan plan;
  plan.queries = fills ? kWideQueries : 1;
  plan.tiles = (N + 32 * plan.queries - 1) / (32 * plan.queries);
  plan.blocks = static_cast<int64_t>(P) * plan.tiles;
  plan.warps = kMinWarps;
  while (plan.warps < kMaxWarps && plan.blocks * plan.warps < kWarpsWanted) plan.warps *= 2;
  return plan;
}

// The nearest of the problem's T reference points to each of the block's
// 32 x Q queries ("slots"); load_q(slot) gives slot's query as (x, y, z,
// |q|^2), the same bits at every call. Every thread of the block must call
// it (it synchronizes the block), with blockDim.x a multiple of 32 in
// [32 Q, kMaxThreads]. In the scan a thread holds slots c * 32 + lane, c <
// Q. Afterwards thread t < 32 Q holds slot t's answer: its query in *q,
// the minimum distance in *best_d and the lowest index attaining it in
// *best_i (what a sequential scan over ascending indices with a strict <
// gives: +inf and 0 if no distance is below +inf). The other threads get
// +inf and 0.
template <int Q, class LoadQuery>
__device__ __forceinline__ void nearest(LoadQuery load_q,
                                        const float* __restrict__ ref, int T,
                                        float4* tile, float4* q_out,
                                        float* best_d, int* best_i) {
  const float inf = __int_as_float(0x7f800000);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;

  float4 q[Q];
  float best[Q];  // the running minimum over this warp's groups
  int grp[Q];     // the first of them that attains it
#pragma unroll
  for (int c = 0; c < Q; ++c) {
    q[c] = load_q(c * 32 + lane);
    best[c] = inf;
    grp[c] = 0;
  }

  for (int base = 0; base < T; base += kTile) {
    const int len = min(kTile, T - base);
    const int groups = (len + kGroup - 1) / kGroup;
    __syncthreads();
    load_tile_groups(ref, base, len, kGroup, tile);
    __syncthreads();
    for (int g = warp; g < groups; g += warps) {
      const float4* p = tile + g * kGroup;
      float m[Q];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const float4 r = p[i];  // the same address on every lane: a broadcast
#pragma unroll
        for (int c = 0; c < Q; ++c) {
          const float d = sq_dist(q[c], r);
          m[c] = i == 0 ? d : fminf(m[c], d);
        }
      }
      const int gid = base / kGroup + g;
#pragma unroll
      for (int c = 0; c < Q; ++c) {
        if (m[c] < best[c]) {
          best[c] = m[c];
          grp[c] = gid;
        }
      }
    }
  }

  // The warps' (minimum, group) of every slot, through the tile's memory.
  __syncthreads();
  float2* part = reinterpret_cast<float2*>(tile);  // [warps][32 Q]
#pragma unroll
  for (int c = 0; c < Q; ++c)
    part[(warp * Q + c) * 32 + lane] = make_float2(best[c], __int_as_float(grp[c]));
  __syncthreads();

  *best_d = inf;
  *best_i = 0;
  *q_out = make_float4(0.f, 0.f, 0.f, 0.f);
  if (threadIdx.x < 32 * Q) {
    // A warp that found nothing below +inf left (+inf, 0), which loses
    // every tie but one against another (+inf, 0).
    float b = inf;
    int g = 0;
    for (int w = 0; w < warps; ++w) {
      const float2 e = part[w * 32 * Q + threadIdx.x];
      const int eg = __float_as_int(e.y);
      if (e.x < b || (e.x == b && eg < g)) {
        b = e.x;
        g = eg;
      }
    }
    // The winning group again, in ascending index with a strict <.
    const float4 qs = load_q(threadIdx.x);
    *q_out = qs;
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int j = g * kGroup + i;
      if (j < T) {
        const float d = sq_dist(qs, load_point(ref, j, true));
        if (d < *best_d) {
          *best_d = d;
          *best_i = j;
        }
      }
    }
  }
}

}  // namespace sgtd
