// B4 nn1 and B5 knn: brute-force nearest neighbours between point clouds.
//
// Replace the TPU kernels sgtd_tpu/ops/pallas_nn.py::nn1 and ::knn (a
// query tile against the whole VMEM-resident reference cloud, the cross
// term on the MXU at f32, then a fused argmin or k min-extraction passes,
// so the (N, T) distance matrix never reaches HBM).
//
//   d(q, r) = (|q|^2 + |r|^2) - 2 q.r,  with
//   |p|^2 = fma(p2, p2, fma(p1, p1, p0*p0)),
//   q.r   = fma(q2, r2, fma(q1, r1, q0*r0)),
//
// the expansion and the rounding order the reference computes on the CPU
// (XLA fuses those products into FMAs); every operation is a
// round-to-nearest intrinsic so nvcc cannot re-associate or contract it
// (nn_common.cuh, shared with the fused GICP linearization of gicp.cu).
//   nn1: idx[p, n] = the lowest index attaining min_t d(q[p, n], r[p, t]),
//        sqd[p, n] = that minimum.
//   knn: idx[p, n, :k] = the k smallest d in ascending order, ties to the
//        lower index (a stable ascending sort truncated to k),
//        1 <= k <= 32, k <= T.
// Masked points arrive displaced to a far coordinate by the caller; the
// kernels do not special-case them.
//
// Bound on this card: arithmetic, not bytes. At the rerank's shapes nn1
// evaluates 64 x 1,024 x 4,096 = 268M distances (about 8 flops each) from
// 1 MB of points; the map covariances' knn evaluates 200 x 4,096^2 = 3.4G.
// The tensor cores cannot take the cross term: the distance is this fixed
// chain of float32 FMAs, bit for bit.
//
// nn1: the scan of nn_common.cuh (nearest), whose header says what bounds
// it on this card and what the design does about it: several queries a
// thread, a deferred argmin over groups of 16 references, the reference
// range split over the warps of a block, a one-dimensional grid over
// (problem, query tile) laid out by scan_plan. The kernel here only loads
// the queries and stores thread t's answer for slot t.
//
// knn: what bounds it is the selection, not the distances the bound
// counts. A query meets about k (1 + ln(T / k)) references that enter its
// k best (126 of 4,096 at k 20), and with a thread a query and a sorted
// list in its registers a whole warp walked that list whenever one of its
// 32 lanes inserted: at almost every reference. Design: a warp a query
// (four queries a warp, so that one shared-memory read feeds four
// distances). Each query's best 32 lie sorted across the warp, one
// (distance, index) a lane, the k-th on lane k - 1 and broadcast as the
// query's threshold. A step gives each lane one reference of the tile
// (lane l reads float4 j0 + l: consecutive, conflict-free); a lane's test
// is one compare against the threshold, as cheap as nn1's running minimum,
// and a ballot collects the lanes that pass. Only those are inserted, one
// at a time in ascending lane, each by all lanes at once: a broadcast of
// its distance, two shfl_up that move the tail of the list down a lane,
// and a broadcast of the new threshold. Steps ascend and lanes ascend, so
// candidates arrive in ascending index; a strict < at the test and an
// insert behind equal distances give the stable order (ties to the lower
// index) from float compares alone, -0.0 equal to +0.0 as floats are. The
// tie rule needs no packed (distance, index) key. Blocks of 8 warps (32
// queries) over a one-dimensional grid of problems x query tiles: the
// rerank's chunk of 16 x 1,024 queries is 512 blocks, four on every SM,
// and the problem count has no 65,535 limit.
// Tried and lost (same card, in turns): 2 and 8 queries a warp (8 spills
// past 64 registers and halves the blocks a SM holds); 4 and 16 warps a
// block (within 3% either way); all four ballots taken before any insert;
// the threshold broadcast once a step instead of once an insert (more
// inserts early in the scan than shuffles saved). What remains is the
// inserts' instruction count, some 20 a candidate beside 10 a distance.

#include <cuda_runtime.h>
#include <cstdint>

#include "nn_common.cuh"

namespace {

using namespace sgtd;  // kTile, sq_dist, load_point, load_tile, nearest, scan_plan

constexpr unsigned kFullWarp = 0xffffffffu;
// knn: warps a block, queries a warp, and so queries a block (the wrapper's
// KNN_QUERIES_PER_BLOCK).
constexpr int kKnnWarps = 8;
constexpr int kKnnQueries = 4;
constexpr int kKnnThreads = 32 * kKnnWarps;
constexpr int kKnnBlockQueries = kKnnWarps * kKnnQueries;

template <int Q>
__global__ void __launch_bounds__(kMaxThreads)
    nn1_kernel(const float* __restrict__ query, const float* __restrict__ ref,
               int32_t* __restrict__ out_idx, float* __restrict__ out_sqd,
               int N, int T, int tiles) {
  __shared__ float4 tile[kTile];
  const int64_t prob = blockIdx.x / tiles;
  const int n0 = (blockIdx.x - prob * tiles) * (32 * Q);
  const float* qp = query + prob * 3 * static_cast<int64_t>(N);
  const auto load_q = [&](int slot) { return load_point(qp, n0 + slot, n0 + slot < N); };

  float4 q;
  float best;
  int best_i;
  nearest<Q>(load_q, ref + prob * 3 * static_cast<int64_t>(T), T, tile, &q, &best, &best_i);
  const int n = n0 + threadIdx.x;
  if (threadIdx.x < 32 * Q && n < N) {
    out_idx[prob * N + n] = best_i;
    out_sqd[prob * N + n] = best;
  }
}

// One list entry a lane: after the call the warp's 32 (ld, li), ascending by
// lane, hold the candidate (cd, ci) behind every entry with ld <= cd; the
// entries behind it have moved down one lane and the last has dropped out.
__device__ __forceinline__ void knn_insert(float& ld, int& li, float cd, int ci,
                                           int lane) {
  const float ud = __shfl_up_sync(kFullWarp, ld, 1);
  const int ui = __shfl_up_sync(kFullWarp, li, 1);
  if (ld > cd) {
    const bool here = lane == 0 || ud <= cd;
    ld = here ? cd : ud;
    li = here ? ci : ui;
  }
}

__global__ void __launch_bounds__(kKnnThreads, 4)
    knn_kernel(const float* __restrict__ query, const float* __restrict__ ref,
               int32_t* __restrict__ out_idx, int N, int T, int k, int tiles) {
  __shared__ float4 tile[kTile];
  const int lane = threadIdx.x & 31;
  const int64_t prob = blockIdx.x / tiles;
  const int n0 = (blockIdx.x - prob * tiles) * kKnnBlockQueries +
                 (threadIdx.x >> 5) * kKnnQueries;
  const float* r = ref + prob * 3 * static_cast<int64_t>(T);

  const float inf = __int_as_float(0x7f800000);
  float4 q[kKnnQueries];
  float ld[kKnnQueries];   // this lane's entry of each query's sorted list
  int li[kKnnQueries];
  float thr[kKnnQueries];  // the k-th smallest so far: lane k - 1's ld
#pragma unroll
  for (int c = 0; c < kKnnQueries; ++c) {
    q[c] = load_point(query, prob * N + n0 + c, n0 + c < N);
    ld[c] = inf;
    li[c] = 0;
    thr[c] = inf;
  }

  for (int base = 0; base < T; base += kTile) {
    const int len = min(kTile, T - base);
    __syncthreads();
    load_tile(r, base, len, tile);
    __syncthreads();
    for (int j0 = 0; j0 < len; j0 += 32) {
      const bool live = j0 + lane < len;
      const float4 p = tile[live ? j0 + lane : 0];
#pragma unroll
      for (int c = 0; c < kKnnQueries; ++c) {
        const float d = live ? sq_dist(q[c], p) : inf;
        // Lanes in ascending order, so candidates arrive in ascending index
        // and a strict < leaves equal distances to the lower index.
        unsigned hits = __ballot_sync(kFullWarp, d < thr[c]);
        while (hits) {
          const int src = __ffs(hits) - 1;
          hits &= hits - 1;
          const float cd = __shfl_sync(kFullWarp, d, src);
          if (cd < thr[c]) {  // the same on every lane
            knn_insert(ld[c], li[c], cd, base + j0 + src, lane);
            thr[c] = __shfl_sync(kFullWarp, ld[c], k - 1);
          }
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kKnnQueries; ++c)
    if (n0 + c < N && lane < k)
      out_idx[(prob * N + n0 + c) * k + lane] = li[c];
}

}  // namespace

// query (P, N, 3), ref (P, T, 3) float32 -> idx (P, N) int32, sqd (P, N)
// float32. T >= 1, P x ceil(N / 32) < 2^31.
extern "C" int sgtd_nn1(const void* query, const void* ref, void* idx,
                        void* sqd, int P, int N, int T, void* stream) {
  if (P > 0 && N > 0) {
    const ScanPlan plan = scan_plan(P, N);
    const auto kernel = plan.queries == 1 ? nn1_kernel<1> : nn1_kernel<kWideQueries>;
    kernel<<<static_cast<unsigned>(plan.blocks), 32 * plan.warps, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(query), static_cast<const float*>(ref),
        static_cast<int32_t*>(idx), static_cast<float*>(sqd), N, T, plan.tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

// query (P, N, 3), ref (P, T, 3) float32 -> idx (P, N, k) int32.
// 1 <= k <= 32, T >= k, P x ceil(N / 32) < 2^31.
extern "C" int sgtd_knn(const void* query, const void* ref, void* idx, int P,
                        int N, int T, int k, void* stream) {
  if (P > 0 && N > 0) {
    const int tiles = (N + kKnnBlockQueries - 1) / kKnnBlockQueries;
    const unsigned blocks = static_cast<unsigned>(static_cast<int64_t>(P) * tiles);
    knn_kernel<<<blocks, kKnnThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(query), static_cast<const float*>(ref),
        static_cast<int32_t*>(idx), N, T, k, tiles);
  }
  return static_cast<int>(cudaGetLastError());
}
