// K3 grouped_sums: the front end's cluster sums (cluster/dcvc.py's
// dcvc.stats, graph/build.py's _group_by_key).
//
// Replaces no TPU kernel. The JAX package sums clusters with plain
// jax.ops.segment_sum (sgtd_tpu/cluster/dcvc.py, sgtd_tpu/graph/build.py),
// which XLA:CPU adds row by row in point order. The port's plain version
// (ops/grouped.py, through utils.segment_sum) keeps that order with a
// stable sort and torch.segment_reduce, whose CUDA kernel gives every
// (segment, column) one thread that adds its segment in order. Both call
// sites send every row without a cluster to one extra segment that is
// sliced off afterwards. On a labeled HDL-64 scan of 131,072 rows that
// segment holds some 45,000 rows in DCVC and every row in the instance
// grouping (such scans carry no instance ids): one thread added them one
// after another, for a result that was thrown away (16.4 ms of kernel time
// a scan on an H100, 700 W).
//
// For every slot s < S of an int32 slot vector, this kernel writes the
// count of its rows, their three coordinate sums and the sum of their
// sq_norm_fma, each of the five columns added from zero in point order,
// with no atomics: the plain version's bits. A row whose slot lies outside
// [0, S) is left out, and the kernel reads neither its point nor its entry
// of the order: the caller sorts the slot vector once (stable), so a
// slot's rows are one run of the sorted vector, in point order, and the
// rows left out (negative slots before, slots of S and above after) lie
// outside every run.
//
// Bound on this card: not bytes. The useful reads are a kept row's order
// entry and point (20 bytes) and a slot's 20 bytes of output: 1.7 MB for
// DCVC's sums on a scan of 131,072 rows, 0.5 us at 3.35 TB/s. What bounds it is
// latency: each column of a slot is one chain of dependent float adds (4
// cycles each), so the largest slot takes at least 4 cycles a row, and
// each row's point is found through its order entry (two dependent loads).
// So one warp takes one slot and all slots run at once (a block a slot);
// the warp first finds its run by two 32-way searches of the sorted slot
// vector (a ballot narrows the range 32-fold a step), then stages 256 rows
// at a time in shared memory (each lane 8 order entries, then their 8
// points, all loads of a stage in flight together) and five lanes add the
// five columns of the stage in row order from there.
//
// Rounding. The square column is sq_norm_fma's: fma(z, z, fma(y, y, x * x))
// with each fused step a float64 product and sum rounded to float32
// (utils.fma_f32), here as __fmul_rn / __dmul_rn / __dadd_rn /
// __double2float_rn so that nvcc contracts nothing. The sums are
// __fadd_rn from +0.0, as segment_reduce starts its sums.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kRowsPerLane = 8;
constexpr int kStage = 32 * kRowsPerLane;  // rows a warp stages at a time
constexpr int kCols = 5;                   // count, x, y, z, squared norm
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sq_norm_fma(float x, float y, float z) {
  const float xx = __fmul_rn(x, x);
  const float yy = __double2float_rn(__dadd_rn(__dmul_rn(y, y), static_cast<double>(xx)));
  return __double2float_rn(__dadd_rn(__dmul_rn(z, z), static_cast<double>(yy)));
}

// The first index in [lo, hi) of the ascending ``sorted`` whose value is at
// least v (hi where there is none), found by the whole warp: each step
// probes 32 evenly spaced entries and keeps the stretch between the last
// one below v and the first one that is not.
__device__ int warp_lower_bound(const int32_t* __restrict__ sorted, int lo, int hi, int v, int lane) {
  while (hi - lo > 32) {
    const long long stride = (static_cast<long long>(hi - lo) + 31) / 32;
    const long long pos = lo + (lane + 1) * stride - 1;
    const bool below = pos < hi && sorted[pos] < v;
    const int k = __popc(__ballot_sync(kFull, below));
    const long long cap = lo + (k + 1) * stride - 1;  // the first probe not below v
    if (cap < hi) hi = static_cast<int>(cap);
    lo += static_cast<int>(k * stride);
  }
  const bool below = lo + lane < hi && sorted[lo + lane] < v;
  return lo + __popc(__ballot_sync(kFull, below));
}

// A block of one warp a slot.
__global__ void __launch_bounds__(32) grouped_sums_kernel(
    const float* __restrict__ points, const int32_t* __restrict__ sorted_slot, const int64_t* __restrict__ order,
    float* __restrict__ counts, float* __restrict__ sums, float* __restrict__ sq, int N) {
  __shared__ float stage[kStage * kCols];  // row-major: lane c reads column c, lanes store rows 5 words apart
  const int s = blockIdx.x;
  const int lane = threadIdx.x;
  const int start = warp_lower_bound(sorted_slot, 0, N, s, lane);
  const int end = warp_lower_bound(sorted_slot, start, N, s + 1, lane);
  float acc = 0.0f;  // lane c < kCols: column c
  for (int base = start; base < end; base += kStage) {
    const int n = min(kStage, end - base);
    int64_t idx[kRowsPerLane];
#pragma unroll
    for (int r = 0; r < kRowsPerLane; ++r) {
      const int k = r * 32 + lane;
      idx[r] = k < n ? order[base + k] : 0;
    }
#pragma unroll
    for (int r = 0; r < kRowsPerLane; ++r) {
      const int k = r * 32 + lane;
      if (k < n) {
        const float* p = points + 3 * idx[r];
        const float x = p[0], y = p[1], z = p[2];
        float* row = stage + k * kCols;
        row[0] = 1.0f;
        row[1] = x;
        row[2] = y;
        row[3] = z;
        row[4] = sq_norm_fma(x, y, z);
      }
    }
    __syncwarp();
    if (lane < kCols) {
#pragma unroll 8
      for (int k = 0; k < n; ++k) acc = __fadd_rn(acc, stage[k * kCols + lane]);
    }
    __syncwarp();
  }
  if (lane == 0) counts[s] = acc;
  else if (lane < 4) sums[3 * s + lane - 1] = acc;
  else if (lane == 4) sq[s] = acc;
}

}  // namespace

// points (N, 3) float32; sorted_slot (N,) int32, the slot vector sorted
// ascending (stable); order (N,) int64, the row of each sorted entry;
// counts (S,), sums (S, 3), sq (S,) float32, written whole.
extern "C" int sgtd_grouped_sums(const void* points, const void* sorted_slot, const void* order, void* counts,
                                 void* sums, void* sq, int N, int S, void* stream) {
  if (S > 0) {
    grouped_sums_kernel<<<S, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(points), static_cast<const int32_t*>(sorted_slot),
        static_cast<const int64_t*>(order), static_cast<float*>(counts), static_cast<float*>(sums),
        static_cast<float*>(sq), N);
  }
  return static_cast<int>(cudaGetLastError());
}
