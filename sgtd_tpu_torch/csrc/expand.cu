// B2 expand_jobs: the ragged probe expansion from jobs to scan slots.
//
// Replaces the TPU kernel sgtd_tpu/ops/pallas_expand.py::expand_jobs (a
// sorted-heads window of step-function masks fed to the MXU, with f32
// limb splits because the MXU is exact only below 2^24; Mosaic rejected
// it on the chip) and the XLA delta-scatter + cumsum it stood in for
// (sgtd_tpu/match/search.py::_expand).
//
//   out[b, c, s] = payload[b, job(s), c] for s < l_max, where job(s) is
//   the last job whose head offset offsets[b, j] <= s. Job segments are
//   contiguous, so the last job with head <= s is the non-empty one that
//   holds s: empty jobs share a head with their successor and need no
//   compaction. Slots at or past the total carry the payload of the last
//   non-empty job or of an empty one after it (don't-care for the caller,
//   the same bits on every launch); jobs whose heads lie at or past l_max
//   are never reached (truncation).
//
// Bound on this card: bytes. C * 4 bytes written a slot (31.5 MB a chunk
// of 16 queries at the bench scan of 98,304 slots and 5 channels) and the
// offsets and payload read once (21 MB): 0.016 ms at 3.35 TB/s. A thread a
// slot with a search of its own reads 16 dependent offsets a slot, to place
// slots whose neighbours nearly always share a job. Design: a block owns a
// tile of consecutive slots of one query (kSlots a thread, consecutive, so
// a thread stores 16 bytes a channel).
//
//   1. Two searches a block: warp 0 finds the job of the tile's first slot
//      and warp 1 that of its last, each by a 32-ary search (a probe a
//      lane, one ballot a step: 4 dependent reads over 55,297 offsets).
//   2. The block walks the jobs between the two once, coalesced, and
//      stores each non-empty job's index at its head's place in a shared
//      array of the tile. Non-empty jobs have distinct heads, so the stores
//      are plain, and an empty job never shadows its successor. A run of
//      empty jobs of any length is only read.
//   3. An inclusive max-scan over the tile (in a thread, then by warp
//      shuffles, then over the warps' totals), seeded with the first
//      slot's job, gives every slot its job.
//   4. Each thread reads its slots' payload rows through the read-only
//      path (neighbours share a row: a row is read again only where the
//      job changes) and stores kSlots values a channel, as one 16-byte
//      store where l_max and the pointer allow, one by one otherwise.
//
// So each offset is read about once where the slots of a query read
// 16 x l_max. The block size is chosen at launch (expand_plan): tiles of
// 1,024 slots where they give the card kBlocksWanted blocks, smaller ones
// for a small batch. Payload values are plain int32 of any sign: no limb
// split and no limit on l_max.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kSlots = 4;            // consecutive slots a thread (one 16-byte store a channel)
constexpr int kMaxThreads = 256;     // threads a block: a power of two in
constexpr int kMinThreads = 64;      //   [kMinThreads, kMaxThreads]
constexpr int kBlocksWanted = 528;   // blocks the plan aims for (4 on each of 132 SMs)
constexpr unsigned kFull = 0xffffffffu;

// Largest j in [0, NJ) with off[j] <= s, by the whole warp: every step
// probes 32 evenly spaced offsets of the range left. off[0] == 0 <= s.
__device__ __forceinline__ int warp_search(const int32_t* __restrict__ off,
                                           int NJ, int s, int lane) {
  int lo = 0, n = NJ;  // the answer lies in [lo, lo + n) and off[lo] <= s
  while (n > 1) {
    const int step = (n + 31) >> 5;
    const int j = lo + lane * step;
    const bool le = j < lo + n && __ldg(off + j) <= s;
    // off ascends, so the lanes that hold are a prefix (lane 0 always).
    const int k = 31 - __clz(__ballot_sync(kFull, le));
    const int end = lo + n;
    lo += k * step;
    n = min(step, end - lo);
  }
  return lo;
}

__global__ void expand_jobs_kernel(const int32_t* __restrict__ offsets,
                                   const int32_t* __restrict__ payload,
                                   int32_t* __restrict__ out, int NJ, int C,
                                   int l_max, int vec) {
  __shared__ __align__(16) int32_t mark[kMaxThreads * kSlots];
  __shared__ int32_t warp_max[kMaxThreads / 32];
  __shared__ int32_t ends[2];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockDim.x * kSlots;
  const int b = blockIdx.y;
  const int s0 = blockIdx.x * tile;                // the tile's first slot
  const int s1 = min(s0 + tile, l_max) - 1;        // ... and its last
  const int32_t* off = offsets + static_cast<int64_t>(b) * (NJ + 1);

  reinterpret_cast<int4*>(mark)[tid] = make_int4(-1, -1, -1, -1);
  if (warp < 2) {
    const int j = warp_search(off, NJ, warp == 0 ? s0 : s1, lane);
    if (lane == 0) ends[warp] = j;
  }
  __syncthreads();
  const int j_first = ends[0], j_last = ends[1];

  // Jobs in (j_first, j_last] have heads in (s0, s1].
  for (int j = j_first + 1 + tid; j <= j_last; j += blockDim.x) {
    const int head = __ldg(off + j);
    if (head != __ldg(off + j + 1)) mark[head - s0] = j;
  }
  __syncthreads();

  // Inclusive max-scan: in the thread, over the warp, over the warps.
  const int4 m = reinterpret_cast<const int4*>(mark)[tid];
  int job[kSlots] = {m.x, max(m.x, m.y), 0, 0};
  job[2] = max(job[1], m.z);
  job[3] = max(job[2], m.w);
  int incl = job[kSlots - 1];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl = max(incl, up);
  }
  if (lane == 31) warp_max[warp] = incl;
  int before = __shfl_up_sync(kFull, incl, 1);  // the lanes below this one
  if (lane == 0) before = -1;
  __syncthreads();
  before = max(before, j_first);
  for (int w = 0; w < warp; ++w) before = max(before, warp_max[w]);
#pragma unroll
  for (int k = 0; k < kSlots; ++k) job[k] = max(job[k], before);

  const int s = s0 + tid * kSlots;
  if (s >= l_max) return;
  const int32_t* rows = payload + static_cast<int64_t>(b) * NJ * C;
  int32_t* dst = out + static_cast<int64_t>(b) * C * l_max + s;
  const bool same = job[0] == job[kSlots - 1];  // jobs ascend: one row for all
  if (vec && s + kSlots <= l_max) {
    for (int c = 0; c < C; ++c) {
      int4 v;
      v.x = __ldg(rows + static_cast<int64_t>(job[0]) * C + c);
      if (same) {
        v.y = v.z = v.w = v.x;
      } else {
        v.y = __ldg(rows + static_cast<int64_t>(job[1]) * C + c);
        v.z = __ldg(rows + static_cast<int64_t>(job[2]) * C + c);
        v.w = __ldg(rows + static_cast<int64_t>(job[3]) * C + c);
      }
      *reinterpret_cast<int4*>(dst + static_cast<int64_t>(c) * l_max) = v;
    }
  } else {
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        if (s + k < l_max)
          dst[static_cast<int64_t>(c) * l_max + k] =
              __ldg(rows + static_cast<int64_t>(job[k]) * C + c);
      }
    }
  }
}

// Threads a block: the largest power of two in [kMinThreads, kMaxThreads]
// whose tiles give the card kBlocksWanted blocks, else kMinThreads.
inline int expand_plan(int B, int l_max) {
  int threads = kMaxThreads;
  while (threads > kMinThreads) {
    const int64_t tile = static_cast<int64_t>(threads) * kSlots;
    if (B * ((l_max + tile - 1) / tile) >= kBlocksWanted) break;
    threads >>= 1;
  }
  return threads;
}

}  // namespace

// offsets (B, NJ + 1) int32 exclusive prefix sums of the job lengths;
// payload (B, NJ, C) int32; out (B, C, l_max) int32.
extern "C" int sgtd_expand_jobs(const void* offsets, const void* payload,
                                void* out, int B, int NJ, int C, int l_max,
                                void* stream) {
  static_assert(kSlots == 4, "a thread's slots are one int4 store a channel");
  if (B > 0 && NJ > 0 && l_max > 0) {
    const int threads = expand_plan(B, l_max);
    const int tile = threads * kSlots;
    dim3 grid((l_max + tile - 1) / tile, B);
    // 16-byte stores need every channel's row, and so l_max, on a 16-byte
    // boundary.
    const int vec = l_max % kSlots == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
    expand_jobs_kernel<<<grid, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(offsets),
        static_cast<const int32_t*>(payload), static_cast<int32_t*>(out), NJ,
        C, l_max, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
