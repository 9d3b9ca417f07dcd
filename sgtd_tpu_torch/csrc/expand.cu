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
//   compaction. Slots at or past the total carry a valid job's payload
//   (don't-care for the caller); jobs whose heads lie at or past l_max
//   are never reached (truncation).
//
// Bound on this card: writing C * 4 bytes per slot (C = 5 channels, 31 MB
// per chunk of 16 queries at the bench scan of 98,304 slots). Design: one
// thread per slot runs an upper_bound over the query's NJ + 1 prefix
// offsets (17 steps over 55,297 offsets, which stay L2-resident), then
// copies the job's C int32 values; consecutive threads write consecutive
// slots of each channel, so the stores coalesce. Payload values are plain
// int32 of any sign: no limb split and no limit on l_max.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void expand_jobs_kernel(const int32_t* __restrict__ offsets,
                                   const int32_t* __restrict__ payload,
                                   int32_t* __restrict__ out, int NJ, int C,
                                   int l_max) {
  const int b = blockIdx.y;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= l_max) return;
  const int32_t* off = offsets + static_cast<int64_t>(b) * (NJ + 1);
  // Largest j in [0, NJ) with off[j] <= s (off[0] == 0 <= s).
  int lo = 0, hi = NJ;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (off[mid] <= s) lo = mid; else hi = mid;
  }
  const int32_t* src = payload + (static_cast<int64_t>(b) * NJ + lo) * C;
  int32_t* dst = out + static_cast<int64_t>(b) * C * l_max + s;
  for (int c = 0; c < C; ++c) dst[static_cast<int64_t>(c) * l_max] = src[c];
}

}  // namespace

// offsets (B, NJ + 1) int32 exclusive prefix sums of the job lengths;
// payload (B, NJ, C) int32; out (B, C, l_max) int32.
extern "C" int sgtd_expand_jobs(const void* offsets, const void* payload,
                                void* out, int B, int NJ, int C, int l_max,
                                void* stream) {
  if (B > 0 && NJ > 0 && l_max > 0) {
    dim3 grid((l_max + kThreads - 1) / kThreads, B);
    expand_jobs_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(offsets),
        static_cast<const int32_t*>(payload), static_cast<int32_t*>(out), NJ,
        C, l_max);
  }
  return static_cast<int>(cudaGetLastError());
}
