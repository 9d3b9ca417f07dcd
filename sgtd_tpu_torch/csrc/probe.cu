// B1 frame_votes: the per-frame vote tally of the probe stage.
//
// Replaces the TPU kernel sgtd_tpu/ops/pallas_probe.py::frame_votes (a
// tiled one-hot MXU matmul, written so because the TPU lowers a
// scatter-add to serialized HBM updates).
//
//   counts[b, f] = sum over slots s of hit[b, s] * [frame[b, s] == f],
//   ids outside [0, f_pad) dropped, f_pad <= 2048.
//
// Bound on this card: reading 5 bytes per slot (bool hit + int32 frame),
// 0.5 MB per query at the bench scan of 98,304 slots. Design: a grid of
// (slot stretches, queries); each block keeps a shared-memory int32
// histogram of f_pad bins (8 KB at most), counts its stretch with
// shared-memory atomics, then adds its non-zero bins into the global
// (B, f_pad) int32 counts with one global atomic each. The counts are
// integers, so the result is exact whatever order the atomics land in;
// the wrapper turns them into float32.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSlotsPerThread = 16;

__global__ void frame_votes_kernel(const uint8_t* __restrict__ hit,
                                   const int32_t* __restrict__ frame,
                                   int32_t* __restrict__ counts, int L,
                                   int f_pad) {
  extern __shared__ int32_t hist[];
  const int b = blockIdx.y;
  for (int f = threadIdx.x; f < f_pad; f += blockDim.x) hist[f] = 0;
  __syncthreads();

  const int64_t row = static_cast<int64_t>(b) * L;
  const int stretch = blockDim.x * kSlotsPerThread;
  const int begin = blockIdx.x * stretch;
  const int end = min(begin + stretch, L);
  for (int s = begin + threadIdx.x; s < end; s += blockDim.x) {
    const int f = frame[row + s];
    if (hit[row + s] && f >= 0 && f < f_pad) atomicAdd(&hist[f], 1);
  }
  __syncthreads();

  int32_t* out = counts + static_cast<int64_t>(b) * f_pad;
  for (int f = threadIdx.x; f < f_pad; f += blockDim.x) {
    const int v = hist[f];
    if (v) atomicAdd(&out[f], v);
  }
}

}  // namespace

// counts must be zeroed by the caller (B, f_pad) int32.
extern "C" int sgtd_frame_votes(const void* hit, const void* frame,
                                void* counts, int B, int L, int f_pad,
                                void* stream) {
  if (B > 0 && L > 0) {
    const int stretch = kThreads * kSlotsPerThread;
    dim3 grid((L + stretch - 1) / stretch, B);
    frame_votes_kernel<<<grid, kThreads, f_pad * sizeof(int32_t),
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(hit), static_cast<const int32_t*>(frame),
        static_cast<int32_t*>(counts), L, f_pad);
  }
  return static_cast<int>(cudaGetLastError());
}
