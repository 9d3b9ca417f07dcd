// B1 frame_votes and B6 frame_votes_wide: the per-frame vote tally of
// the probe stage; B8 gather_rows (at the end of the file): a row gather.
//
// Replaces the TPU kernels sgtd_tpu/ops/pallas_probe.py::frame_votes (a
// tiled one-hot MXU matmul) and ::frame_votes_wide (a hi/lo one-hot outer
// product on the MXU), both written so because the TPU lowers a
// scatter-add to serialized HBM updates.
//
//   counts[b, f] = sum over slots s of hit[b, s] * [frame[b, s] == f],
//   ids outside [0, f_pad) dropped; f_pad <= 2048 for B1, any for B6.
//
// Bound on this card: reading 5 bytes per slot (bool hit + int32 frame),
// 0.5 MB per query at the bench scan of 98,304 slots, 9 MB at the
// 5,000-keyframe scan of 1.8M. Design: one kernel serves both entry
// points. A grid of (slot stretches, queries); each block keeps a
// shared-memory int32 histogram of f_pad bins, counts its stretch with
// shared-memory atomics, then adds its non-zero bins into the global
// (B, f_pad) int32 counts with one global atomic each. The counts are
// integers, so the result is exact whatever order the atomics land in;
// the wrapper turns them into float32.
//
// The grid is sized from the card: as many blocks as fit on the SMs at
// once, split evenly over the queries, none with a stretch shorter than
// 4,096 slots, so clearing and flushing the f_pad bins is a small share
// of a block's work. Up to kMaxSharedBins the histogram lives in dynamic
// shared memory (above 48 KB by opt-in); above that no histogram fits in
// a block, and the slots count straight into the global counts with
// global atomics. The branch follows f_pad alone; B1's f_pad <= 2048
// always takes the shared one.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kWideThreads = 512;
constexpr int kMinWideStretch = 4096;
// 224 KB of the 227 KB of shared memory a block may opt into.
constexpr int kMaxSharedBins = 56 * 1024;

template <bool kShared>
__global__ void __launch_bounds__(kWideThreads)
    frame_votes_wide_kernel(const uint8_t* __restrict__ hit,
                            const int32_t* __restrict__ frame,
                            int32_t* __restrict__ counts, int L, int f_pad,
                            int stretch) {
  extern __shared__ int32_t hist[];
  const int b = blockIdx.y;
  int32_t* out = counts + static_cast<int64_t>(b) * f_pad;
  if (kShared) {
    for (int f = threadIdx.x; f < f_pad; f += blockDim.x) hist[f] = 0;
    __syncthreads();
  }

  const int64_t row = static_cast<int64_t>(b) * L;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * stretch;
  const int64_t end = begin + stretch < L ? begin + stretch : L;
  for (int64_t s = begin + threadIdx.x; s < end; s += blockDim.x) {
    const int f = frame[row + s];
    if (hit[row + s] && static_cast<unsigned>(f) < static_cast<unsigned>(f_pad))
      atomicAdd(kShared ? &hist[f] : &out[f], 1);
  }

  if (kShared) {
    __syncthreads();
    for (int f = threadIdx.x; f < f_pad; f += blockDim.x) {
      const int v = hist[f];
      if (v) atomicAdd(&out[f], v);
    }
  }
}

template <bool kShared>
cudaError_t launch_wide(const uint8_t* hit, const int32_t* frame,
                        int32_t* counts, int B, int L, int f_pad,
                        cudaStream_t stream) {
  auto kernel = frame_votes_wide_kernel<kShared>;
  const size_t smem = kShared ? f_pad * sizeof(int32_t) : 0;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kWideThreads, smem);
  if (err != cudaSuccess) return err;
  // One wave of blocks over the whole batch, none shorter than
  // kMinWideStretch slots; stretches are whole multiples of the block.
  const int64_t wave = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t max_blocks = (L + kMinWideStretch - 1) / kMinWideStretch;
  const int64_t blocks =
      std::max<int64_t>(1, std::min<int64_t>((wave + B - 1) / B, max_blocks));
  int64_t stretch = (L + blocks - 1) / blocks;
  stretch = (stretch + kWideThreads - 1) / kWideThreads * kWideThreads;
  dim3 grid(static_cast<unsigned>((L + stretch - 1) / stretch), B);
  kernel<<<grid, kWideThreads, smem, stream>>>(hit, frame, counts, L, f_pad,
                                              static_cast<int>(stretch));
  return cudaGetLastError();
}

}  // namespace

// counts must be zeroed by the caller (B, f_pad) int32; f_pad <= 2048.
extern "C" int sgtd_frame_votes(const void* hit, const void* frame,
                                void* counts, int B, int L, int f_pad,
                                void* stream) {
  if (B <= 0 || L <= 0) return static_cast<int>(cudaGetLastError());
  return static_cast<int>(launch_wide<true>(
      static_cast<const uint8_t*>(hit), static_cast<const int32_t*>(frame),
      static_cast<int32_t*>(counts), B, L, f_pad,
      static_cast<cudaStream_t>(stream)));
}

// counts must be zeroed by the caller (B, f_pad) int32; any f_pad >= 1.
extern "C" int sgtd_frame_votes_wide(const void* hit, const void* frame,
                                     void* counts, int B, int L, int f_pad,
                                     void* stream) {
  if (B <= 0 || L <= 0) return static_cast<int>(cudaGetLastError());
  const auto* h = static_cast<const uint8_t*>(hit);
  const auto* fr = static_cast<const int32_t*>(frame);
  auto* out = static_cast<int32_t*>(counts);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      f_pad <= kMaxSharedBins
          ? launch_wide<true>(h, fr, out, B, L, f_pad, s)
          : launch_wide<false>(h, fr, out, B, L, f_pad, s);
  return static_cast<int>(err);
}

// B8 gather_rows: out[i, :] = table[idx[i], :].
//
// Replaces the TPU kernel sgtd_tpu/ops/pallas_probe.py::gather_rows (the
// table resident in VMEM, rows copied one dynamic sublane slice at a time:
// a lowering experiment for the probe stage's row gathers, which nothing in
// the package calls). Bound on this card: bytes, L x W x 4 written and as
// many read (the rows of idx; the table itself is touched only there), plus
// 4 L of indices. What the card really moves is more: device memory
// answers a random 8-byte read with a whole sector (32 bytes; 64 where the
// memory fetches sector pairs), so at W = 2 a row of a table that does not
// fit the 50 MB L2 costs 32 to 64 + 4 + 8 bytes: 14.4M random rows of a 78
// MB table move 0.63 to 1.1 GB (0.19 to 0.33 ms) against the bound's 288 MB
// (0.086 ms). The kernel cannot undo that; what it can do is keep the L2
// for the table and make full-width accesses where rows do sit together
// (the probe stage reads runs of consecutive rows, a bucket at a time). At
// small L the call is the host's launch time, not the kernel's.
//
// Design, W = 2 (the DB's packed2 words): a thread copies two rows. It
// reads its two indices as one 8-byte load, starts both 8-byte table reads
// before the store, and writes the 16 contiguous output bytes as one
// store, so a warp's store is 512 contiguous bytes of whole sectors.
// Indices and output stream once through the card (__ldcs, __stcs: evict
// first) so that they do not push table lines out of the L2; the table
// goes through the read-only path (__ldg). The thread behind the last pair
// copies the odd row; where idx is off an 8-byte or out off a 16-byte
// boundary, every row takes a thread of its own. Other W: a word a thread,
// with the same hints.
// Tried and lost: four rows a thread with a 16-byte index load and two
// 16-byte stores (each store instruction of a warp then half-fills 32
// sectors: slower than a row a thread on random rows of an L2-resident
// table, no faster elsewhere); four rows a thread strided by the block,
// and two pairs a thread (both level with a pair a thread at twice the
// registers); a row a thread, with or without the hints (level on random
// rows, slower on sorted rows and on runs). On random rows of the large
// table every variant and index_select land within 2% of each other: the
// memory system's floor. Indices must lie in [0, M): the caller's duty, as
// in the reference.

namespace {

constexpr int kGatherThreads = 256;

// A 2-word table, a row a thread: for idx or out off its boundary.
__global__ void gather_rows2_unaligned_kernel(const int2* __restrict__ table,
                                              const int32_t* __restrict__ idx,
                                              int2* __restrict__ out, int64_t L) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < L) __stcs(out + i, __ldg(table + __ldcs(idx + i)));
}

// A 2-word table, two rows a thread; idx 8-byte and out 16-byte aligned.
__global__ void gather_rows2_kernel(const int2* __restrict__ table,
                                    const int32_t* __restrict__ idx,
                                    int2* __restrict__ out, int64_t L) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (2 * g + 1 < L) {
    const int2 i = __ldcs(reinterpret_cast<const int2*>(idx) + g);
    const int2 a = __ldg(table + i.x);
    const int2 b = __ldg(table + i.y);
    __stcs(reinterpret_cast<int4*>(out) + g, make_int4(a.x, a.y, b.x, b.y));
  } else if (2 * g < L) {
    __stcs(out + 2 * g, __ldg(table + __ldcs(idx + 2 * g)));
  }
}

__global__ void gather_rows_kernel(const int32_t* __restrict__ table,
                                   const int32_t* __restrict__ idx,
                                   int32_t* __restrict__ out, int64_t L,
                                   int W) {
  const int64_t o = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o < L * W) {
    const int64_t i = o / W;
    __stcs(out + o, __ldg(table + static_cast<int64_t>(__ldcs(idx + i)) * W + (o - i * W)));
  }
}

unsigned gather_blocks(int64_t threads) {
  return static_cast<unsigned>((threads + kGatherThreads - 1) / kGatherThreads);
}

}  // namespace

// table (M, W) int32, idx (L,) int32 in [0, M) -> out (L, W) int32. With
// W = 2, table and out must be 8-byte aligned. L * W < 2^31 * 256.
extern "C" int sgtd_gather_rows(const void* table, const void* idx, void* out,
                                long long L, int W, void* stream) {
  if (L > 0 && W > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    if (W == 2) {
      const bool aligned = reinterpret_cast<uintptr_t>(idx) % 8 == 0 &&
                           reinterpret_cast<uintptr_t>(out) % 16 == 0;
      auto kernel = aligned ? gather_rows2_kernel : gather_rows2_unaligned_kernel;
      const int64_t threads = aligned ? (L + 1) / 2 : L;
      kernel<<<gather_blocks(threads), kGatherThreads, 0, s>>>(
          static_cast<const int2*>(table), static_cast<const int32_t*>(idx),
          static_cast<int2*>(out), L);
    } else {
      const int64_t words = static_cast<int64_t>(L) * W;
      gather_rows_kernel<<<gather_blocks(words), kGatherThreads, 0, s>>>(
          static_cast<const int32_t*>(table), static_cast<const int32_t*>(idx),
          static_cast<int32_t*>(out), L, W);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
