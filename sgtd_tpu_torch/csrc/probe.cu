// B1 frame_votes and B6 frame_votes_wide: the per-frame vote tally of
// the probe stage; B8 gather_rows (at the end of the file): a row gather.
//
// Replaces the TPU kernels sgtd_tpu/ops/pallas_probe.py::frame_votes (a
// tiled one-hot MXU matmul) and ::frame_votes_wide (a hi/lo one-hot outer
// product on the MXU), both written so because the TPU lowers a
// scatter-add to serialized HBM updates.
//
//   counts[b, f] = sum over slots s of hit[b, s] * [frame[b, s] == f],
//   ids outside [0, f_pad) dropped; f_pad <= kMaxFPad for B1, any for B6.
//
// Bound on this card: bytes, 5 a slot (bool hit + int32 frame): 7.9 MB a
// chunk of 16 queries at the bench scan of 98,304 slots (0.0024 ms at
// 3.35 TB/s), 72 MB at the 5,000-keyframe chunk of 8 x 1.8M. What holds
// B1 at that size is latency: the launch itself and a barrier between the
// blocks of a cluster take much of its time, so the design keeps to one
// launch and one barrier.
//
// B1 design: one launch writes the float32 counts whole, so the caller
// neither zeroes a buffer before nor converts one after. A query is one
// thread-block cluster of kClusterBlocks blocks (Hopper's distributed
// shared memory):
//
//   1. Each block clears a shared int32 histogram of f_pad bins and
//      counts its stretch of the row into it with shared-memory atomics.
//      The row goes by 16-slot groups: the slots before the first 16-byte
//      boundary of hit (the head: a row starts at byte b * L of hit and
//      4 b * L of frame) and after the last whole group (the tail) go one
//      by one over all of the cluster's threads; where frame is not
//      16-byte aligned at that boundary too, the whole row does. The
//      groups split over the cluster's blocks in contiguous stretches. A
//      warp takes 32 consecutive groups (512 slots) a trip: lane t reads
//      the hit bytes of slots 128 k + 4 t .. + 3 (k = 0..3) as one 4-byte
//      load and their frame ids as one 16-byte load, so every load of the
//      warp is 128 or 512 contiguous bytes; a piece whose 4 hit bytes are
//      all zero skips its frame load (slots past a query's scan total are
//      all misses: the scan is sized 1.5x the largest total seen, and
//      about 60% of a real chunk's 16-slot groups hold no hit).
//   2. Block rank q writes the bins of slice r ([r ceil(f_pad / C), ...))
//      into row q of block r's shared staging array (plain remote stores,
//      each entry written once), after a split cluster barrier begun at
//      the kernel's start has made sure every block of the cluster runs.
//   3. One cluster.sync(); then block r sums the C rows of its staging
//      array and stores its slice of the counts as float32: every bin is
//      written exactly once, ranks past f_pad own none. No block touches
//      another's shared memory after the barrier, so none has to wait
//      before it leaves.
//
// No global atomics, no scratch in device memory and no state between
// calls; int32 sums are exact in any order, so two launches give the same
// bits. A launch reads no device attribute or occupancy: what it needs of
// the device (clusters of kClusterBlocks allowed and schedulable) is
// checked once per device, keyed by cudaGetDevice. Tried (PERF.md §6): 4, 8 and 16 blocks a cluster, 256 to
// 1,024 threads, a 16-byte hit load and four 16-byte frame loads a thread,
// warp aggregation of equal ids (__match_any_sync), pulling the slices
// over distributed shared memory between two cluster barriers, pushing
// them with remote atomics; each was slower than this.
//
// B6 design: a grid of (slot stretches, queries), one wave of blocks
// over the batch, none with a stretch shorter than
// kMinWideStretch; each block keeps a shared int32 histogram up to
// kMaxSharedBins bins (above 48 KB by opt-in) and adds its non-zero bins
// into the zeroed global int32 counts with one atomic each; above that,
// slots count straight into the global counts. The SM count and the
// kernel's blocks an SM are read once per (device, branch, shared size).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>
#include <map>
#include <mutex>
#include <set>
#include <tuple>

namespace cg = cooperative_groups;

namespace {

// B1's launch shape (tests/test_torch_probe.py reads it).
constexpr int kClusterBlocks = 12;   // C: blocks of a query's cluster
constexpr int kVotesThreads = 512;   // threads a block
constexpr int kGroupSlots = 16;      // slots of a group, 16-byte aligned in hit
constexpr int kMaxFPad = 2048;       // widest frame axis of B1 (8 KB of bins)

__device__ __forceinline__ void vote(int* hist, unsigned hit, int f, int f_pad) {
  if (hit && static_cast<unsigned>(f) < static_cast<unsigned>(f_pad)) atomicAdd(&hist[f], 1);
}

// Four consecutive slots: byte j of the hit word, frame id j.
__device__ __forceinline__ void vote4(int* hist, unsigned w, int4 f, int f_pad) {
  vote(hist, w & 0xffu, f.x, f_pad);
  vote(hist, (w >> 8) & 0xffu, f.y, f_pad);
  vote(hist, (w >> 16) & 0xffu, f.z, f_pad);
  vote(hist, w >> 24, f.w, f_pad);
}

// Shared ints of a block: the histogram (f_pad) and the staging array
// (C rows of a slice).
__host__ __device__ constexpr int votes_shared_ints(int f_pad, int c) {
  return f_pad + c * ((f_pad + c - 1) / c);
}

template <int C>
__global__ void __launch_bounds__(kVotesThreads)
    frame_votes_kernel(const uint8_t* __restrict__ hit, const int32_t* __restrict__ frame,
                       float* __restrict__ counts, int L, int f_pad) {
  extern __shared__ int hist[];
  const int slice = (f_pad + C - 1) / C;
  int* stage = hist + f_pad;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t b = blockIdx.x / C;
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  for (int f = threadIdx.x; f < f_pad; f += kVotesThreads) hist[f] = 0;
  __syncthreads();

  const uint8_t* h = hit + b * L;
  const int32_t* fr = frame + b * L;
  int head = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(h) & 15)) & 15);
  head = min(head, L);
  int groups = (L - head) / kGroupSlots;
  if (reinterpret_cast<uintptr_t>(fr + head) & 15) head = groups = 0;  // the whole row one by one
  const int vec_end = head + groups * kGroupSlots;
  const int n_scalar = head + (L - vec_end);
  for (int i = rank * kVotesThreads + threadIdx.x; i < n_scalar; i += C * kVotesThreads) {
    const int s = i < head ? i : vec_end + (i - head);
    vote(hist, h[s], fr[s], f_pad);
  }

  const int per_block = (groups + C - 1) / C;
  const int g_begin = min(groups, rank * per_block);
  const int g_end = min(groups, g_begin + per_block);
  const unsigned* hw = reinterpret_cast<const unsigned*>(h + head);
  const int4* fv = reinterpret_cast<const int4*>(fr + head);
  const int lane = threadIdx.x & 31;
  for (int g0 = g_begin + static_cast<int>(threadIdx.x & ~31u); g0 < g_end; g0 += kVotesThreads) {
    unsigned w[4];
    int4 f4[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int piece = 32 * k + lane;  // of the warp's 128 pieces of 4 slots
      w[k] = g0 + (piece >> 2) < g_end ? __ldg(hw + 4 * g0 + piece) : 0u;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      f4[k] = w[k] ? __ldg(fv + 4 * g0 + 32 * k + lane) : make_int4(-1, -1, -1, -1);
#pragma unroll
    for (int k = 0; k < 4; ++k) vote4(hist, w[k], f4[k], f_pad);
  }
  __syncthreads();

  // Every block of the cluster runs: stage the slices at their owners.
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int f = threadIdx.x; f < f_pad; f += kVotesThreads) {
    const int owner = f / slice;
    cluster.map_shared_rank(stage, owner)[rank * slice + (f - owner * slice)] = hist[f];
  }
  cluster.sync();
  float* out = counts + b * f_pad;
  const int f_end = min(f_pad, (rank + 1) * slice);
  for (int f = rank * slice + threadIdx.x; f < f_end; f += kVotesThreads) {
    int sum = 0;
#pragma unroll
    for (int q = 0; q < C; ++q) sum += stage[q * slice + (f - rank * slice)];
    out[f] = static_cast<float>(sum);
  }
}

// What B1 and B6 need of a device, read from it once: guarded by one mutex.
std::mutex g_device_mutex;
// Devices on which B1's cluster kernel was found to schedule.
std::set<int> g_votes_ready;

// Once per device: allow clusters above the portable 8 blocks where
// kClusterBlocks asks for them, and check that one cluster of the widest
// histogram fits on the device.
cudaError_t votes_ready(int device) {
  std::lock_guard<std::mutex> lock(g_device_mutex);
  if (g_votes_ready.count(device)) return cudaSuccess;
  auto kernel = frame_votes_kernel<kClusterBlocks>;
  cudaError_t err = cudaSuccess;
  if (kClusterBlocks > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kClusterBlocks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kClusterBlocks);
  cfg.blockDim = dim3(kVotesThreads);
  cfg.dynamicSmemBytes = votes_shared_ints(kMaxFPad, kClusterBlocks) * sizeof(int);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  g_votes_ready.insert(device);
  return cudaSuccess;
}

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
  extern __shared__ int32_t wide_hist[];
  const int b = blockIdx.y;
  int32_t* out = counts + static_cast<int64_t>(b) * f_pad;
  if (kShared) {
    for (int f = threadIdx.x; f < f_pad; f += blockDim.x) wide_hist[f] = 0;
    __syncthreads();
  }

  const int64_t row = static_cast<int64_t>(b) * L;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * stretch;
  const int64_t end = begin + stretch < L ? begin + stretch : L;
  for (int64_t s = begin + threadIdx.x; s < end; s += blockDim.x) {
    const int f = frame[row + s];
    if (hit[row + s] && static_cast<unsigned>(f) < static_cast<unsigned>(f_pad))
      atomicAdd(kShared ? &wide_hist[f] : &out[f], 1);
  }

  if (kShared) {
    __syncthreads();
    for (int f = threadIdx.x; f < f_pad; f += blockDim.x) {
      const int v = wide_hist[f];
      if (v) atomicAdd(&out[f], v);
    }
  }
}

// Under g_device_mutex: (device, branch, shared bytes) -> blocks of one
// wave; device -> the dynamic shared memory the shared branch is opted into.
std::map<std::tuple<int, bool, size_t>, int64_t> g_wide_wave;
std::map<int, size_t> g_wide_opt_in;

// Blocks the card holds at once of the kernel at this shared size, read
// from the device once per (device, branch, size).
template <bool kShared>
cudaError_t wide_wave(size_t smem, int64_t* wave) {
  auto kernel = frame_votes_wide_kernel<kShared>;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(g_device_mutex);
  const auto key = std::make_tuple(device, kShared, smem);
  const auto found = g_wide_wave.find(key);
  if (found != g_wide_wave.end()) {
    *wave = found->second;
    return cudaSuccess;
  }
  if (smem > 48 * 1024 && g_wide_opt_in[device] < smem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    g_wide_opt_in[device] = smem;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWideThreads, smem);
  if (err != cudaSuccess) return err;
  *wave = g_wide_wave[key] = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

template <bool kShared>
cudaError_t launch_wide(const uint8_t* hit, const int32_t* frame,
                        int32_t* counts, int B, int L, int f_pad,
                        cudaStream_t stream) {
  const size_t smem = kShared ? f_pad * sizeof(int32_t) : 0;
  int64_t wave = 0;
  const cudaError_t err = wide_wave<kShared>(smem, &wave);
  if (err != cudaSuccess) return err;
  // One wave of blocks over the whole batch, none shorter than
  // kMinWideStretch slots; stretches are whole multiples of the block.
  const int64_t max_blocks = (L + kMinWideStretch - 1) / kMinWideStretch;
  const int64_t blocks =
      std::max<int64_t>(1, std::min<int64_t>((wave + B - 1) / B, max_blocks));
  int64_t stretch = (L + blocks - 1) / blocks;
  stretch = (stretch + kWideThreads - 1) / kWideThreads * kWideThreads;
  dim3 grid(static_cast<unsigned>((L + stretch - 1) / stretch), B);
  frame_votes_wide_kernel<kShared><<<grid, kWideThreads, smem, stream>>>(
      hit, frame, counts, L, f_pad, static_cast<int>(stretch));
  return cudaGetLastError();
}

}  // namespace

// hit (B, L) bool, frame (B, L) int32 -> counts (B, f_pad) float32, every
// element written (no zeroing needed); 0 < f_pad <= kMaxFPad, L >= 0.
extern "C" int sgtd_frame_votes(const void* hit, const void* frame, void* counts, int B, int L,
                                int f_pad, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  if (L < 0 || f_pad <= 0 || f_pad > kMaxFPad || B > INT_MAX / kClusterBlocks)
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = votes_ready(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kClusterBlocks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kClusterBlocks * B);
  cfg.blockDim = dim3(kVotesThreads);
  cfg.dynamicSmemBytes = votes_shared_ints(f_pad, kClusterBlocks) * sizeof(int);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, frame_votes_kernel<kClusterBlocks>, static_cast<const uint8_t*>(hit),
                           static_cast<const int32_t*>(frame), static_cast<float*>(counts), L, f_pad);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
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
