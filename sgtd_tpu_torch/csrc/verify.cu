// B3 hypothesis_votes: the inlier counts of geometric verification.
//
// Replaces the TPU kernel sgtd_tpu/ops/pallas_verify.py::hypothesis_votes
// (candidate blocks in VMEM, nine (H, 3) @ (3, P) MXU products per
// candidate, so the (C, H, P, 3, 3) transformed vertices never reach HBM).
//
//   votes[n, h] = #{ p : pair_valid[n, p] and for every vertex a of pair p,
//                    sum_i (R_h[i,:] . vq[n,p,a] + t_h[i] - vdb[n,p,a,i])^2
//                    < thr2 },  n = query x candidate.
//
// Bound on this card: instructions, not bytes. A chunk of 16 queries x 50
// candidates x 50 hypotheses x 512 pairs is 81 float operations a (pair,
// hypothesis) over 15 MB of vertices, and every product and sum is a
// round-to-nearest intrinsic, evaluated as ((r0*x + r1*y) + r2*z) + t - v
// and ((d0^2 + d1^2) + d2^2): the compiler may not contract them into
// FMAs, so the kernel rounds exactly as the plain PyTorch version
// (ops/verify.py) does, and its floor is one instruction an operation,
// twice the time of the card's FMA-counted float32 peak. What a design
// loses beyond those 81 is instructions around them, lanes that hold no
// valid pair and schedulers that idle, and this one is laid out against
// all three:
//
//   1. The warps of a candidate's blocks split the HYPOTHESES (a warp
//      takes every (kWarps x blocks)-th), not the pairs. A warp lives on
//      one of the SM's four schedulers for good; valid pairs are a prefix
//      of a random length, so warps that split the pairs put every
//      candidate's first pairs on the same scheduler and leave the last
//      one idle three times in four. Split by hypothesis, the four do the
//      same work whatever the mask. A candidate takes 2 blocks (4 where
//      the candidates are few): blocks half as long leave less of the card
//      idle while the last ones end, and one query's 50 candidates reach
//      every SM.
//   2. Every warp walks the candidate's pairs in tiles of kTile = 32 *
//      kPairs, and takes a tile's extent (its pairs up to the last valid
//      one) with one __reduce_max_sync over the lanes' flags. A tile none
//      of whose pairs is valid (any mask, not only a prefix) is skipped; a
//      candidate with no valid pair writes zeros and ends.
//   3. In a tile a thread holds 1 to kPairs consecutive pairs (18 floats
//      each) in registers: as few as cover the tile up to its last valid
//      pair, so the ragged end of a candidate's pairs (half a tile on
//      average, most of the work of a candidate with 150 pairs) fills the
//      lanes it takes. 4 or 2 pairs are read 16 or 8 bytes a load where P
//      and the pointers allow (the warps read the same tile: the second
//      to fourth find it in L1).
//   4. R and t of a hypothesis lie as 12 floats on a 16-byte boundary in
//      shared memory: three broadcast 16-byte reads feed a thread's pairs.
//   5. A thread counts its pairs' inliers of a hypothesis in a register,
//      the warp adds the lanes' counts with one __reduce_add_sync, and lane
//      0 adds the sum to the hypothesis' counter in shared memory, which
//      only this warp touches: no ballot a pair, no atomics.
//
// Shared memory: H x (12 floats + a counter) = H x 52 bytes, 26 KB at the
// wrapper's limit of 512 hypotheses (ops/verify.py MAX_H), within the 48 KB
// a block gets without asking.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

// The launch shape (ops/verify.py's PAIRS_PER_THREAD is kPairs).
constexpr int kWarps = 4;           // warps a block, one a scheduler
constexpr int kPairs = 4;           // most pairs a thread holds
constexpr int kSplit = 2;           // blocks a candidate ...
constexpr int kSplitFew = 4;        // ... and where the candidates are few: while
constexpr int kBlocksWanted = 528;  //   that many a candidate stay within 4 an SM
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32 * kPairs;  // pairs a warp takes at a time
constexpr unsigned kFull = 0xffffffffu;

// (r . q + t - v)^2, rounded as the plain version rounds it.
__device__ __forceinline__ float dist2_term(float r0, float r1, float r2,
                                            float t, float x, float y, float z,
                                            float v) {
  float m = __fadd_rn(__fadd_rn(__fmul_rn(r0, x), __fmul_rn(r1, y)),
                      __fmul_rn(r2, z));
  float d = __fsub_rn(__fadd_rn(m, t), v);
  return __fmul_rn(d, d);
}

// K floats, and K flags, as one aligned load: for 4 and 2 pairs a lane.
template <int K> struct PairVec;
template <> struct PairVec<4> { using Floats = float4; using Flags = uint32_t; };
template <> struct PairVec<2> { using Floats = float2; using Flags = uint16_t; };

// Bit k set where pair p0 + k is in range and valid, k < K.
template <int K>
__device__ __forceinline__ unsigned valid_bits(const uint8_t* __restrict__ pv,
                                               int p0, int P, bool vec) {
  if (p0 >= P) return 0u;
  unsigned bits = 0u;
  if constexpr (K == 4 || K == 2) {
    if (vec) {  // P % 4 == 0: the K flags are one aligned word
      using Flags = typename PairVec<K>::Flags;
      const unsigned word = __ldg(reinterpret_cast<const Flags*>(pv + p0));
#pragma unroll
      for (int k = 0; k < K; ++k)
        if ((word >> (8 * k)) & 0xffu) bits |= 1u << k;
      return bits;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (p0 + k < P && pv[p0 + k]) bits |= 1u << k;
  return bits;
}

// The 9 * K floats of pairs p0 .. p0 + K - 1 (rows of src).
template <int K>
__device__ __forceinline__ void load_pairs(const float* __restrict__ src,
                                           int p0, int P, bool vec,
                                           float (&out)[9 * K]) {
  if constexpr (K == 4 || K == 2) {
    if (vec) {  // nine loads of K floats: 36 * K bytes from an aligned start
      using Floats = typename PairVec<K>::Floats;
      const Floats* rows = reinterpret_cast<const Floats*>(src + static_cast<int64_t>(p0) * 9);
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        const Floats v = __ldg(rows + i);
        const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
        for (int k = 0; k < K; ++k) out[K * i + k] = f[k];
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int i = 0; i < 9; ++i)
      out[9 * k + i] = p0 + k < P ? __ldg(src + static_cast<int64_t>(p0 + k) * 9 + i) : 0.0f;
  }
}

// One warp, one tile from pair `base` on, K consecutive pairs a lane: the
// warp's hypotheses' inliers among them, added to their counters.
template <int K>
__device__ __forceinline__ void vote_tile(const float4* __restrict__ rt4, int32_t* cnt,
                                          const float* __restrict__ sq,
                                          const float* __restrict__ sd,
                                          const uint8_t* __restrict__ pv, int base, int P,
                                          bool vec, float thr2, int H, int warp, int lane) {
  const int p0 = base + lane * K;
  const unsigned bits = valid_bits<K>(pv, p0, P, vec);
  float q[9 * K], d[9 * K];
  if (bits != 0u) {
    load_pairs<K>(sq, p0, P, vec, q);
    load_pairs<K>(sd, p0, P, vec, d);
  } else {
#pragma unroll
    for (int i = 0; i < 9 * K; ++i) q[i] = d[i] = 0.0f;
  }
  for (int h = blockIdx.y * kWarps + warp; h < H; h += kWarps * gridDim.y) {
    const float4 a = rt4[3 * h], b = rt4[3 * h + 1], c = rt4[3 * h + 2];
    // R = (a.x a.y a.z; a.w b.x b.y; b.z b.w c.x), t = (c.y c.z c.w).
    int count = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      bool inlier = (bits >> k) & 1u;
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        const float x = q[9 * k + 3 * v], y = q[9 * k + 3 * v + 1], z = q[9 * k + 3 * v + 2];
        float s = dist2_term(a.x, a.y, a.z, c.y, x, y, z, d[9 * k + 3 * v]);
        s = __fadd_rn(s, dist2_term(a.w, b.x, b.y, c.z, x, y, z, d[9 * k + 3 * v + 1]));
        s = __fadd_rn(s, dist2_term(b.z, b.w, c.x, c.w, x, y, z, d[9 * k + 3 * v + 2]));
        inlier = inlier && (s < thr2);
      }
      count += inlier;
    }
    const int sum = __reduce_add_sync(kFull, count);
    if (lane == 0) cnt[h] += sum;
  }
}

__global__ void __launch_bounds__(kThreads)
hypothesis_votes_kernel(const float* __restrict__ rot, const float* __restrict__ trans,
                        const float* __restrict__ vq, const float* __restrict__ vdb,
                        const uint8_t* __restrict__ pair_valid, int32_t* __restrict__ votes,
                        int H, int P, float thr2, int vec_flag) {
  extern __shared__ float4 smem4[];
  float* RT = reinterpret_cast<float*>(smem4);             // (H, 12): R row-major, then t
  int32_t* cnt = reinterpret_cast<int32_t*>(RT + 12 * H);  // (H,)

  const int64_t n = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool vec = vec_flag != 0;
  const uint8_t* pv = pair_valid + n * P;

  // Whether the candidate has a valid pair at all, beside the rotations'
  // fetch.
  bool mine = false;
  for (int p0 = tid * kPairs; p0 < P; p0 += kThreads * kPairs)
    mine |= valid_bits<kPairs>(pv, p0, P, vec) != 0u;
  for (int i = tid; i < 9 * H; i += kThreads)
    RT[(i / 9) * 12 + i % 9] = rot[n * 9 * H + i];
  for (int i = tid; i < 3 * H; i += kThreads)
    RT[(i / 3) * 12 + 9 + i % 3] = trans[n * 3 * H + i];
  for (int h = tid; h < H; h += kThreads) cnt[h] = 0;
  // A candidate without a valid pair writes zeros and ends.
  if (!__syncthreads_or(mine)) {
    for (int h = tid; h < H; h += kThreads)
      if ((h / kWarps) % gridDim.y == blockIdx.y) votes[n * H + h] = 0;
    return;
  }

  const float* sq = vq + n * P * 9;
  const float* sd = vdb + n * P * 9;
  // No barrier in this loop: each warp walks the tiles at its own pace, and
  // gives a lane as many pairs as cover the tile's extent.
  for (int base = 0; base < P; base += kTile) {
    const unsigned bits = valid_bits<kPairs>(pv, base + lane * kPairs, P, vec);
    const int last = bits ? lane * kPairs + 31 - __clz(bits) : -1;
    const int extent = __reduce_max_sync(kFull, last) + 1;
    switch ((extent + 31) >> 5) {
      case 0: break;
      case 1: vote_tile<1>(smem4, cnt, sq, sd, pv, base, P, vec, thr2, H, warp, lane); break;
      case 2: vote_tile<2>(smem4, cnt, sq, sd, pv, base, P, vec, thr2, H, warp, lane); break;
      case 3: vote_tile<3>(smem4, cnt, sq, sd, pv, base, P, vec, thr2, H, warp, lane); break;
      default: vote_tile<4>(smem4, cnt, sq, sd, pv, base, P, vec, thr2, H, warp, lane); break;
    }
  }
  __syncthreads();
  for (int h = tid; h < H; h += kThreads)
    if ((h / kWarps) % gridDim.y == blockIdx.y) votes[n * H + h] = cnt[h];
}

// Blocks a candidate: kSplitFew where that many still leave the card room
// (one query's 50 candidates), else kSplit; never more than there are
// groups of kWarps hypotheses.
inline int votes_plan(int N, int H) {
  const int split = static_cast<int64_t>(N) * kSplitFew <= kBlocksWanted ? kSplitFew : kSplit;
  const int groups = (H + kWarps - 1) / kWarps;
  return split < groups ? split : groups;
}

}  // namespace

// rot (N, H, 3, 3), trans (N, H, 3), vq/vdb (N, P, 3, 3) float32;
// pair_valid (N, P) bool; votes (N, H) int32.
extern "C" int sgtd_hypothesis_votes(const void* rot, const void* trans,
                                     const void* vq, const void* vdb,
                                     const void* pair_valid, void* votes,
                                     int N, int H, int P, float thr2,
                                     void* stream) {
  static_assert(kPairs == 4, "vote_tile is instantiated for 1 to 4 pairs a lane");
  if (N > 0 && H > 0) {
    const size_t smem = static_cast<size_t>(H) * (12 * sizeof(float) + sizeof(int32_t));
    // 16-byte loads of 4 pairs' rows (8-byte of 2) and a word of their
    // flags need every candidate's first pair on those boundaries.
    auto aligned = [](const void* p, uintptr_t to) {
      return reinterpret_cast<uintptr_t>(p) % to == 0;
    };
    const int vec = P % kPairs == 0 && aligned(vq, 16) && aligned(vdb, 16) &&
                    aligned(pair_valid, 4);
    hypothesis_votes_kernel<<<dim3(N, votes_plan(N, H)), kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rot), static_cast<const float*>(trans),
        static_cast<const float*>(vq), static_cast<const float*>(vdb),
        static_cast<const uint8_t*>(pair_valid), static_cast<int32_t*>(votes),
        H, P, thr2, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
