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
// Bound on this card: arithmetic and launch latency, not bytes. A chunk of
// 16 queries x 50 candidates x 50 hypotheses x 512 pairs x 9 coordinates
// is about 1.2 GFLOP over 15 MB of vertices. Design: one block per
// candidate; the H rotations and translations sit in shared memory; one
// thread per pair holds its 18 vertex coordinates in registers and walks
// the hypotheses; each warp counts its inlier bits with __ballot_sync +
// __popc and one lane adds the count into a shared per-hypothesis counter.
// Every product and sum is a round-to-nearest intrinsic, evaluated as
// ((r0*x + r1*y) + r2*z) + t - v and ((d0^2 + d1^2) + d2^2): the compiler
// may not contract them into FMAs, so the kernel rounds exactly as the
// plain PyTorch version (ops/verify.py) does.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float dist2_term(const float* r, float t, float x,
                                            float y, float z, float v) {
  float m = __fadd_rn(__fadd_rn(__fmul_rn(r[0], x), __fmul_rn(r[1], y)),
                      __fmul_rn(r[2], z));
  float d = __fsub_rn(__fadd_rn(m, t), v);
  return __fmul_rn(d, d);
}

__global__ void hypothesis_votes_kernel(
    const float* __restrict__ rot, const float* __restrict__ trans,
    const float* __restrict__ vq, const float* __restrict__ vdb,
    const uint8_t* __restrict__ pair_valid, int32_t* __restrict__ votes,
    int H, int P, float thr2) {
  extern __shared__ float smem[];
  float* R = smem;                                     // (H, 9)
  float* T = smem + 9 * H;                             // (H, 3)
  int32_t* cnt = reinterpret_cast<int32_t*>(T + 3 * H);  // (H,)

  const int64_t n = blockIdx.x;
  for (int i = threadIdx.x; i < 9 * H; i += blockDim.x)
    R[i] = rot[n * 9 * H + i];
  for (int i = threadIdx.x; i < 3 * H; i += blockDim.x)
    T[i] = trans[n * 3 * H + i];
  for (int i = threadIdx.x; i < H; i += blockDim.x) cnt[i] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  // The loop bound is uniform across the block, so every lane of every
  // warp reaches each __ballot_sync.
  for (int base = 0; base < P; base += blockDim.x) {
    const int p = base + threadIdx.x;
    const bool active = p < P && pair_valid[n * P + p];
    float q[9], d[9];
    if (active) {
      const float* sq = vq + (n * P + p) * 9;
      const float* sd = vdb + (n * P + p) * 9;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        q[k] = sq[k];
        d[k] = sd[k];
      }
    }
    for (int h = 0; h < H; ++h) {
      bool inlier = active;
      if (active) {
        const float* r = R + 9 * h;
        const float* t = T + 3 * h;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float x = q[3 * a], y = q[3 * a + 1], z = q[3 * a + 2];
          float s = dist2_term(r, t[0], x, y, z, d[3 * a]);
          s = __fadd_rn(s, dist2_term(r + 3, t[1], x, y, z, d[3 * a + 1]));
          s = __fadd_rn(s, dist2_term(r + 6, t[2], x, y, z, d[3 * a + 2]));
          inlier = inlier && (s < thr2);
        }
      }
      const unsigned bits = __ballot_sync(0xffffffffu, inlier);
      if (lane == 0 && bits) atomicAdd(&cnt[h], __popc(bits));
    }
  }
  __syncthreads();
  for (int h = threadIdx.x; h < H; h += blockDim.x) votes[n * H + h] = cnt[h];
}

}  // namespace

// rot (N, H, 3, 3), trans (N, H, 3), vq/vdb (N, P, 3, 3) float32;
// pair_valid (N, P) bool; votes (N, H) int32.
extern "C" int sgtd_hypothesis_votes(const void* rot, const void* trans,
                                     const void* vq, const void* vdb,
                                     const void* pair_valid, void* votes,
                                     int N, int H, int P, float thr2,
                                     void* stream) {
  if (N > 0 && H > 0) {
    const size_t smem = static_cast<size_t>(H) * (12 * sizeof(float) +
                                                  sizeof(int32_t));
    hypothesis_votes_kernel<<<N, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rot), static_cast<const float*>(trans),
        static_cast<const float*>(vq), static_cast<const float*>(vdb),
        static_cast<const uint8_t*>(pair_valid), static_cast<int32_t*>(votes),
        H, P, thr2);
  }
  return static_cast<int>(cudaGetLastError());
}
