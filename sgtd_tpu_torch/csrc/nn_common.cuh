// Device functions shared by the nearest-neighbour kernels (nn.cu: B4 nn1,
// B5 knn) and the fused GICP linearization (gicp.cu: B7), so that all of
// them rank reference points by bit-identical distances.
//
//   d(q, r) = (|q|^2 + |r|^2) - 2 q.r,  with
//   |p|^2 = fma(p2, p2, fma(p1, p1, p0*p0)),
//   q.r   = fma(q2, r2, fma(q1, r1, q0*r0)),
//
// every operation a round-to-nearest intrinsic, so nvcc cannot
// re-associate or contract it.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace sgtd {

constexpr int kThreads = 128;  // query points (threads) per block
constexpr int kTile = 1024;    // reference points per shared-memory tile

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
}

__device__ __forceinline__ float sq_dist(const float4 q, const float4 r) {
  const float cross = __fmaf_rn(q.z, r.z, __fmaf_rn(q.y, r.y, __fmul_rn(q.x, r.x)));
  return __fsub_rn(__fadd_rn(q.w, r.w), __fmul_rn(2.0f, cross));
}

// Reference points [base, base + n) of one problem into shared memory as
// (x, y, z, |r|^2).
__device__ __forceinline__ void load_tile(const float* __restrict__ ref,
                                          int base, int n, float4* tile) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float* p = ref + 3 * static_cast<int64_t>(base + i);
    const float x = p[0], y = p[1], z = p[2];
    tile[i] = make_float4(x, y, z, sq_norm(x, y, z));
  }
}

// The nearest of the problem's T reference points to q (q.w = |q|^2): a
// running minimum over ascending indices with a strict <, so the lowest
// index wins ties. Every thread of the block must call it (the tile loads
// synchronize the block).
__device__ __forceinline__ void nearest(const float4 q,
                                        const float* __restrict__ ref, int T,
                                        float4* tile, float* best_d,
                                        int* best_i) {
  float best = __int_as_float(0x7f800000);  // +inf
  int arg = 0;
  for (int base = 0; base < T; base += kTile) {
    const int len = min(kTile, T - base);
    __syncthreads();
    load_tile(ref, base, len, tile);
    __syncthreads();
    for (int j = 0; j < len; ++j) {
      const float d = sq_dist(q, tile[j]);
      if (d < best) {
        best = d;
        arg = base + j;
      }
    }
  }
  *best_d = best;
  *best_i = arg;
}

}  // namespace sgtd
