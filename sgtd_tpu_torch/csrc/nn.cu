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
// round-to-nearest intrinsic so nvcc cannot re-associate or contract it.
//   nn1: idx[p, n] = the lowest index attaining min_t d(q[p, n], r[p, t]),
//        sqd[p, n] = that minimum.
//   knn: idx[p, n, :k] = the k smallest d in ascending order, ties to the
//        lower index (a stable ascending sort truncated to k), k <= 32.
// Masked points arrive displaced to a far coordinate by the caller; the
// kernels do not special-case them.
//
// Bound on this card: arithmetic, not bytes. At the rerank's shapes nn1
// evaluates 64 x 1,024 x 4,096 = 268M distances (about 7 flops each) from
// 1 MB of points; the map covariances' knn evaluates 200 x 4,096^2 = 3.4G.
// Design (simple first): one thread per query point, one block per
// (problem, 128-query tile); the problem's reference points stream through
// shared memory in tiles of 1,024 (x, y, z, |r|^2) float4s (16 KB), each
// computing its |r|^2 once; every thread of a warp reads the same float4
// (a broadcast, no bank conflicts). Scanning the references in ascending
// index with a strict < keeps the lowest index on ties: nn1 keeps a
// running minimum; knn keeps a sorted list of its k best (d, idx) in
// registers (fully unrolled over 32 slots) and inserts behind equal
// distances.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;
constexpr int kMaxK = 32;

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
}

__device__ __forceinline__ float sq_dist(const float4 q, const float4 r) {
  const float cross = __fmaf_rn(q.z, r.z, __fmaf_rn(q.y, r.y, __fmul_rn(q.x, r.x)));
  return __fsub_rn(__fadd_rn(q.w, r.w), __fmul_rn(2.0f, cross));
}

// Query point n of the problem with |q|^2 in .w (zeros past the end).
__device__ __forceinline__ float4 load_query(const float* __restrict__ query,
                                             int64_t row, bool live) {
  float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live) {
    q.x = query[3 * row];
    q.y = query[3 * row + 1];
    q.z = query[3 * row + 2];
    q.w = sq_norm(q.x, q.y, q.z);
  }
  return q;
}

// Reference points [base, base + n) of one problem into shared memory.
__device__ __forceinline__ void load_tile(const float* __restrict__ ref,
                                          int base, int n, float4* tile) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float* p = ref + 3 * static_cast<int64_t>(base + i);
    const float x = p[0], y = p[1], z = p[2];
    tile[i] = make_float4(x, y, z, sq_norm(x, y, z));
  }
}

__global__ void nn1_kernel(const float* __restrict__ query,
                           const float* __restrict__ ref,
                           int32_t* __restrict__ out_idx,
                           float* __restrict__ out_sqd, int N, int T) {
  __shared__ float4 tile[kTile];
  const int64_t prob = blockIdx.y;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t row = prob * N + n;
  const float4 q = load_query(query, row, n < N);
  const float* r = ref + prob * 3 * static_cast<int64_t>(T);

  float best = __int_as_float(0x7f800000);  // +inf
  int best_i = 0;
  for (int base = 0; base < T; base += kTile) {
    const int len = min(kTile, T - base);
    __syncthreads();
    load_tile(r, base, len, tile);
    __syncthreads();
    for (int j = 0; j < len; ++j) {
      const float d = sq_dist(q, tile[j]);
      if (d < best) {
        best = d;
        best_i = base + j;
      }
    }
  }
  if (n < N) {
    out_idx[row] = best_i;
    out_sqd[row] = best;
  }
}

__global__ void knn_kernel(const float* __restrict__ query,
                           const float* __restrict__ ref,
                           int32_t* __restrict__ out_idx, int N, int T,
                           int k) {
  __shared__ float4 tile[kTile];
  const int64_t prob = blockIdx.y;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t row = prob * N + n;
  const float4 q = load_query(query, row, n < N);
  const float* r = ref + prob * 3 * static_cast<int64_t>(T);

  const float inf = __int_as_float(0x7f800000);
  float bd[kMaxK];
  int bi[kMaxK];
#pragma unroll
  for (int s = 0; s < kMaxK; ++s) {
    bd[s] = inf;
    bi[s] = 0;
  }
  float worst = inf;  // bd[k - 1]
  for (int base = 0; base < T; base += kTile) {
    const int len = min(kTile, T - base);
    __syncthreads();
    load_tile(r, base, len, tile);
    __syncthreads();
    for (int j = 0; j < len; ++j) {
      const float d = sq_dist(q, tile[j]);
      if (d < worst) {
        // Carry (d, idx) down the sorted list: it settles behind every
        // equal distance (strict <), and each later entry moves one slot.
        float cd = d;
        int ci = base + j;
        bool placed = false;
#pragma unroll
        for (int s = 0; s < kMaxK; ++s) {
          if (s < k && (placed || cd < bd[s])) {
            const float td = bd[s];
            const int ti = bi[s];
            bd[s] = cd;
            bi[s] = ci;
            cd = td;
            ci = ti;
            placed = true;
          }
          if (s == k - 1) worst = bd[s];
        }
      }
    }
  }
  if (n < N) {
    int32_t* out = out_idx + row * k;
#pragma unroll
    for (int s = 0; s < kMaxK; ++s)
      if (s < k) out[s] = bi[s];
  }
}

dim3 grid_of(int P, int N) { return dim3((N + kThreads - 1) / kThreads, P); }

}  // namespace

// query (P, N, 3), ref (P, T, 3) float32 -> idx (P, N) int32, sqd (P, N)
// float32. P <= 65535, T >= 1.
extern "C" int sgtd_nn1(const void* query, const void* ref, void* idx,
                        void* sqd, int P, int N, int T, void* stream) {
  if (P > 0 && N > 0) {
    nn1_kernel<<<grid_of(P, N), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(query), static_cast<const float*>(ref),
        static_cast<int32_t*>(idx), static_cast<float*>(sqd), N, T);
  }
  return static_cast<int>(cudaGetLastError());
}

// query (P, N, 3), ref (P, T, 3) float32 -> idx (P, N, k) int32.
// P <= 65535, 1 <= k <= 32, T >= k.
extern "C" int sgtd_knn(const void* query, const void* ref, void* idx, int P,
                        int N, int T, int k, void* stream) {
  if (P > 0 && N > 0) {
    knn_kernel<<<grid_of(P, N), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(query), static_cast<const float*>(ref),
        static_cast<int32_t*>(idx), N, T, k);
  }
  return static_cast<int>(cudaGetLastError());
}
