// K1 triangle_hypotheses and K2 verify_epilogue: the Kabsch solves of
// geometric verification (match/verify.py verify_pairs).
//
// Replaces no TPU kernel. The JAX package solves these in plain jnp
// (sgtd_tpu/ops/linalg3.py kabsch, sgtd_tpu/match/verify.py), which XLA
// fuses into a few loops. In eager PyTorch the same QCP solve is some 370
// small launches a call, twice a call, and its 4x4 minors were indexed
// with Python lists (a copy to the card and a wait each): that was most of
// a descriptor-only request on this card. Here each of the two solves is
// one launch, and the host never waits on it.
//
//   K1: for every (candidate n, hypothesis h), the sampled pair
//       h_idx = min(h * (n_pairs // H + 1), P - 1) (the reference's
//       skip_len sampling, STDesc.cpp:467-482) and the rigid transform of
//       its query triangle onto its DB triangle: rot_h (N, H, 3, 3),
//       t_h (N, H, 3), every slot (the caller masks h >= use_size).
//   K2: for every candidate, from B3's votes over K1's hypotheses: the
//       best valid hypothesis (lowest index on ties), its inlier mask
//       (sqrt((d0^2 + d1^2) + d2^2) < thr on all three vertices of a valid
//       pair), acceptance and score, and the weighted Kabsch over the
//       inlier vertices, with the sampled pose below 2 inlier pairs.
//
// Bound on this card: neither kernel is near a rate of the card. K1 reads
// 72 bytes and writes 48 a hypothesis and does some 900 float32
// operations: 40,000 hypotheses (16 queries x 50 candidates x 50) are 4.8
// MB and 36 MFLOP, 1.5 us of memory. K2 reads a candidate's valid pairs'
// vertices, twice where it polishes (72 bytes a pair) and writes its
// inlier mask. What bounds both is the latency of one thread's chain of
// dependent operations: the 12 Newton steps and the 16 cofactors of the
// 4x4 solve, some 600 dependent float operations in one thread. So each
// thread solves one whole problem in registers (no shared memory, no
// barrier inside a solve), all of a launch's problems run at once (K1: a
// block a candidate, a thread a hypothesis; K2: a block a candidate, the
// block's threads over its pairs, one thread for the final 3x3 -> 4x4
// solve), and nothing else is launched around them.
//
// Rounding. K1 computes what the plain version (linalg3.kabsch on the
// card) computes, operation by operation, each product, sum, quotient and
// root a round-to-nearest intrinsic so that nvcc contracts nothing:
// torch's elementwise kernels round each operation, its einsums (cuBLAS
// batched products) fuse multiply-adds, its small sums and norms take the
// order its reduction kernel gives them (the sum* and dot3* helpers), and
// its rsqrt is rsqrtf. So K1 gives the plain version's bits, where the
// solve hangs on them too (a triangle whose two largest QCP eigenvalues
// nearly meet); only the translation's last product may round otherwise
// at batch sizes where cuBLAS takes another order. K2's block sums take
// another order than torch's sums over 3P vertices, so its polish agrees
// within a tolerance.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kHypThreads = 64;         // K1: threads a block (a candidate's hypotheses)
constexpr int kMaxEpilogueThreads = 256;  // K2: most threads a block
constexpr int kMaxWarps = kMaxEpilogueThreads / 32;
constexpr int kPairsPerThread = 4;      // K2: a block takes P / 4 threads, 32 to 256
constexpr int kNewton = 12;             // Newton steps on the QCP quartic (linalg3.kabsch)
constexpr float kEps = 1e-12f;          // linalg3._EPS
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }

// The orders below are those torch 2.11 and cuBLAS 12.8 take on the card
// (each read from their outputs, bit for bit). torch's sum of values along
// a tensor's last (contiguous) axis gives them to a power of two of lanes,
// lane k the values k, k + lanes, ..., then halves the lanes: 3 values
// over 2 lanes, 4 over 4, 9 over 8 (lane 0 holding x0 and x8).
__device__ __forceinline__ float sum3_inner(float x0, float x1, float x2) { return add(add(x0, x2), x1); }
// ... and along an outer axis: one thread, in order.
__device__ __forceinline__ float sum3_outer(float x0, float x1, float x2) { return add(add(x0, x1), x2); }
__device__ __forceinline__ float sum4_inner(float x0, float x1, float x2, float x3) {
  return add(add(x0, x2), add(x1, x3));
}
__device__ __forceinline__ float sum9(const float (&x)[9]) {
  return add(add(add(add(x[0], x[8]), x[4]), add(x[2], x[6])), add(add(x[1], x[5]), add(x[3], x[7])));
}
// A 3-term product of cuBLAS's batched GEMM: fused multiply-adds in k order.
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1, float a2, float b2) {
  return fma_rn(a2, b2, fma_rn(a1, b1, mul(a0, b0)));
}
// ... and of its batched matrix-vector product: k 0 and 1 fused, k 2 added
// (at most batch sizes; at 20,000 it takes another order).
__device__ __forceinline__ float dot3_mv(float a0, float b0, float a1, float b1, float a2, float b2) {
  return add(fma_rn(a1, b1, mul(a0, b0)), mul(a2, b2));
}

// linalg3.det3x3: a * (e i - f h) - b * (d i - f g) + c * (d h - e g).
__device__ __forceinline__ float det3(float a, float b, float c, float d, float e, float f, float g,
                                      float h, float i) {
  const float A = sub(mul(e, i), mul(f, h));
  const float B = sub(mul(d, i), mul(f, g));
  const float C = sub(mul(d, h), mul(e, g));
  return add(sub(mul(a, A), mul(b, B)), mul(c, C));
}

// The determinant of the 3x3 minor of row-major m without row R and
// column C, rows and columns in ascending order (linalg3._minor).
template <int R, int C>
__device__ __forceinline__ float minor_det(const float (&m)[16]) {
  constexpr int r0 = R == 0 ? 1 : 0, r1 = R <= 1 ? 2 : 1, r2 = R <= 2 ? 3 : 2;
  constexpr int c0 = C == 0 ? 1 : 0, c1 = C <= 1 ? 2 : 1, c2 = C <= 2 ? 3 : 2;
  return det3(m[4 * r0 + c0], m[4 * r0 + c1], m[4 * r0 + c2], m[4 * r1 + c0], m[4 * r1 + c1],
              m[4 * r1 + c2], m[4 * r2 + c0], m[4 * r2 + c1], m[4 * r2 + c2]);
}

// Row R of the cofactor matrix of m (linalg3._adjugate4x4 holds it as
// column R of the adjugate), and its squared norm summed in row order.
template <int R>
__device__ __forceinline__ float cofactor_row(const float (&m)[16], float (&q)[4]) {
  constexpr float s = R % 2 == 0 ? 1.0f : -1.0f;
  q[0] = s * minor_det<R, 0>(m);
  q[1] = -s * minor_det<R, 1>(m);
  q[2] = s * minor_det<R, 2>(m);
  q[3] = -s * minor_det<R, 3>(m);
  return add(add(add(mul(q[0], q[0]), mul(q[1], q[1])), mul(q[2], q[2])), mul(q[3], q[3]));
}

// The rotation that linalg3.kabsch takes from H (row-major 3x3), the
// weighted cross-covariance of the centred points scaled so that E0 = 1:
// the largest root of the QCP quartic by Newton from 1, the quaternion
// from the largest column of adj(K - lambda I), the rotation of the
// quaternion (Theobald's QCP, always det R = +1).
__device__ void qcp_rotation(const float (&H)[9], float (&R)[9]) {
  const float sxx = H[0], sxy = H[1], sxz = H[2];
  const float syx = H[3], syy = H[4], syz = H[5];
  const float szx = H[6], szy = H[7], szz = H[8];
  float K[16];
  K[0] = add(add(sxx, syy), szz);
  K[1] = sub(syz, szy);
  K[2] = sub(szx, sxz);
  K[3] = sub(sxy, syx);
  K[4] = K[1];
  K[5] = sub(sub(sxx, syy), szz);
  K[6] = add(sxy, syx);
  K[7] = add(szx, sxz);
  K[8] = K[2];
  K[9] = K[6];
  K[10] = sub(add(-sxx, syy), szz);
  K[11] = add(syz, szy);
  K[12] = K[3];
  K[13] = K[7];
  K[14] = K[11];
  K[15] = add(sub(-sxx, syy), szz);

  // P(l) = l^4 + c2 l^2 + c1 l + c0 (trace K = 0).
  float hh[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) hh[k] = mul(H[k], H[k]);
  const float c2 = -2.0f * sum9(hh);
  const float c1 = -8.0f * det3(sxx, sxy, sxz, syx, syy, syz, szx, szy, szz);
  // linalg3._det4x4: cofactor expansion on the first row, summed in order.
  float c0 = mul(K[0], minor_det<0, 0>(K));
  c0 = add(c0, mul(-K[1], minor_det<0, 1>(K)));
  c0 = add(c0, mul(K[2], minor_det<0, 2>(K)));
  c0 = add(c0, mul(-K[3], minor_det<0, 3>(K)));

  float lam = 1.0f;
#pragma unroll
  for (int it = 0; it < kNewton; ++it) {
    const float p = add(mul(add(mul(add(mul(lam, lam), c2), lam), c1), lam), c0);
    const float dp = add(mul(add(mul(4.0f * lam, lam), 2.0f * c2), lam), c1);
    lam = sub(lam, __fdiv_rn(p, fabsf(dp) > kEps ? dp : kEps));
  }

  float A[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) A[k] = K[k];
  A[0] = sub(K[0], lam);
  A[5] = sub(K[5], lam);
  A[10] = sub(K[10], lam);
  A[15] = sub(K[15], lam);
  // The column of adj(A) of largest norm, the first on ties (argmax).
  float q[4], c[4];
  float best = cofactor_row<0>(A, q);
  float norm = cofactor_row<1>(A, c);
  if (norm > best) {
    best = norm;
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = c[k];
  }
  norm = cofactor_row<2>(A, c);
  if (norm > best) {
    best = norm;
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = c[k];
  }
  norm = cofactor_row<3>(A, c);
  if (norm > best) {
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = c[k];
  }
  const float qn = __fsqrt_rn(sum4_inner(mul(q[0], q[0]), mul(q[1], q[1]), mul(q[2], q[2]), mul(q[3], q[3])));
  float w0 = 1.0f, x = 0.0f, y = 0.0f, z = 0.0f;
  if (qn > kEps) {
    const float den = add(qn, kEps);
    w0 = __fdiv_rn(q[0], den);
    x = __fdiv_rn(q[1], den);
    y = __fdiv_rn(q[2], den);
    z = __fdiv_rn(q[3], den);
  }
  R[0] = sub(1.0f, 2.0f * add(mul(y, y), mul(z, z)));
  R[1] = 2.0f * sub(mul(x, y), mul(w0, z));
  R[2] = 2.0f * add(mul(x, z), mul(w0, y));
  R[3] = 2.0f * add(mul(x, y), mul(w0, z));
  R[4] = sub(1.0f, 2.0f * add(mul(x, x), mul(z, z)));
  R[5] = 2.0f * sub(mul(y, z), mul(w0, x));
  R[6] = 2.0f * sub(mul(x, z), mul(w0, y));
  R[7] = 2.0f * add(mul(y, z), mul(w0, x));
  R[8] = sub(1.0f, 2.0f * add(mul(x, x), mul(y, y)));
}

// t = mu_r - R mu_s (linalg3.kabsch's last line, an einsum).
__device__ __forceinline__ void translation(const float (&R)[9], const float (&mu_s)[3], const float (&mu_r)[3],
                                            float (&t)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    t[i] = sub(mu_r[i], dot3_mv(R[3 * i], mu_s[0], R[3 * i + 1], mu_s[1], R[3 * i + 2], mu_s[2]));
}

// linalg3.kabsch of one unweighted triangle: src and ref rows A, B, C.
__device__ void kabsch3(const float (&src)[9], const float (&ref)[9], float (&R)[9], float (&t)[3]) {
  const float wn = __fdiv_rn(1.0f, 3.0f);  // w / sum(w), w = 1
  float mu_s[3], mu_r[3], s[9], r[9];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    mu_s[c] = sum3_outer(mul(src[c], wn), mul(src[3 + c], wn), mul(src[6 + c], wn));
    mu_r[c] = sum3_outer(mul(ref[c], wn), mul(ref[3 + c], wn), mul(ref[6 + c], wn));
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    s[k] = sub(src[k], mu_s[k % 3]);
    r[k] = sub(ref[k], mu_r[k % 3]);
  }
  float ys[3], yr[3];
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    ys[v] = mul(wn, sum3_inner(mul(s[3 * v], s[3 * v]), mul(s[3 * v + 1], s[3 * v + 1]), mul(s[3 * v + 2], s[3 * v + 2])));
    yr[v] = mul(wn, sum3_inner(mul(r[3 * v], r[3 * v]), mul(r[3 * v + 1], r[3 * v + 1]), mul(r[3 * v + 2], r[3 * v + 2])));
  }
  const float sigma2 = 0.5f * add(sum3_inner(ys[0], ys[1], ys[2]), sum3_inner(yr[0], yr[1], yr[2]));
  const float inv = rsqrtf(add(sigma2, kEps));
  float sw[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    sw[k] = mul(mul(s[k], inv), wn);
    r[k] = mul(r[k], inv);
  }
  float H[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) H[3 * i + j] = dot3(sw[i], r[j], sw[3 + i], r[3 + j], sw[6 + i], r[6 + j]);
  qcp_rotation(H, R);
  translation(R, mu_s, mu_r, t);
}

// The sum over the block of an int that every thread holds; every thread
// gets it. scratch holds a value a warp.
__device__ __forceinline__ int block_sum(int v, int* scratch) {
  v = __reduce_add_sync(kFull, v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) total += scratch[w];
  __syncthreads();
  return total;
}

// The number of valid pairs of a candidate (a count of its flags, as
// pair_valid.sum(-1)).
__device__ __forceinline__ int count_valid(const uint8_t* __restrict__ pv, int P, int* scratch) {
  int cnt = 0;
  for (int p = threadIdx.x; p < P; p += blockDim.x) cnt += pv[p] != 0;
  return block_sum(cnt, scratch);
}

__global__ void __launch_bounds__(kHypThreads)
triangle_hypotheses_kernel(const float* __restrict__ vq, const float* __restrict__ vdb,
                           const uint8_t* __restrict__ pair_valid, float* __restrict__ rot_h,
                           float* __restrict__ t_h, int H, int P) {
  __shared__ int scratch[kHypThreads / 32];
  const int64_t n = blockIdx.x;
  const int n_pairs = count_valid(pair_valid + n * P, P, scratch);
  const int skip = n_pairs / H + 1;
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    const int hi = min(h * skip, P - 1);
    const float* sq = vq + (n * P + hi) * 9;
    const float* sd = vdb + (n * P + hi) * 9;
    float src[9], ref[9], R[9], t[3];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      src[k] = __ldg(sq + k);
      ref[k] = __ldg(sd + k);
    }
    kabsch3(src, ref, R, t);
    float* outr = rot_h + (n * H + h) * 9;
    float* outt = t_h + (n * H + h) * 3;
#pragma unroll
    for (int k = 0; k < 9; ++k) outr[k] = R[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) outt[k] = t[k];
  }
}

// Sums of the first kF of a thread's 11 floats over the block, in a fixed
// order: a tree over each warp's lanes, then the warps in order. Thread 0
// gets them.
template <int kF>
__device__ __forceinline__ void block_sums(float (&v)[11], float (*scratch)[11]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kF; ++k)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_down_sync(kFull, v[k], off);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < kF; ++k) scratch[warp][k] = v[k];
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w)
#pragma unroll
      for (int k = 0; k < kF; ++k) v[k] += scratch[w][k];
  __syncthreads();
}

__global__ void __launch_bounds__(kMaxEpilogueThreads)
verify_epilogue_kernel(const int32_t* __restrict__ votes, const float* __restrict__ rot_h,
                       const float* __restrict__ t_h, const float* __restrict__ vq,
                       const float* __restrict__ vdb, const uint8_t* __restrict__ pair_valid,
                       const uint8_t* __restrict__ cand_valid, float* __restrict__ score,
                       float* __restrict__ rot, float* __restrict__ trans, uint8_t* __restrict__ inliers,
                       uint8_t* __restrict__ polished, int H, int P, float thr, int min_votes) {
  __shared__ int scratch[kMaxWarps];
  __shared__ int best_v[kMaxWarps], best_i[kMaxWarps];
  __shared__ float sums[kMaxWarps][11];
  __shared__ int pick;
  const int64_t n = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint8_t* pv = pair_valid + n * P;

  // The hypotheses the sampling made valid: h < n_pairs // skip.
  const int n_pairs = count_valid(pv, P, scratch);
  const int use_size = n_pairs / (n_pairs / H + 1);

  // The largest vote, masked to -1 beyond use_size, and its lowest index.
  int bv = INT_MIN, bi = H;
  for (int h = tid; h < H; h += blockDim.x) {
    const int v = h < use_size ? votes[n * H + h] : -1;
    if (v > bv) {
      bv = v;
      bi = h;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_down_sync(kFull, bv, off), oi = __shfl_down_sync(kFull, bi, off);
    if (ov > bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    best_v[warp] = bv;
    best_i[warp] = bi;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w)
      if (best_v[w] > bv || (best_v[w] == bv && best_i[w] < bi)) {
        bv = best_v[w];
        bi = best_i[w];
      }
    best_v[0] = bv;
    pick = bi;
  }
  __syncthreads();
  const int max_vote = best_v[0], hb = pick;
  const bool accepted = max_vote >= min_votes && cand_valid[n] != 0;
  float Rb[9], tb[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) Rb[k] = __ldg(rot_h + (n * H + hb) * 9 + k);
#pragma unroll
  for (int k = 0; k < 3; ++k) tb[k] = __ldg(t_h + (n * H + hb) * 3 + k);

  // Pass 1: the best hypothesis' inliers, counted, and their vertices'
  // coordinate sums.
  uint8_t* inl_out = inliers + n * P;
  int n_inl = 0;
  float acc[11];
#pragma unroll
  for (int k = 0; k < 11; ++k) acc[k] = 0.0f;
  for (int p = tid; p < P; p += blockDim.x) {
    bool inl = false;
    if (pv[p]) {
      const float* sq = vq + (n * P + p) * 9;
      const float* sd = vdb + (n * P + p) * 9;
      float q[9], d[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        q[k] = __ldg(sq + k);
        d[k] = __ldg(sd + k);
      }
      inl = true;
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        float s[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float m = add(dot3(Rb[3 * i], q[3 * v], Rb[3 * i + 1], q[3 * v + 1], Rb[3 * i + 2], q[3 * v + 2]), tb[i]);
          const float e = sub(m, d[3 * v + i]);
          s[i] = mul(e, e);
        }
        inl = inl && __fsqrt_rn(add(add(s[0], s[1]), s[2])) < thr;
      }
      if (inl) {
        ++n_inl;
#pragma unroll
        for (int v = 0; v < 3; ++v)
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            acc[c] += q[3 * v + c];
            acc[3 + c] += d[3 * v + c];
          }
      }
    }
    inl_out[p] = inl && accepted;
  }
  n_inl = block_sum(n_inl, scratch);
  const bool use_ref = accepted && n_inl >= 2;
  if (tid == 0) {
    score[n] = accepted ? static_cast<float>(n_inl) : -1.0f;
    polished[n] = use_ref;
  }
  if (!use_ref) {  // the sampled pose (the same branch for the whole block)
    if (tid == 0) {
#pragma unroll
      for (int k = 0; k < 9; ++k) rot[n * 9 + k] = Rb[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) trans[n * 3 + k] = tb[k];
    }
    return;
  }
  block_sums<6>(acc, sums);
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) sums[0][k] = acc[k];
  }
  __syncthreads();
  // The weights are 1 on the inlier vertices: wn = 1 / (3 n_inl).
  const float wn = __fdiv_rn(1.0f, static_cast<float>(3 * n_inl));
  float mu_s[3], mu_r[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    mu_s[c] = sums[0][c] * wn;
    mu_r[c] = sums[0][3 + c] * wn;
  }
  __syncthreads();

  // Pass 2: centred sums of squares and cross products over the inliers.
#pragma unroll
  for (int k = 0; k < 11; ++k) acc[k] = 0.0f;
  for (int p = tid; p < P; p += blockDim.x) {
    if (!inl_out[p]) continue;  // this thread's own writes of pass 1
    const float* sq = vq + (n * P + p) * 9;
    const float* sd = vdb + (n * P + p) * 9;
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      float s[3], r[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        s[c] = __ldg(sq + 3 * v + c) - mu_s[c];
        r[c] = __ldg(sd + 3 * v + c) - mu_r[c];
        acc[9] += s[c] * s[c];
        acc[10] += r[c] * r[c];
      }
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) acc[3 * i + j] += s[i] * r[j];
    }
  }
  block_sums<11>(acc, sums);
  if (tid == 0) {
    const float sigma2 = 0.5f * (wn * acc[9] + wn * acc[10]);
    const float inv = rsqrtf(sigma2 + kEps);
    const float scale = wn * inv * inv;
    float Hm[9], R[9], t[3];
#pragma unroll
    for (int k = 0; k < 9; ++k) Hm[k] = acc[k] * scale;
    qcp_rotation(Hm, R);
    translation(R, mu_s, mu_r, t);
#pragma unroll
    for (int k = 0; k < 9; ++k) rot[n * 9 + k] = R[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) trans[n * 3 + k] = t[k];
  }
}

// K2's threads a block: P / kPairsPerThread, rounded up to whole warps,
// 32 to kMaxEpilogueThreads.
inline int epilogue_threads(int P) {
  int t = ((P + kPairsPerThread - 1) / kPairsPerThread + 31) / 32 * 32;
  return t < 32 ? 32 : (t > kMaxEpilogueThreads ? kMaxEpilogueThreads : t);
}

}  // namespace

// vq, vdb (N, P, 3, 3) float32; pair_valid (N, P) bool; rot_h (N, H, 3, 3),
// t_h (N, H, 3) float32.
extern "C" int sgtd_triangle_hypotheses(const void* vq, const void* vdb, const void* pair_valid,
                                        void* rot_h, void* t_h, int N, int H, int P, void* stream) {
  if (N > 0 && H > 0 && P > 0) {
    triangle_hypotheses_kernel<<<N, kHypThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(vq), static_cast<const float*>(vdb),
        static_cast<const uint8_t*>(pair_valid), static_cast<float*>(rot_h), static_cast<float*>(t_h), H, P);
  }
  return static_cast<int>(cudaGetLastError());
}

// votes (N, H) int32 (B3's); rot_h (N, H, 3, 3), t_h (N, H, 3), vq, vdb
// (N, P, 3, 3) float32; pair_valid (N, P), cand_valid (N,) bool; score (N,),
// rot (N, 3, 3), trans (N, 3) float32; inliers (N, P), polished (N,) bool.
extern "C" int sgtd_verify_epilogue(const void* votes, const void* rot_h, const void* t_h, const void* vq,
                                    const void* vdb, const void* pair_valid, const void* cand_valid,
                                    void* score, void* rot, void* trans, void* inliers, void* polished,
                                    int N, int H, int P, float thr, int min_votes, void* stream) {
  if (N > 0 && H > 0 && P > 0) {
    verify_epilogue_kernel<<<N, epilogue_threads(P), 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(votes), static_cast<const float*>(rot_h), static_cast<const float*>(t_h),
        static_cast<const float*>(vq), static_cast<const float*>(vdb), static_cast<const uint8_t*>(pair_valid),
        static_cast<const uint8_t*>(cand_valid), static_cast<float*>(score), static_cast<float*>(rot),
        static_cast<float*>(trans), static_cast<uint8_t*>(inliers), static_cast<uint8_t*>(polished), H, P, thr,
        min_votes);
  }
  return static_cast<int>(cudaGetLastError());
}
