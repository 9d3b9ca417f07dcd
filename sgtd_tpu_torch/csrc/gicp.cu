// B7 linearize_gicp: one fused GICP linearization for a batch of problems.
//
// Replaces the TPU kernel sgtd_tpu/ops/pallas_gicp.py::linearize_gicp (per
// source tile in VMEM: MXU distances to every target, first-argmin, the
// target payload gathered by a one-hot f32 MXU matmul because the TPU has
// no vector gather, the per-point algebra on 64-lane planes, and a
// sequential-grid accumulator). None of those workarounds is needed here:
// a thread gathers its target's payload by index, keeps the algebra in
// registers, and blocks reduce in parallel.
//
// Per problem p, at the transform T[p] (rows R | t):
//   moved_s = R src_s + t                       (FMA chains, see below)
//   j(s)    = argmin_t d(moved_s, tgt_eff_t)    (nn_common.cuh: B4's own
//             distance, strict <, lowest index on ties)
//   sqd_s   = max(d_min, 0)
//   w_s     = src_mask_s * mask_j * [sqd_s < gate2]
//   M_s     = (C_B[j] + R C_A[s] R^T)^-1        (adjugate / determinant)
//   r_s     = b_j - moved_s,  J_s = [-I | skew(moved_s)]
//   H = sum_s w_s J_s^T M_s J_s (21 upper-triangular entries),
//   g = sum_s w_s J_s^T M_s r_s (6), y0 = sum_s w_s r_s^T M_s r_s,
//   n_valid = sum_s w_s, sum_sqd = sum_s w_s sqd_s,
//   aux[s] = [b_j (3) | M_s row-major (9) | w_s | 0 x 3];
//   sums[p] = [H row-major, symmetric (36) | g (6) | y0 | n_valid |
//              sum_sqd | 0 x 3]: the caller takes H, g, y0, b, M and w as
//   views, with no further launch.
//
// Bound on this card: the rate at which the SMs start float32
// instructions, not bytes. At the rerank's shapes (64 problems, 1,024
// source and 4,096 target points) the scan evaluates 268M distances; the epilogue is a few hundred flops
// per source point, and all inputs and outputs together are under 25 MB.
// Design: the correspondence search is B4's own scan (nn_common.cuh,
// nearest: several moved points a thread, a deferred argmin over groups of
// 16 targets, the targets split over the warps of a block, laid over the
// card by scan_plan at any batch size), with the moved point in the
// query's place. After it thread t of the block's first Q warps holds the
// answer of source point t of the block's 32 Q, gathers that target's
// payload by index and keeps the algebra in registers: one source point a
// thread, as before. The 30 sums are reduced in a fixed order: a shuffle
// tree over each of those warps (32 consecutive source points), the warps
// added in ascending order into the block's partial row, and a second
// small kernel adds a problem's partial rows in ascending block order. No
// float atomics: the LM solver accepts or rejects a step on y_k < y0, so
// sums that changed from run to run would flip near-ties; here the same
// inputs give the same bits. (The order depends on Q, which depends only
// on the shapes; with 4 points a thread a block sums 128 source points,
// as the first design did.) Folding the second kernel into the first (the
// last block of a problem adds the rows) needs a zeroed counter a problem,
// which is a launch of its own: two launches stay.
//
// Masked points still run the arithmetic. Their covariances are the
// identity (refine.gicp.point_covariances), so C_B + R C_A R^T stays
// positive definite and M finite; and a point with w = 0 adds a literal 0
// to every sum (a select, not a product), so even a non-finite M at such
// a point could not reach H, g or y0. M goes to aux as computed.

#include <cuda_runtime.h>
#include <cstdint>

#include "nn_common.cuh"

namespace {

using namespace sgtd;  // kTile, kMaxThreads, sq_norm, nearest, scan_plan

constexpr int kSums = 30;      // H 21, g 6, y0, n_valid, sum_sqd
constexpr int kRow = 32;       // floats per partial row
constexpr int kOut = 48;       // floats per output row (H unpacked to 36)
constexpr int kPayload = 12;   // floats per target: see sgtd_linearize_gicp
constexpr int kAux = 16;       // floats per source point of aux

template <int Q>
__global__ void __launch_bounds__(kMaxThreads)
    linearize_kernel(const float* __restrict__ Tm,        // (P, 4, 4)
                     const float* __restrict__ src,       // (P, S, 3)
                     const float* __restrict__ src_cov6,  // (P, S, 6)
                     const uint8_t* __restrict__ src_mask,  // (P, S)
                     const float* __restrict__ tgt_eff,   // (P, T, 3)
                     const float4* __restrict__ payload,  // (P, T, 3) float4
                     float* __restrict__ partial,         // (P, tiles, 32)
                     float4* __restrict__ aux,            // (P, S, 4) float4
                     int S, int T, float gate2, int tiles) {
  __shared__ float4 tile[kTile];
  __shared__ float warp_sums[Q][kRow];
  const int64_t prob = blockIdx.x / tiles;
  const int blk = blockIdx.x - prob * tiles;
  const int n0 = blk * (32 * Q);

  const float* Tp = Tm + prob * 16;
  const float R00 = Tp[0], R01 = Tp[1], R02 = Tp[2], t0 = Tp[3];
  const float R10 = Tp[4], R11 = Tp[5], R12 = Tp[6], t1 = Tp[7];
  const float R20 = Tp[8], R21 = Tp[9], R22 = Tp[10], t2 = Tp[11];

  // moved = R s + t with a fixed rounding order (the plain version takes
  // the same one), so both pick the same correspondences. A slot past the
  // problem's last source point takes its first.
  const auto moved = [&](int slot) {
    const int64_t r = prob * S + (n0 + slot < S ? n0 + slot : 0);
    const float sx = src[3 * r], sy = src[3 * r + 1], sz = src[3 * r + 2];
    const float mx = __fadd_rn(__fmaf_rn(R02, sz, __fmaf_rn(R01, sy, __fmul_rn(R00, sx))), t0);
    const float my = __fadd_rn(__fmaf_rn(R12, sz, __fmaf_rn(R11, sy, __fmul_rn(R10, sx))), t1);
    const float mz = __fadd_rn(__fmaf_rn(R22, sz, __fmaf_rn(R21, sy, __fmul_rn(R20, sx))), t2);
    return make_float4(mx, my, mz, sq_norm(mx, my, mz));
  };

  float4 q;
  float dmin;
  int j;
  nearest<Q>(moved, tgt_eff + prob * 3 * static_cast<int64_t>(T), T, tile, &q, &dmin, &j);

  // The first Q warps: thread t takes source point n0 + t.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp < Q) {
    const int n = n0 + threadIdx.x;
    const bool live = n < S;
    const int64_t row = prob * S + (live ? n : 0);
    const float mx = q.x, my = q.y, mz = q.z;
    const float sqd = fmaxf(dmin, 0.0f);

    // The winner's payload: [b (3), mask | cxx cxy cxz cyy | cyz czz 0 0].
    const float4* pj = payload + (prob * T + j) * 3;
    const float4 p0 = pj[0], p1 = pj[1], p2 = pj[2];
    const bool valid = live && src_mask[row] != 0 && p0.w != 0.0f && sqd < gate2;

    // R C_A R^T + C_B, symmetric (6 entries).
    const float* ca = src_cov6 + 6 * row;
    const float axx = ca[0], axy = ca[1], axz = ca[2];
    const float ayy = ca[3], ayz = ca[4], azz = ca[5];
    // v_i = C_A R_i^T for rotation row i.
    const float v0x = axx * R00 + axy * R01 + axz * R02;
    const float v0y = axy * R00 + ayy * R01 + ayz * R02;
    const float v0z = axz * R00 + ayz * R01 + azz * R02;
    const float v1x = axx * R10 + axy * R11 + axz * R12;
    const float v1y = axy * R10 + ayy * R11 + ayz * R12;
    const float v1z = axz * R10 + ayz * R11 + azz * R12;
    const float v2x = axx * R20 + axy * R21 + axz * R22;
    const float v2y = axy * R20 + ayy * R21 + ayz * R22;
    const float v2z = axz * R20 + ayz * R21 + azz * R22;
    const float sxx = R00 * v0x + R01 * v0y + R02 * v0z + p1.x;
    const float sxy = R00 * v1x + R01 * v1y + R02 * v1z + p1.y;
    const float sxz = R00 * v2x + R01 * v2y + R02 * v2z + p1.z;
    const float syy = R10 * v1x + R11 * v1y + R12 * v1z + p1.w;
    const float syz = R10 * v2x + R11 * v2y + R12 * v2z + p2.x;
    const float szz = R20 * v2x + R21 * v2y + R22 * v2z + p2.y;

    // M = adjugate / determinant of the symmetric 3x3.
    const float cxx = syy * szz - syz * syz;
    const float cxy = sxz * syz - sxy * szz;
    const float cxz = sxy * syz - sxz * syy;
    const float cyy = sxx * szz - sxz * sxz;
    const float cyz = sxy * sxz - sxx * syz;
    const float czz = sxx * syy - sxy * sxy;
    const float inv = 1.0f / (sxx * cxx + sxy * cxy + sxz * cxz);
    const float Mxx = cxx * inv, Mxy = cxy * inv, Mxz = cxz * inv;
    const float Myy = cyy * inv, Myz = cyz * inv, Mzz = czz * inv;

    const float rx = p0.x - mx, ry = p0.y - my, rz = p0.z - mz;
    const float Mr[3] = {Mxx * rx + Mxy * ry + Mxz * rz,
                         Mxy * rx + Myy * ry + Myz * rz,
                         Mxz * rx + Myz * ry + Mzz * rz};

    // Columns of J = [-I | skew(moved)] and their images under M.
    const float c6[6][3] = {{-1.f, 0.f, 0.f}, {0.f, -1.f, 0.f}, {0.f, 0.f, -1.f},
                            {0.f, mz, -my},   {-mz, 0.f, mx},   {my, -mx, 0.f}};
    float mc[6][3] = {{-Mxx, -Mxy, -Mxz}, {-Mxy, -Myy, -Myz}, {-Mxz, -Myz, -Mzz},
                      {0.f, 0.f, 0.f},    {0.f, 0.f, 0.f},    {0.f, 0.f, 0.f}};
#pragma unroll
    for (int k = 3; k < 6; ++k) {
      mc[k][0] = Mxx * c6[k][0] + Mxy * c6[k][1] + Mxz * c6[k][2];
      mc[k][1] = Mxy * c6[k][0] + Myy * c6[k][1] + Myz * c6[k][2];
      mc[k][2] = Mxz * c6[k][0] + Myz * c6[k][1] + Mzz * c6[k][2];
    }

    float acc[kSums];
    int o = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int b = a; b < 6; ++b)
        acc[o++] = c6[a][0] * mc[b][0] + c6[a][1] * mc[b][1] + c6[a][2] * mc[b][2];
#pragma unroll
    for (int a = 0; a < 6; ++a)
      acc[21 + a] = c6[a][0] * Mr[0] + c6[a][1] * Mr[1] + c6[a][2] * Mr[2];
    acc[27] = rx * Mr[0] + ry * Mr[1] + rz * Mr[2];
    acc[28] = 1.0f;
    acc[29] = sqd;

    if (live) {
      float4* out = aux + (prob * S + n) * (kAux / 4);
      out[0] = make_float4(p0.x, p0.y, p0.z, Mxx);
      out[1] = make_float4(Mxy, Mxz, Mxy, Myy);
      out[2] = make_float4(Myz, Mxz, Myz, Mzz);
      out[3] = make_float4(valid ? 1.0f : 0.0f, 0.f, 0.f, 0.f);
    }

    // Block reduction in a fixed order: a shuffle tree per warp, then the
    // warps' rows added in ascending order.
#pragma unroll
    for (int k = 0; k < kSums; ++k) {
      float v = valid ? acc[k] : 0.0f;  // a select: w = 0 adds a literal 0
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) warp_sums[warp][k] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < kRow) {
    float v = 0.0f;
    if (threadIdx.x < kSums) {
#pragma unroll
      for (int wi = 0; wi < Q; ++wi) v += warp_sums[wi][threadIdx.x];
    }
    partial[(prob * tiles + blk) * kRow + threadIdx.x] = v;
  }
}

// sums[p] from the problem's partial rows, added in ascending block order
// and laid out as the caller reads them: thread k < 36 writes H[k / 6][k % 6]
// from the upper-triangular sum of (min, max), then g, y0, n_valid and
// sum_sqd follow.
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ sums, int nblk) {
  const int64_t prob = blockIdx.x;
  const int k = threadIdx.x;
  int from = -1;
  if (k < 36) {
    const int a = min(k / 6, k % 6), b = max(k / 6, k % 6);
    from = 6 * a - a * (a - 1) / 2 + (b - a);
  } else if (k < 36 + kSums - 21) {
    from = k - 15;
  }
  float v = 0.0f;
  if (from >= 0) {
    const float* p = partial + prob * nblk * kRow + from;
    for (int b = 0; b < nblk; ++b) v += p[static_cast<int64_t>(b) * kRow];
  }
  sums[prob * kOut + k] = v;
}

}  // namespace

// T (P, 4, 4), src (P, S, 3), src_cov6 (P, S, 6) float32, src_mask (P, S)
// bool bytes, tgt_eff (P, Tn, 3), payload (P, Tn, 12) float32 =
// [x y z mask | cxx cxy cxz cyy | cyz czz 0 0] (16-byte aligned) ->
// sums (P, 48) = [H 36 | g 6 | y0 | n_valid | sum_sqd | 0 0 0], aux
// (P, S, 16) float32 (16-byte aligned); partial is scratch of at least
// (P, ceil(S / 32), 32) floats, of which the plan's (P, tiles, 32) are
// used. gate2 = +inf for no gate. Tn >= 1, P x ceil(S / 32) < 2^31.
extern "C" int sgtd_linearize_gicp(const void* T, const void* src,
                                   const void* src_cov6, const void* src_mask,
                                   const void* tgt_eff, const void* payload,
                                   void* partial, void* sums, void* aux, int P,
                                   int S, int Tn, float gate2, void* stream) {
  static_assert(kPayload == 12 && kAux == 16, "float4 layouts");
  if (P > 0 && S > 0) {
    const ScanPlan plan = scan_plan(P, S);
    const auto kernel = plan.queries == 1 ? linearize_kernel<1> : linearize_kernel<kWideQueries>;
    auto s = static_cast<cudaStream_t>(stream);
    kernel<<<static_cast<unsigned>(plan.blocks), 32 * plan.warps, 0, s>>>(
        static_cast<const float*>(T), static_cast<const float*>(src),
        static_cast<const float*>(src_cov6),
        static_cast<const uint8_t*>(src_mask),
        static_cast<const float*>(tgt_eff),
        static_cast<const float4*>(payload), static_cast<float*>(partial),
        static_cast<float4*>(aux), S, Tn, gate2, plan.tiles);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    sum_partials_kernel<<<P, kOut, 0, s>>>(static_cast<const float*>(partial),
                                           static_cast<float*>(sums), plan.tiles);
  }
  return static_cast<int>(cudaGetLastError());
}
