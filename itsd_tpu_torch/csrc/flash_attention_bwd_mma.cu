// Single-head flash attention backward, dk and dv, on the tensor cores with
// Ampere's mma.sync, for bf16 over [B, N, C].
//
// The "mma" route's dk/dv until csrc/flash_attention_bwd_dkv_hopper.cu
// (wgmma, TMA) took its place; kept under the entry name
// itsd_flash_bwd_dkv_mma_sync as the same-call yardstick of that kernel. No
// path routes here: only the forced calls of
// kernels/attention.py:_flash_bwd_dkv_mma_sync reach it (the CUDA tests and
// chip_smoke.py). It replaced the TPU kernel
// itsd_tpu/kernels/attention.py:_flash_bwd_dkv_kernel for bf16 inputs with
// C % 16 == 0 and C <= 256. Same arithmetic as the Pallas kernel: s = (q.k^T summed in f32) * scale,
// p = exp(s - lse) from the forward's per-row log-sum-exp, dp = dO.v^T in
// f32, ds = p * (dp - dd) with dd = rowsum(dO * O) - dlse taken by the
// caller, then dv = p^T.dO and dk = scale * ds^T.q, with p and ds rounded
// to bf16 for those products only and all sums in f32. (The Pallas kernel
// scales each tile's partial sum of dk; this kernel scales the whole sum
// once, which differs only by f32 rounding.) Each key row belongs to one
// block, which walks all the queries, so no sum crosses blocks and there
// are no atomics: the gradients are the same from run to run.
//
// Bound on the card: at the train path's shape (B=128, N=256, C=256) the
// call moves 6 tensors of 16.8 MB plus lse and dd (30 us at 3.35 TB/s) and
// does 4 products of 2*B*N^2*C = 17.2 GFLOP (17 us at 989 TFLOP/s), so it
// is bound by bytes; at mma.sync's rate on Hopper, well below wgmma's, the
// products take about as long as the bytes. Its operands come from shared
// memory through ldmatrix, so shared-memory reads and mma issue limit it.
//
// Design: one block of 8 warps per (sample, 64-key tile). K and V of the
// block's keys stay in shared memory as bf16; the block walks the queries
// in tiles of 32, q and dO (and the tile's lse and dd) double-buffered with
// cp.async copies, so the next tile's copy overlaps this tile's products.
// Rows are padded by 16 bytes, so the 8 rows an ldmatrix reads lie in 8
// different bank groups. Per tile:
// 1. warp (key group kg of 4, query half h of 2) computes its 16 keys x 16
//    queries of s^T = K.q^T and dp^T = V.dO^T with mma.sync (K and V rows
//    as the A operand, q and dO rows as the k x n operand);
// 2. p^T = exp(s^T * scale - lse) and ds^T = p^T * (dp^T - dd), the lse
//    and dd of each query column read from shared memory; a query past N
//    gets p = ds = 0 (its zero-filled lse would not give that); both are
//    written to shared memory as bf16 (the Pallas kernel's roundings);
// 3. after a barrier, warp (kg, column half h) accumulates its 16 keys x
//    C/2 columns of dv += p^T.dO and dk += ds^T.q, with p^T and ds^T
//    through ldmatrix and dO and q through ldmatrix.trans. Its dk and dv
//    stay in f32 registers: 2 x 64 floats a thread at C=256.
// At C=256 a block takes 143 KB of shared memory (1 block an SM), so a
// thread may use up to 255 registers. Keys past N are zero-filled and not
// written. The results go through the K and V tiles in shared memory, so
// that they are written to device memory in 16-byte pieces.

#include <math.h>

#include "common.cuh"
#include "mma_tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBKey = 64;  // keys a block owns: 4 groups of 16
constexpr int kBQ = 32;    // queries a tile: 2 halves of 16
constexpr int kPad = 8;    // bf16 elements of padding a row (16 B)
constexpr int kLdP = kBQ + kPad;  // row of the p^T and ds^T tiles
constexpr int kMaxC = 256;

size_t smem_bytes(int C) {
  return (size_t)(2 * kBKey + 2 * 2 * kBQ) * (C + kPad) * sizeof(bf16) +
         (size_t)2 * kBKey * kLdP * sizeof(bf16) +
         (size_t)2 * 2 * kBQ * sizeof(float);
}

// kC: the largest C this instantiation takes (it sizes the accumulators);
// kFull: C == kC, fixed at compile time, so that index arithmetic folds.
template <int kC, bool kFull>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ dd,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             int N, int c_arg, float scale) {
  static_assert(kC % 32 == 0 && kC <= kMaxC, "kC: a multiple of 32");
  constexpr int kPairs = kC / 32;  // 16-column steps of a warp's C/2
  const int C = kFull ? kC : c_arg;
  const int ld = C + kPad;
  const int ksteps = C / 16;            // 16-column steps of C
  const int half = (ksteps + 1) / 2;    // steps of column half 0
  extern __shared__ uint4 smem_dkv[];
  bf16* ks = reinterpret_cast<bf16*>(smem_dkv);  // [kBKey][ld]
  bf16* vs = ks + kBKey * ld;                    // [kBKey][ld]
  bf16* qs = vs + kBKey * ld;                    // [2][kBQ][ld]
  bf16* dos = qs + 2 * kBQ * ld;                 // [2][kBQ][ld]
  bf16* pt = dos + 2 * kBQ * ld;                 // [kBKey][kLdP]
  bf16* dst = pt + kBKey * kLdP;                 // [kBKey][kLdP]
  float* lse_s = reinterpret_cast<float*>(dst + kBKey * kLdP);  // [2][kBQ]
  float* dd_s = lse_s + 2 * kBQ;                                // [2][kBQ]

  const int b = blockIdx.y, k0 = blockIdx.x * kBKey;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kg = warp & 3, h = warp >> 2;
  const size_t off = (size_t)b * N * C;
  const bf16* qb = q + off;
  const bf16* dob = dout + off;
  const float* lse_b = lse + (size_t)b * N;
  const float* dd_b = dd + (size_t)b * N;

  // copy query tile j (q, dO, lse, dd) into stage st
  auto stage = [&](int j, int st) {
    const int r0 = j * kBQ;
    mma::stage_rows<kBQ, kThreads>(qb, qs + st * kBQ * ld, r0, N, C, ld, tid);
    mma::stage_rows<kBQ, kThreads>(dob, dos + st * kBQ * ld, r0, N, C, ld,
                                   tid);
    if (tid < 2 * kBQ) {
      const int i = tid & (kBQ - 1);
      const bool valid = r0 + i < N;
      const float* src = tid < kBQ ? lse_b : dd_b;
      float* dst_row = (tid < kBQ ? lse_s : dd_s) + st * kBQ;
      mma::cp_async4(dst_row + i, valid ? src + r0 + i : src, valid);
    }
  };

  mma::stage_rows<kBKey, kThreads>(k + off, ks, k0, N, C, ld, tid);
  mma::stage_rows<kBKey, kThreads>(v + off, vs, k0, N, C, ld, tid);
  stage(0, 0);
  mma::cp_async_commit();

  // This lane's ldmatrix offsets: rows of K, V, p^T and ds^T as the A
  // operand (the warp's 16 keys); q and dO rows as the k x n operand of
  // s^T and dp^T (2 n-blocks of 8 queries a load); q and dO rows
  // transposed as the k x n operand of dk and dv (2 n-blocks of 8 columns
  // a load).
  const int a_row = kg * 16 + (lane & 15), a_col = (lane >> 4) * 8;
  const int b_off = (h * 16 + (lane & 7) + (lane >> 4) * 8) * ld +
                    ((lane >> 3) & 1) * 8;
  const int t_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
  const int c_first = h * half;  // this warp's first 16-column step

  float dka[2 * kPairs][4], dva[2 * kPairs][4];
#pragma unroll
  for (int nb = 0; nb < 2 * kPairs; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nb][e] = dva[nb][e] = 0.f;

  const int ntiles = (N + kBQ - 1) / kBQ;
  for (int j = 0; j < ntiles; ++j) {
    const int st = j & 1;
    if (j + 1 < ntiles) {  // the next tile's copy overlaps this tile
      stage(j + 1, st ^ 1);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qt = qs + st * kBQ * ld;
    const bf16* dot = dos + st * kBQ * ld;

    // 1. s^T = K.q^T and dp^T = V.dO^T: 2 n-blocks of 8 queries
    float sa[2][4], da[2][4];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) sa[nb][e] = da[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kC / 16; ++kk) {
      if (kFull || kk < ksteps) {
        uint32_t a[4], bq[4];
        mma::ldsm_x4(a, ks + a_row * ld + a_col + kk * 16);
        mma::ldsm_x4(bq, qt + b_off + kk * 16);
        mma::mma_bf16(sa[0], a, bq[0], bq[1]);
        mma::mma_bf16(sa[1], a, bq[2], bq[3]);
        mma::ldsm_x4(a, vs + a_row * ld + a_col + kk * 16);
        mma::ldsm_x4(bq, dot + b_off + kk * 16);
        mma::mma_bf16(da[0], a, bq[0], bq[1]);
        mma::mma_bf16(da[1], a, bq[2], bq[3]);
      }
    }

    // 2. p^T and ds^T as bf16; element e of n-block nb is key row
    // kg*16 + g + 8*(e/2), query column h*16 + 8*nb + 2t + e%2
    const float* lse_t = lse_s + st * kBQ;
    const float* dd_t = dd_s + st * kBQ;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      const int col = h * 16 + 8 * nb + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool valid = j * kBQ + col + e < N;
          const float pf =
              valid ? expf(sa[nb][2 * r + e] * scale - lse_t[col + e]) : 0.f;
          p[e] = pf;
          ds[e] = valid ? pf * (da[nb][2 * r + e] - dd_t[col + e]) : 0.f;
        }
        const int row = kg * 16 + g + 8 * r;
        *reinterpret_cast<uint32_t*>(pt + row * kLdP + col) =
            mma::pack_bf16(p[0], p[1]);
        *reinterpret_cast<uint32_t*>(dst + row * kLdP + col) =
            mma::pack_bf16(ds[0], ds[1]);
      }
    }
    __syncthreads();

    // 3. dv += p^T.dO and dk += ds^T.q over this warp's column half
#pragma unroll
    for (int kq = 0; kq < 2; ++kq) {
      uint32_t ap[4], ad[4];
      mma::ldsm_x4(ap, pt + a_row * kLdP + a_col + kq * 16);
      mma::ldsm_x4(ad, dst + a_row * kLdP + a_col + kq * 16);
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        const int cs = c_first + i;  // 16-column step of C
        if (kFull || (i < half && cs < ksteps)) {
          uint32_t bt[4];
          mma::ldsm_x4_t(bt, dot + kq * 16 * ld + t_off + cs * 16);
          mma::mma_bf16(dva[2 * i], ap, bt[0], bt[1]);
          mma::mma_bf16(dva[2 * i + 1], ap, bt[2], bt[3]);
          mma::ldsm_x4_t(bt, qt + kq * 16 * ld + t_off + cs * 16);
          mma::mma_bf16(dka[2 * i], ad, bt[0], bt[1]);
          mma::mma_bf16(dka[2 * i + 1], ad, bt[2], bt[3]);
        }
      }
    }
    __syncthreads();  // this stage and p^T, ds^T are consumed
  }

  // dk = scale * sum and dv in bf16, through the K and V tiles in shared
  // memory (free after the loop's last barrier), then 16-byte stores
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int cs = c_first + i;
    if (kFull || (i < half && cs < ksteps)) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = cs * 16 + 8 * u + 2 * t;
        const int nb = 2 * i + u;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = kg * 16 + g + 8 * r;
          *reinterpret_cast<uint32_t*>(ks + row * ld + c) = mma::pack_bf16(
              scale * dka[nb][2 * r], scale * dka[nb][2 * r + 1]);
          *reinterpret_cast<uint32_t*>(vs + row * ld + c) =
              mma::pack_bf16(dva[nb][2 * r], dva[nb][2 * r + 1]);
        }
      }
    }
  }
  __syncthreads();
  const int chunks = C / 8;
  for (int i = tid; i < kBKey * chunks; i += kThreads) {
    const int r = i / chunks, c = (i - r * chunks) * 8;
    if (k0 + r < N) {
      const size_t at = off + (size_t)(k0 + r) * C + c;
      *reinterpret_cast<uint4*>(dk + at) =
          *reinterpret_cast<const uint4*>(ks + r * ld + c);
      *reinterpret_cast<uint4*>(dv + at) =
          *reinterpret_cast<const uint4*>(vs + r * ld + c);
    }
  }
}

template <int kC, bool kFull>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* dd,
                   void* dk, void* dv, int B, int N, int C, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(C);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_mma_kernel<kC, kFull>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((N + kBKey - 1) / kBKey, B);
  flash_bwd_dkv_mma_kernel<kC, kFull><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dd),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), N, C, scale);
  return cudaGetLastError();
}

}  // namespace

// As itsd_flash_bwd_dkv (csrc/flash_attention_bwd.cu), for bf16 only
// (dtype must be ITSD_BF16): q, k, v, dout, dk, dv: [B, N, C] contiguous
// bf16; lse, dd: [B, N] f32. Needs C % 16 == 0, C <= 256 and 16-byte
// aligned q, k, v, dout, dk, dv. Any N >= 1.
// Returns the first CUDA error of the launch, or 0.
extern "C" int itsd_flash_bwd_dkv_mma_sync(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const void* lse, const void* dd,
                                           void* dk, void* dv, int B, int N,
                                           int C, float scale, int dtype,
                                           void* stream) {
  if (dtype != ITSD_BF16 || B <= 0 || B > 65535 || N <= 0 || C <= 0 ||
      C > kMaxC || C % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 256)
    return (int)launch<256, true>(q, k, v, dout, lse, dd, dk, dv, B, N, C,
                                  scale, s);
  if (C <= 64)
    return (int)launch<64, false>(q, k, v, dout, lse, dd, dk, dv, B, N, C,
                                  scale, s);
  if (C <= 128)
    return (int)launch<128, false>(q, k, v, dout, lse, dd, dk, dv, B, N, C,
                                   scale, s);
  return (int)launch<256, false>(q, k, v, dout, lse, dd, dk, dv, B, N, C,
                                 scale, s);
}
