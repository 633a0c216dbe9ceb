// Single-head flash attention backward, dk and dv, on the tensor cores for
// wide rows: bf16 over [B, N, C] with 256 < C <= 1024, on mma.sync. The
// "wide" route's dk/dv is now the Hopper kernel of
// csrc/flash_attention_bwd_dkv_wide_hopper.cu (wgmma, TMA, mbarriers); this
// one stays as its same-call yardstick, itsd_flash_bwd_dkv_wide_sync, which
// only the forced call _flash_bwd_dkv_wide_sync reaches.
//
// Replaces the TPU kernel itsd_tpu/kernels/attention.py:_flash_bwd_dkv_kernel
// (launched by _attention_flash_bwd) for bf16 inputs with C % 16 == 0 and
// 256 < C <= 1024: the CFG UNet's C=512 and C=1024 and the 256x256
// flagship's C=384. Narrower bf16 rows take csrc/flash_attention_bwd_mma.cu;
// f32 and every other width the CUDA-core kernel of
// csrc/flash_attention_bwd.cu, so that f32 never runs on the tensor cores.
// Same arithmetic as flash_attention_bwd_mma.cu: s = (q.k^T summed in f32)
// * scale, p = exp(s - lse) from the forward's per-row log-sum-exp,
// dp = dO.v^T in f32, ds = p * (dp - dd) with dd = rowsum(dO * O) - dlse
// taken by the caller, then dv = p^T.dO and dk = scale * ds^T.q, with p
// and ds rounded to bf16 for those products only, all sums in f32 and dk
// scaled once. Each key row belongs to one block, which walks all the
// queries, so no sum crosses blocks and there are no atomics: the
// gradients are the same from run to run.
//
// Bound on the card: at the CFG train step's [256, 256, 512] the call
// moves 6 tensors of 67.1 MB plus lse and dd (120 us at 3.35 TB/s) and
// does 4 products of 2*B*N^2*C = 17.2 GFLOP (69 us at 989 TFLOP/s), so it
// is bound by bytes; at mma.sync's rate through ldmatrix the products take
// longer than the bytes.
//
// Design. The narrow kernel's blocks own 64 keys and give each warp 16
// keys x C/2 columns of dk and dv: 2 x 64 floats a thread at C=256, 2 x
// 128 at C=512. Here a block owns fewer keys, and more warps share them:
// 32 keys (2 key groups of 16, 4 warps each, each warp a quarter of C) at
// C <= 512, 16 keys (1 group of 8 warps, an eighth of C each) at
// C <= 1024, so dk + dv stay at 128 floats a thread. The queries are
// walked in tiles of kBQ = 32 (C <= 512) or 16 (C <= 1024), q and dO
// (and the tile's lse and dd) double-buffered with cp.async copies; a
// tile's copy is issued right after the barrier that opens the previous
// tile, so it overlaps that tile's work. Per tile:
// 1. the 16 keys x 16 queries of s^T = K.q^T and dp^T = V.dO^T of a key
//    group and a block of 16 queries are split over kCS warps by columns
//    of C (a split-K: 2 warps of half of C each at C <= 512, 8 of an
//    eighth at C <= 1024): each warp multiplies its columns of K and V (A
//    operand) by the same columns of q and dO (k x n operand) with
//    mma.sync and writes its partial tiles to shared memory in fragment
//    order;
// 2. after a barrier of those kCS warps, each sums 8/kCS of the 8
//    elements a lane holds over the kCS partials in warp order, then
//    p^T = exp(s^T * scale - lse) and ds^T = p^T * (dp^T - dd), a query
//    past N giving p = ds = 0 (its zero-filled lse would not), and writes
//    both to shared memory as bf16 (the Pallas kernel's roundings);
// 3. after a block barrier, each warp accumulates its 16 keys x its
//    columns of dv += p^T.dO and dk += ds^T.q, with p^T and ds^T through
//    ldmatrix and dO and q through ldmatrix.trans.
// The split-K changes only the sum order of s and dp: rounding, within
// the tolerances that hold the kernel. Shared memory: K and V of the
// block's keys, q and dO in two stages, the partials (16 KB), p^T, ds^T,
// lse and dd: 221,696 B at C=512, 216,320 B at C=1024, so 1 block an SM
// and up to 255 registers a thread. Rows are padded by 16 bytes, so the 8
// rows an ldmatrix reads lie in 8 different bank groups. Keys past N are
// zero-filled and not written. The results go through the K and V tiles
// in shared memory, so that they are written to device memory in 16-byte
// pieces.
//
// Fewer keys a block means more blocks read each sample's q and dO: at
// [256, 256, 512], 8 key blocks a sample each read its 512 KB of q and
// dO, 1.07 GB in all against 134 MB read once. The 8 blocks of a sample
// are neighbours in the grid's order, so they run at the same time
// (132 SMs hold ~16 samples' blocks, ~8 MB of q and dO, well inside the
// 50 MB L2): the first read of a tile brings it from device memory and the
// other 7 should find it in L2, so device memory sees about the 134 MB.
// That is an inference from the launch order; no profiler that reads the
// L2's hit rate runs on the card's machine.

#include <math.h>

#include "common.cuh"
#include "mma_tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;      // bf16 elements of padding a row (16 B)
constexpr int kMinC = 256;   // C up to this takes flash_attention_bwd_mma.cu
constexpr int kMaxC = 1024;

// K and V of the block's keys, q and dO in two stages, the p^T and ds^T
// tiles, the s^T and dp^T partials (8 floats a lane of each warp), and
// lse and dd in two stages.
template <int kKG, int kBQ>
size_t smem_bytes(int C) {
  constexpr int kBKey = 16 * kKG;
  constexpr int kLdP = kBQ + kPad;
  return (size_t)(2 * kBKey + 2 * 2 * kBQ) * (C + kPad) * sizeof(bf16) +
         (size_t)2 * kBKey * kLdP * sizeof(bf16) +
         (size_t)2 * kWarps * 8 * 32 * sizeof(float) +
         (size_t)2 * 2 * kBQ * sizeof(float);
}

// kC: the largest C this instantiation takes (it sizes the accumulators);
// kKG: key groups of 16 a block; kBQ: queries a tile; kFull: C == kC,
// fixed at compile time, so that index arithmetic folds.
template <int kC, int kKG, int kBQ, bool kFull>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_wide_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ dd,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              int N, int c_arg, float scale) {
  constexpr int kBKey = 16 * kKG;         // keys a block owns
  constexpr int kWg = kWarps / kKG;       // warps a key group
  constexpr int kQB = kBQ / 16;           // blocks of 16 queries a tile
  constexpr int kCS = kWg / kQB;          // warps that share a score tile
  constexpr int kPer1 = kC / (16 * kCS);  // most steps of a score share
  constexpr int kPer3 = kC / (16 * kWg);  // most steps of a dk/dv share
  constexpr int kSlots = 8 / kCS;         // score elements a lane sums
  constexpr int kLdP = kBQ + kPad;        // row of the p^T and ds^T tiles
  static_assert(kQB * kCS == kWg && 8 % kCS == 0 && kC % (16 * kWg) == 0 &&
                    kC <= kMaxC && (kBQ & (kBQ - 1)) == 0,
                "bad tiling");
  const int C = kFull ? kC : c_arg;
  const int ld = C + kPad;
  const int ksteps = C / 16;  // 16-column steps of C
  extern __shared__ uint4 smem_dkv_wide[];
  bf16* ks = reinterpret_cast<bf16*>(smem_dkv_wide);  // [kBKey][ld]
  bf16* vs = ks + kBKey * ld;                         // [kBKey][ld]
  bf16* qs = vs + kBKey * ld;                         // [2][kBQ][ld]
  bf16* dos = qs + 2 * kBQ * ld;                      // [2][kBQ][ld]
  bf16* pt = dos + 2 * kBQ * ld;                      // [kBKey][kLdP]
  bf16* dst = pt + kBKey * kLdP;                      // [kBKey][kLdP]
  // the s^T and dp^T partials, [kWarps][8][32] each
  float* part_s = reinterpret_cast<float*>(dst + kBKey * kLdP);
  float* part_d = part_s + kWarps * 8 * 32;
  float* lse_s = part_d + kWarps * 8 * 32;  // [2][kBQ]
  float* dd_s = lse_s + 2 * kBQ;            // [2][kBQ]

  const int b = blockIdx.y, k0 = blockIdx.x * kBKey;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kg = warp / kWg, wi = warp % kWg;
  const int qb = wi / kCS, cs = wi % kCS;  // score tile: queries, share
  // 16-column steps of C: of the score share [f1, f1 + n1), of the dk/dv
  // share [f3, f3 + n3); the shares differ by at most one step (all equal
  // when kFull) and may be empty when C is not a multiple of their count
  const int f1 = cs * ksteps / kCS, n1 = (cs + 1) * ksteps / kCS - f1;
  const int f3 = wi * ksteps / kWg, n3 = (wi + 1) * ksteps / kWg - f3;
  const size_t off = (size_t)b * N * C;
  const bf16* qbase = q + off;
  const bf16* dob = dout + off;
  const float* lse_b = lse + (size_t)b * N;
  const float* dd_b = dd + (size_t)b * N;

  // copy query tile j (q, dO, lse, dd) into stage st
  auto stage = [&](int j, int st) {
    const int r0 = j * kBQ;
    mma::stage_rows<kBQ, kThreads>(qbase, qs + st * kBQ * ld, r0, N, C, ld,
                                   tid);
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
  // operand (the key group's 16 keys); q and dO rows as the k x n operand
  // of s^T and dp^T (2 n-blocks of 8 queries a load); q and dO rows
  // transposed as the k x n operand of dk and dv (2 n-blocks of 8 columns
  // a load).
  const int a_row = kg * 16 + (lane & 15), a_col = (lane >> 4) * 8;
  const int b_off = (qb * 16 + (lane & 7) + (lane >> 4) * 8) * ld +
                    ((lane >> 3) & 1) * 8;
  const int t_off =
      ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
  const int w0 = kg * kWg + qb * kCS;  // first warp of this score tile

  float dka[2 * kPer3][4], dva[2 * kPer3][4];
#pragma unroll
  for (int nb = 0; nb < 2 * kPer3; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nb][e] = dva[nb][e] = 0.f;

  const int ntiles = (N + kBQ - 1) / kBQ;
  for (int j = 0; j < ntiles; ++j) {
    const int st = j & 1;
    mma::cp_async_wait<0>();
    // tile j has landed, and every warp is done with tile j - 1: its
    // stage, the partials and p^T, ds^T may be written again
    __syncthreads();
    if (j + 1 < ntiles) {  // the next tile's copy overlaps this tile
      stage(j + 1, st ^ 1);
      mma::cp_async_commit();
    }
    const bf16* qt = qs + st * kBQ * ld;
    const bf16* dot = dos + st * kBQ * ld;

    // 1. this warp's share of s^T = K.q^T and dp^T = V.dO^T over its
    // columns: 2 n-blocks of 8 queries
    float sa[2][4], da[2][4];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) sa[nb][e] = da[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kPer1; ++kk) {
      if (kFull || kk < n1) {
        const int c = 16 * (f1 + kk);
        uint32_t a[4], bq[4];
        mma::ldsm_x4(a, ks + a_row * ld + a_col + c);
        mma::ldsm_x4(bq, qt + b_off + c);
        mma::mma_bf16(sa[0], a, bq[0], bq[1]);
        mma::mma_bf16(sa[1], a, bq[2], bq[3]);
        mma::ldsm_x4(a, vs + a_row * ld + a_col + c);
        mma::ldsm_x4(bq, dot + b_off + c);
        mma::mma_bf16(da[0], a, bq[0], bq[1]);
        mma::mma_bf16(da[1], a, bq[2], bq[3]);
      }
    }
    // the partials in fragment order: element e of n-block nb of lane l
    // at [warp][4 * nb + e][l] (lane-consecutive: no bank conflicts)
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        part_s[(warp * 8 + 4 * nb + e) * 32 + lane] = sa[nb][e];
        part_d[(warp * 8 + 4 * nb + e) * 32 + lane] = da[nb][e];
      }
    mma::bar_sync(1 + kg * kQB + qb, kCS * 32);

    // 2. this lane's kSlots elements of the score tile, summed over the
    // kCS shares in warp order, to p^T and ds^T as bf16; element e of
    // n-block nb is key row kg*16 + g + 8*(e/2), query column
    // qb*16 + 8*nb + 2t + e%2
    const float* lse_t = lse_s + st * kBQ;
    const float* dd_t = dd_s + st * kBQ;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int slot = cs * kSlots + i;  // 4 * nb + e
      float sv = part_s[(w0 * 8 + slot) * 32 + lane];
      float dpv = part_d[(w0 * 8 + slot) * 32 + lane];
#pragma unroll
      for (int w = 1; w < kCS; ++w) {
        sv += part_s[((w0 + w) * 8 + slot) * 32 + lane];
        dpv += part_d[((w0 + w) * 8 + slot) * 32 + lane];
      }
      const int nb = slot >> 2, e = slot & 3;
      const int row = kg * 16 + g + 8 * (e >> 1);
      const int col = qb * 16 + 8 * nb + 2 * t + (e & 1);
      const bool valid = j * kBQ + col < N;
      const float p = valid ? expf(sv * scale - lse_t[col]) : 0.f;
      const float ds = valid ? p * (dpv - dd_t[col]) : 0.f;
      pt[row * kLdP + col] = __float2bfloat16(p);
      dst[row * kLdP + col] = __float2bfloat16(ds);
    }
    __syncthreads();

    // 3. dv += p^T.dO and dk += ds^T.q over this warp's columns
#pragma unroll
    for (int kq = 0; kq < kQB; ++kq) {
      uint32_t ap[4], ad[4];
      mma::ldsm_x4(ap, pt + a_row * kLdP + a_col + kq * 16);
      mma::ldsm_x4(ad, dst + a_row * kLdP + a_col + kq * 16);
#pragma unroll
      for (int i = 0; i < kPer3; ++i) {
        if (kFull || i < n3) {
          const int c = 16 * (f3 + i);
          uint32_t bt[4];
          mma::ldsm_x4_t(bt, dot + kq * 16 * ld + t_off + c);
          mma::mma_bf16(dva[2 * i], ap, bt[0], bt[1]);
          mma::mma_bf16(dva[2 * i + 1], ap, bt[2], bt[3]);
          mma::ldsm_x4_t(bt, qt + kq * 16 * ld + t_off + c);
          mma::mma_bf16(dka[2 * i], ad, bt[0], bt[1]);
          mma::mma_bf16(dka[2 * i + 1], ad, bt[2], bt[3]);
        }
      }
    }
  }

  // dk = scale * sum and dv in bf16, through this warp's rows and columns
  // of the K and V tiles in shared memory (every warp read K and V last
  // before the last tile's block barrier), then 16-byte stores
#pragma unroll
  for (int i = 0; i < kPer3; ++i) {
    if (kFull || i < n3) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = 16 * (f3 + i) + 8 * u + 2 * t;
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

template <int kC, int kKG, int kBQ, bool kFull>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* dd,
                   void* dk, void* dv, int B, int N, int C, float scale,
                   cudaStream_t stream) {
  constexpr int kBKey = 16 * kKG;
  const size_t smem = smem_bytes<kKG, kBQ>(C);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_wide_kernel<kC, kKG, kBQ, kFull>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((N + kBKey - 1) / kBKey, B);
  flash_bwd_dkv_wide_kernel<kC, kKG, kBQ, kFull>
      <<<grid, kThreads, smem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(dd),
          static_cast<bf16*>(dk), static_cast<bf16*>(dv), N, C, scale);
  return cudaGetLastError();
}

}  // namespace

// As itsd_flash_bwd_dkv (csrc/flash_attention_bwd.cu), for bf16 only
// (dtype must be ITSD_BF16): q, k, v, dout, dk, dv: [B, N, C] contiguous
// bf16; lse, dd: [B, N] f32. Needs C % 16 == 0, 256 < C <= 1024 and
// 16-byte aligned q, k, v, dout, dk, dv. Any N >= 1.
// Returns the first CUDA error of the launch, or 0.
extern "C" int itsd_flash_bwd_dkv_wide_sync(const void* q, const void* k,
                                            const void* v, const void* dout,
                                            const void* lse, const void* dd,
                                            void* dk, void* dv, int B, int N,
                                            int C, float scale, int dtype,
                                            void* stream) {
  if (dtype != ITSD_BF16 || B <= 0 || B > 65535 || N <= 0 || C <= kMinC ||
      C > kMaxC || C % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the CFG UNet's widths and the flagship's have instantiations of their
  // own; any other width takes the next wider one
  if (C == 512)
    return (int)launch<512, 2, 32, true>(q, k, v, dout, lse, dd, dk, dv, B,
                                         N, C, scale, s);
  if (C == 1024)
    return (int)launch<1024, 1, 16, true>(q, k, v, dout, lse, dd, dk, dv, B,
                                          N, C, scale, s);
  if (C == 384)
    return (int)launch<384, 2, 32, true>(q, k, v, dout, lse, dd, dk, dv, B,
                                         N, C, scale, s);
  if (C <= 512)
    return (int)launch<512, 2, 32, false>(q, k, v, dout, lse, dd, dk, dv, B,
                                          N, C, scale, s);
  return (int)launch<1024, 1, 16, false>(q, k, v, dout, lse, dd, dk, dv, B,
                                         N, C, scale, s);
}
