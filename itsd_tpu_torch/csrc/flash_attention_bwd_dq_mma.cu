// Single-head flash attention backward, dq, on the tensor cores with
// mma.sync, for bf16 over [B, N, C]. The "mma" route's dq until the Hopper
// kernel (csrc/flash_attention_bwd_dq_hopper.cu: wgmma, TMA, mbarriers)
// replaced it; kept as itsd_flash_bwd_dq_mma_sync, which only a forced call
// (kernels/attention.py:_flash_bwd_dq_mma_sync) reaches, as the new
// kernel's same-call yardstick.
//
// Replaced the TPU kernel itsd_tpu/kernels/attention.py:_flash_bwd_dq_kernel
// (launched by _attention_flash_bwd) for bf16 inputs with C % 16 == 0 and
// C <= 256; f32 inputs and other widths take the CUDA-core kernel of
// csrc/flash_attention_bwd.cu, so that f32 never runs on the tensor cores.
// Same arithmetic as the Pallas kernel: s = (q.k^T summed in f32) * scale,
// p = exp(s - lse) from the forward's per-row log-sum-exp, dp = dO.v^T in
// f32, ds = p * (dp - dd) with dd = rowsum(dO * O) - dlse taken by the
// caller, then dq = scale * ds.k with ds rounded to bf16 for that product
// only and the sum in f32. (The Pallas kernel scales each tile's partial
// sum of dq; this kernel scales the whole sum once, which differs only by
// f32 rounding.) Each query row belongs to one block, which walks all the
// keys, so no sum crosses blocks and there are no atomics: dq is the same
// from run to run.
//
// Bound on the card: at the train path's shape (B=128, N=256, C=256) the
// call moves 5 tensors of 16.8 MB plus lse and dd (25 us at 3.35 TB/s) and
// does 3 products of 2*B*N^2*C = 12.9 GFLOP (13 us at 989 TFLOP/s), so it
// is bound by bytes; at mma.sync's rate on Hopper, well below wgmma's, the
// products take about as long as the bytes. Its operands come from shared
// memory through ldmatrix, so shared-memory reads and mma issue limit it.
//
// Design: the forward's (csrc/flash_attention_mma.cu), since dq owns query
// rows just as the forward does. One block of 4 warps per (sample, 64-row
// query tile); each warp owns 16 query rows, the M of an m16n8k16 product.
// The block's q and dO tiles are copied once into shared memory as bf16, and
// each thread reads the lse and dd of its 2 rows once. The keys are walked
// in tiles of 32, K and V copied into shared memory with 16-byte cp.async
// copies. One buffer a tile, not two: q and dO take the room a second K/V
// stage would need, and a single stage keeps a block at 99 KB (C=256), so
// that 2 blocks share an SM and one block's copy overlaps the other's
// products (at the train path's shape this ran faster on the H100 than 1
// block an SM with the tiles double-buffered). Rows are padded by 16 bytes
// (C + 8 elements), so the 8 rows an ldmatrix reads lie in 8 different bank
// groups. Per tile, a warp computes its 16x32 tiles of s = q.k^T and dp =
// dO.v^T with mma.sync (q and dO through ldmatrix as the A operand, K and V
// rows through ldmatrix as the k x n operand), then p and ds on the f32 C
// fragments; keys past N get p = ds = 0. ds, rounded to bf16, goes from the
// C fragments of two neighbouring n-blocks straight into the A fragment of
// ds.k, with K through ldmatrix.trans from the same shared tile, so K is
// staged once. dq accumulates in f32 registers (C/2 = 128 floats a thread at
// C=256); with 2 blocks of 128 threads an SM a thread may use up to 255
// registers. Rows and keys past N are zero-filled by the copies (src-size
// 0), and only rows below N are written. The result goes through the warp's
// own rows of the q tile in shared memory, so that it is written to device
// memory in 16-byte pieces.

#include <math.h>

#include "common.cuh"
#include "mma_tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = kWarps * 16;  // query rows a block
constexpr int kBK = 32;           // keys a tile
constexpr int kPad = 8;           // bf16 elements of padding a row (16 B)
constexpr int kMaxC = 256;

size_t smem_bytes(int C) {
  return (size_t)(2 * kBQ + 2 * kBK) * (C + kPad) * sizeof(bf16);
}

// kC: the largest C this instantiation takes (it sizes the accumulator);
// kFull: C == kC, fixed at compile time, so that index arithmetic folds.
template <int kC, bool kFull>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const bf16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ dd,
                            bf16* __restrict__ dq, int N, int c_arg,
                            float scale) {
  static_assert(kC % 16 == 0 && kC <= kMaxC, "kC: a multiple of 16");
  constexpr int kNB = kC / 8;  // n-blocks of 8 dq columns
  const int C = kFull ? kC : c_arg;
  const int ld = C + kPad;
  const int ksteps = C / 16;  // 16-column steps of C
  extern __shared__ uint4 smem_dq[];
  bf16* qs = reinterpret_cast<bf16*>(smem_dq);  // [kBQ][ld]
  bf16* dos = qs + kBQ * ld;                    // [kBQ][ld]
  bf16* kt = dos + kBQ * ld;                    // [kBK][ld]
  bf16* vt = kt + kBK * ld;                     // [kBK][ld]

  const int b = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t off = (size_t)b * N * C;
  const bf16* kb = k + off;
  const bf16* vb = v + off;

  mma::stage_rows<kBQ, kThreads>(q + off, qs, q0, N, C, ld, tid);
  mma::stage_rows<kBQ, kThreads>(dout + off, dos, q0, N, C, ld, tid);
  mma::stage_rows<kBK, kThreads>(kb, kt, 0, N, C, ld, tid);
  mma::stage_rows<kBK, kThreads>(vb, vt, 0, N, C, ld, tid);
  mma::cp_async_commit();

  // lse and dd of rows g and g + 8 of the warp's 16 (0 past N: those rows
  // are zero-filled and not written)
  const int row0 = q0 + warp * 16;
  float lse_r[2], dd_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    lse_r[r] = row < N ? lse[(size_t)b * N + row] : 0.f;
    dd_r[r] = row < N ? dd[(size_t)b * N + row] : 0.f;
  }

  // This lane's ldmatrix offsets: q and dO rows as the A operand (the
  // warp's 16 rows); K and V rows as the k x n operand of s and dp (2
  // n-blocks of 8 keys a load); K rows transposed as the k x n operand of
  // ds.k (2 n-blocks of 8 columns a load).
  const int a_off = (warp * 16 + (lane & 15)) * ld + (lane >> 4) * 8;
  const int k_off = ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8;
  const int t_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;

  float acc[kNB][4];
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;

  const int ntiles = (N + kBK - 1) / kBK;
  for (int j = 0; j < ntiles; ++j) {
    if (j > 0) {  // tile 0 came with q and dO
      mma::stage_rows<kBK, kThreads>(kb, kt, j * kBK, N, C, ld, tid);
      mma::stage_rows<kBK, kThreads>(vb, vt, j * kBK, N, C, ld, tid);
      mma::cp_async_commit();
    }
    mma::cp_async_wait<0>();
    __syncthreads();

    // s = q.k^T and dp = dO.v^T: 4 n-blocks of 8 keys each
    float s[4][4], dp[4][4];
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kC / 16; ++kk) {
      if (kFull || kk < ksteps) {
        uint32_t a[4];
        mma::ldsm_x4(a, qs + a_off + kk * 16);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bk[4];
          mma::ldsm_x4(bk, kt + np * 16 * ld + k_off + kk * 16);
          mma::mma_bf16(s[2 * np], a, bk[0], bk[1]);
          mma::mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
        }
        mma::ldsm_x4(a, dos + a_off + kk * 16);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bv[4];
          mma::ldsm_x4(bv, vt + np * 16 * ld + k_off + kk * 16);
          mma::mma_bf16(dp[2 * np], a, bv[0], bv[1]);
          mma::mma_bf16(dp[2 * np + 1], a, bv[2], bv[3]);
        }
      }
    }

    // p = exp(s * scale - lse) and ds = p * (dp - dd), into s; element e
    // of n-block nb is row g + 8 * (e / 2), key k0 + 8 * nb + 2t + e % 2.
    // A key past N has zero-filled K and V rows, which would give
    // ds = -exp(-lse) * dd: it is forced to 0.
    const int k0 = j * kBK;
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = k0 + 8 * nb + 2 * t + (e & 1) < N;
        const float p = expf(s[nb][e] * scale - lse_r[e >> 1]);
        s[nb][e] = valid ? p * (dp[nb][e] - dd_r[e >> 1]) : 0.f;
      }

    // acc += bf16(ds).k: ds's C fragments are the A fragments, 16 keys a
    // step
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint32_t a[4] = {
          mma::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          mma::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          mma::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          mma::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < kNB / 2; ++np) {
        if (kFull || np < ksteps) {
          uint32_t bt[4];
          mma::ldsm_x4_t(bt, kt + kk * 16 * ld + t_off + np * 16);
          mma::mma_bf16(acc[2 * np], a, bt[0], bt[1]);
          mma::mma_bf16(acc[2 * np + 1], a, bt[2], bt[3]);
        }
      }
    }
    __syncthreads();  // the tile is consumed before it is refilled
  }

  // dq = scale * acc, through the warp's own 16 rows of the q tile (after
  // the loop's last barrier no warp reads them), then 16-byte stores
  bf16* ow = qs + warp * 16 * ld;
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb) {
    if (kFull || nb < 2 * ksteps) {
      const int c = 8 * nb + 2 * t;
      *reinterpret_cast<uint32_t*>(ow + g * ld + c) =
          mma::pack_bf16(scale * acc[nb][0], scale * acc[nb][1]);
      *reinterpret_cast<uint32_t*>(ow + (g + 8) * ld + c) =
          mma::pack_bf16(scale * acc[nb][2], scale * acc[nb][3]);
    }
  }
  __syncwarp();
  const int chunks = C / 8;
  for (int i = lane; i < 16 * chunks; i += 32) {
    const int r = i / chunks, c = (i - r * chunks) * 8;
    if (row0 + r < N)
      *reinterpret_cast<uint4*>(dq + off + (size_t)(row0 + r) * C + c) =
          *reinterpret_cast<const uint4*>(ow + r * ld + c);
  }
}

template <int kC, bool kFull>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* dd,
                   void* dq, int B, int N, int C, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(C);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_mma_kernel<kC, kFull>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((N + kBQ - 1) / kBQ, B);
  flash_bwd_dq_mma_kernel<kC, kFull><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dd),
      static_cast<bf16*>(dq), N, C, scale);
  return cudaGetLastError();
}

}  // namespace

// As itsd_flash_bwd_dq (csrc/flash_attention_bwd.cu), for bf16 only
// (dtype must be ITSD_BF16): q, k, v, dout, dq: [B, N, C] contiguous bf16;
// lse, dd: [B, N] f32. Needs C % 16 == 0, C <= 256 and 16-byte aligned q,
// k, v, dout, dq. Any N >= 1.
// Returns the first CUDA error of the launch, or 0.
extern "C" int itsd_flash_bwd_dq_mma_sync(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* dd,
                                          void* dq, int B, int N, int C,
                                          float scale, int dtype,
                                          void* stream) {
  if (dtype != ITSD_BF16 || B <= 0 || B > 65535 || N <= 0 || C <= 0 ||
      C > kMaxC || C % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 256)
    return (int)launch<256, true>(q, k, v, dout, lse, dd, dq, B, N, C, scale,
                                  s);
  if (C <= 64)
    return (int)launch<64, false>(q, k, v, dout, lse, dd, dq, B, N, C, scale,
                                  s);
  if (C <= 128)
    return (int)launch<128, false>(q, k, v, dout, lse, dd, dq, B, N, C,
                                   scale, s);
  return (int)launch<256, false>(q, k, v, dout, lse, dd, dq, B, N, C, scale,
                                 s);
}
