// Single-head flash attention backward, dq, on the tensor cores for wide
// rows: bf16 over [B, N, C] with 256 < C <= 1024.
//
// Replaces the TPU kernel itsd_tpu/kernels/attention.py:_flash_bwd_dq_kernel
// (launched by _attention_flash_bwd) for bf16 inputs with C % 16 == 0 and
// 256 < C <= 1024: the CFG UNet's C=512 (16x16 and 2x2) and C=1024 (8x8
// and 4x4), and the 256x256 flagship's C=384. Narrower bf16 rows take
// csrc/flash_attention_bwd_dq_hopper.cu; f32 and every other width the
// CUDA-core kernel of csrc/flash_attention_bwd.cu. Same arithmetic as
// flash_attention_bwd_dq_hopper.cu:
// s = (q.k^T summed in f32) * scale, p = exp(s - lse) from the forward's
// per-row log-sum-exp, dp = dO.v^T in f32, ds = p * (dp - dd) with
// dd = rowsum(dO * O) - dlse taken by the caller, then dq = scale * ds.k
// with ds rounded to bf16 for that product only, the sum in f32 and
// scaled once. Each query row belongs to one block, which walks all the
// keys, so no sum crosses blocks and there are no atomics: dq is the same
// from run to run.
//
// Bound on the card: at the CFG train step's [256, 256, 512] the call
// moves 5 tensors of 67.1 MB plus lse and dd (100 us at 3.35 TB/s) and
// does 3 products of 2*B*N^2*C = 17.2 GFLOP (52 us at 989 TFLOP/s), so it
// is bound by bytes; mma.sync with operands through ldmatrix reaches well
// under the tensor cores' peak, so shared-memory reads and mma issue limit
// it first.
//
// Design. dq owns query rows, as the forward does, so the layout is the
// wide forward's (csrc/flash_attention_wide.cu): kW warps share a 16-row
// "row group", each owning a contiguous share of C (at most 128 columns,
// in 16-column steps): kW = 4 at C <= 512 (2 row groups, 32 query rows a
// block), 8 above (1 row group, 16 rows). That bounds what a thread holds
// of its warp's columns to 64 f32 of dq and, as A fragments kept in
// registers for the whole key walk, 32 registers of q and 32 of dO; K and
// V are then all the shared memory must hold besides the exchange. Per
// key tile (kBK = 32 keys at C <= 512, 16 above):
// 1. each warp multiplies its columns of q and dO by the same columns of
//    K and V (a split-K) into partial 16 x kBK tiles of s and dp, and
//    writes them to shared memory in fragment order (element e of n-block
//    nb of lane l at [warp][4 * nb + e][l]: lane-consecutive, no bank
//    conflicts);
// 2. after a barrier of the row group's kW warps (bar.sync with an id a
//    group), each sums a share (kBK/2/kW of the kBK/2 elements a lane
//    holds) over the kW partials in warp order, forms p and ds (keys past
//    N get ds = 0), and writes ds as bf16 to the group's ds tile: every
//    warp of a group then builds its columns of a dq row from the same
//    rounding of ds;
// 3. after a second barrier of the group, each warp reads the ds tile as
//    the A fragments of ds.k through ldmatrix and its columns of K through
//    ldmatrix.trans from the same shared tile, so K is staged once.
// The split-K changes only the sum order of s and dp: rounding, within
// the tolerances that hold the kernel. K and V are double-buffered with
// 16-byte cp.async copies; a tile's copy is issued right after the block
// barrier that opens the previous tile, so it overlaps that tile's work.
// q and dO come in through the second stage before the walk (a block's
// query rows are no more than a tile's keys), and dq goes out through the
// stage the last tile did not use. Shared memory: K and V in two stages,
// the s and dp partials and the ds tiles:
//   C <= 512:  4 * 32 * (C + 8) * 2 + 32,768 + 2,560 B = 168,448 B at C=512
//              (135,680 B at C=384);
//   C <= 1024: 4 * 16 * (C + 8) * 2 + 16,384 + 768 B = 149,248 B at C=1024;
// 1 block of 8 warps an SM and up to 255 registers a thread. Rows are
// padded by 16 bytes (C + 8 elements), so the 8 rows an ldmatrix reads lie
// in 8 different bank groups. Rows and keys past N are zero-filled by the
// copies (src-size 0), and only rows below N are written, in 16-byte
// pieces through shared memory.

#include <math.h>

#include "common.cuh"
#include "mma_tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;      // bf16 elements of padding a row (16 B)
constexpr int kMinC = 256;   // narrower C: flash_attention_bwd_dq_hopper.cu
constexpr int kMaxC = 1024;

// K and V tiles in two stages, the s and dp partials (kBK/2 floats a lane
// of each warp, each), and one bf16 ds tile (16 x kBK) a row group.
template <int kW, int kBK>
size_t smem_bytes(int C) {
  constexpr int kRG = kWarps / kW;
  return (size_t)2 * 2 * kBK * (C + kPad) * sizeof(bf16) +
         (size_t)2 * kWarps * (kBK / 2) * 32 * sizeof(float) +
         (size_t)kRG * 16 * (kBK + kPad) * sizeof(bf16);
}

// kC: the largest C this instantiation takes (it sizes the register
// arrays); kW: warps a row group; kBK: keys a tile; kFull: C == kC, fixed
// at compile time, so that index arithmetic folds.
template <int kC, int kW, int kBK, bool kFull>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_wide_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ dd,
                             bf16* __restrict__ dq, int N, int c_arg,
                             float scale) {
  constexpr int kRG = kWarps / kW;      // row groups a block
  constexpr int kBQ = 16 * kRG;         // query rows a block
  constexpr int kPer = kC / (16 * kW);  // most 16-column steps a warp owns
  constexpr int kNB = kBK / 8;          // n-blocks of 8 keys a tile
  constexpr int kSA = 4 * kNB;          // score elements a lane holds
  constexpr int kSlots = kSA / kW;      // of those, the ones it sums
  constexpr int kLdS = kBK + kPad;      // row of the ds tile
  static_assert(kWarps % kW == 0 && kC % (16 * kW) == 0 && kBK % 16 == 0 &&
                    kSA % kW == 0 && kBQ <= kBK && kC <= kMaxC,
                "bad tiling");
  const int C = kFull ? kC : c_arg;
  const int ld = C + kPad;
  const int ksteps = C / 16;  // 16-column steps of C
  extern __shared__ uint4 smem_dq_wide[];
  bf16* ks = reinterpret_cast<bf16*>(smem_dq_wide);  // [2][kBK][ld]
  bf16* vs = ks + 2 * kBK * ld;                      // [2][kBK][ld]
  // the s and dp partials, [kWarps][kSA][32] each, then the ds tiles
  float* part_s = reinterpret_cast<float*>(vs + 2 * kBK * ld);
  float* part_d = part_s + kWarps * kSA * 32;
  bf16* ds_s = reinterpret_cast<bf16*>(part_d + kWarps * kSA * 32);

  const int b = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp / kW, wc = warp % kW;
  // this warp's 16-column steps of C, [first, first + nw): the kW shares
  // differ by at most one step (all equal, kPer, when kFull); C > 256
  // gives at least 17 steps, so none is empty
  const int first = wc * ksteps / kW;
  const int nw = (wc + 1) * ksteps / kW - first;
  const int c0 = 16 * first;
  const size_t off = (size_t)b * N * C;
  const bf16* kb = k + off;
  const bf16* vb = v + off;
  bf16* dsg = ds_s + rg * 16 * kLdS;  // this row group's ds tile

  // q and dO of the block's rows into the second stage, the first key
  // tile into the first
  mma::stage_rows<kBQ, kThreads>(q + off, ks + kBK * ld, q0, N, C, ld, tid);
  mma::stage_rows<kBQ, kThreads>(dout + off, vs + kBK * ld, q0, N, C, ld,
                                 tid);
  mma::stage_rows<kBK, kThreads>(kb, ks, 0, N, C, ld, tid);
  mma::stage_rows<kBK, kThreads>(vb, vs, 0, N, C, ld, tid);
  mma::cp_async_commit();

  // lse and dd of rows g and g + 8 of the row group (0 past N: those rows
  // are zero-filled, give ds = 0 and are not written)
  const int row0 = q0 + rg * 16;
  float lse_r[2], dd_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    lse_r[r] = row < N ? lse[(size_t)b * N + row] : 0.f;
    dd_r[r] = row < N ? dd[(size_t)b * N + row] : 0.f;
  }

  // This lane's ldmatrix offsets: q, dO and ds rows as the A operand (the
  // row group's 16 rows); K and V rows as the k x n operand of s and dp (2
  // n-blocks of 8 keys a load); K rows transposed as the k x n operand of
  // ds.k (2 n-blocks of 8 columns a load). All within the warp's columns.
  const int a_off = (rg * 16 + (lane & 15)) * ld + (lane >> 4) * 8 + c0;
  const int k_off =
      ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8 + c0;
  const int t_off =
      ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8 + c0;
  const bf16* ds_lane = dsg + (lane & 15) * kLdS + (lane >> 4) * 8;

  // the warp's columns of q and dO as A fragments, for the whole walk
  mma::cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[kPer][4], da[kPer][4];
#pragma unroll
  for (int kk = 0; kk < kPer; ++kk) {
    if (kFull || kk < nw) {
      mma::ldsm_x4(qa[kk], ks + kBK * ld + a_off + kk * 16);
      mma::ldsm_x4(da[kk], vs + kBK * ld + a_off + kk * 16);
    }
  }

  float acc[2 * kPer][4];
#pragma unroll
  for (int nb = 0; nb < 2 * kPer; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;

  const int ntiles = (N + kBK - 1) / kBK;
  for (int j = 0; j < ntiles; ++j) {
    const int st = j & 1;
    mma::cp_async_wait<0>();
    // tile j has landed, and every warp is done with tile j - 1 (and, at
    // j = 0, with the q and dO rows in the second stage): that stage, the
    // partials and the ds tiles may be written again
    __syncthreads();
    if (j + 1 < ntiles) {  // the next tile's copy overlaps this tile
      mma::stage_rows<kBK, kThreads>(kb, ks + (st ^ 1) * kBK * ld,
                                     (j + 1) * kBK, N, C, ld, tid);
      mma::stage_rows<kBK, kThreads>(vb, vs + (st ^ 1) * kBK * ld,
                                     (j + 1) * kBK, N, C, ld, tid);
      mma::cp_async_commit();
    }
    const bf16* kt = ks + st * kBK * ld;
    const bf16* vt = vs + st * kBK * ld;

    // 1. this warp's shares of s = q.k^T and dp = dO.v^T
    float s[kNB][4], dp[kNB][4];
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kPer; ++kk) {
      if (kFull || kk < nw) {
#pragma unroll
        for (int np = 0; np < kNB / 2; ++np) {
          uint32_t bk[4], bv[4];
          mma::ldsm_x4(bk, kt + np * 16 * ld + k_off + kk * 16);
          mma::mma_bf16(s[2 * np], qa[kk], bk[0], bk[1]);
          mma::mma_bf16(s[2 * np + 1], qa[kk], bk[2], bk[3]);
          mma::ldsm_x4(bv, vt + np * 16 * ld + k_off + kk * 16);
          mma::mma_bf16(dp[2 * np], da[kk], bv[0], bv[1]);
          mma::mma_bf16(dp[2 * np + 1], da[kk], bv[2], bv[3]);
        }
      }
    }
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        part_s[(warp * kSA + 4 * nb + e) * 32 + lane] = s[nb][e];
        part_d[(warp * kSA + 4 * nb + e) * 32 + lane] = dp[nb][e];
      }
    mma::bar_sync(1 + rg, kW * 32);

    // 2. this lane's kSlots elements of the group's tile, summed over the
    // kW shares in warp order, to ds as bf16; element e of n-block nb is
    // row g + 8 * (e / 2), key k0 + 8 * nb + 2t + e % 2. A key past N has
    // zero-filled K and V rows, which would give ds = -exp(-lse) * dd: it
    // is forced to 0.
    const int k0 = j * kBK;
    const int w0 = rg * kW;  // first warp of the group
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int slot = wc * kSlots + i;  // 4 * nb + e
      float sv = part_s[(w0 * kSA + slot) * 32 + lane];
      float dpv = part_d[(w0 * kSA + slot) * 32 + lane];
#pragma unroll
      for (int w = 1; w < kW; ++w) {
        sv += part_s[((w0 + w) * kSA + slot) * 32 + lane];
        dpv += part_d[((w0 + w) * kSA + slot) * 32 + lane];
      }
      const int nb = slot >> 2, e = slot & 3;
      const int key = 8 * nb + 2 * t + (e & 1);
      const float p = expf(sv * scale - lse_r[e >> 1]);
      const float ds = k0 + key < N ? p * (dpv - dd_r[e >> 1]) : 0.f;
      dsg[(g + 8 * (e >> 1)) * kLdS + key] = __float2bfloat16(ds);
    }
    mma::bar_sync(1 + rg, kW * 32);

    // 3. acc += bf16(ds).k over this warp's columns, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4];
      mma::ldsm_x4(a, ds_lane + kk * 16);
#pragma unroll
      for (int np = 0; np < kPer; ++np) {
        if (kFull || np < nw) {
          uint32_t bt[4];
          mma::ldsm_x4_t(bt, kt + kk * 16 * ld + t_off + np * 16);
          mma::mma_bf16(acc[2 * np], a, bt[0], bt[1]);
          mma::mma_bf16(acc[2 * np + 1], a, bt[2], bt[3]);
        }
      }
    }
  }

  // dq = scale * acc, through this warp's own rows and columns of the K
  // stage the last tile did not use (every warp last read it before that
  // tile's block barrier, and no copy targets it), then 16-byte stores
  bf16* ow = ks + (ntiles & 1) * kBK * ld + rg * 16 * ld + c0;
#pragma unroll
  for (int nb = 0; nb < 2 * kPer; ++nb) {
    if (kFull || nb < 2 * nw) {
      const int c = 8 * nb + 2 * t;
      *reinterpret_cast<uint32_t*>(ow + g * ld + c) =
          mma::pack_bf16(scale * acc[nb][0], scale * acc[nb][1]);
      *reinterpret_cast<uint32_t*>(ow + (g + 8) * ld + c) =
          mma::pack_bf16(scale * acc[nb][2], scale * acc[nb][3]);
    }
  }
  __syncwarp();
  const int chunks = 2 * nw;  // 16-byte pieces of a row in this warp's share
  for (int i = lane; i < 16 * chunks; i += 32) {
    const int r = i / chunks, c = (i - r * chunks) * 8;
    if (row0 + r < N)
      *reinterpret_cast<uint4*>(dq + off + (size_t)(row0 + r) * C + c0 + c) =
          *reinterpret_cast<const uint4*>(ow + r * ld + c);
  }
}

template <int kC, int kW, int kBK, bool kFull>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* dd,
                   void* dq, int B, int N, int C, float scale,
                   cudaStream_t stream) {
  constexpr int kBQ = 16 * (kWarps / kW);
  const size_t smem = smem_bytes<kW, kBK>(C);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_wide_kernel<kC, kW, kBK, kFull>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((N + kBQ - 1) / kBQ, B);
  flash_bwd_dq_wide_kernel<kC, kW, kBK, kFull>
      <<<grid, kThreads, smem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(dd),
          static_cast<bf16*>(dq), N, C, scale);
  return cudaGetLastError();
}

}  // namespace

// As itsd_flash_bwd_dq (csrc/flash_attention_bwd.cu), for bf16 only
// (dtype must be ITSD_BF16): q, k, v, dout, dq: [B, N, C] contiguous bf16;
// lse, dd: [B, N] f32. Needs C % 16 == 0, 256 < C <= 1024 and 16-byte
// aligned q, k, v, dout, dq. Any N >= 1.
// Returns the first CUDA error of the launch, or 0.
extern "C" int itsd_flash_bwd_dq_wide(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* dd,
                                      void* dq, int B, int N, int C,
                                      float scale, int dtype, void* stream) {
  if (dtype != ITSD_BF16 || B <= 0 || B > 65535 || N <= 0 || C <= kMinC ||
      C > kMaxC || C % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the CFG UNet's widths and the flagship's have instantiations of their
  // own; any other width takes the next wider one
  if (C == 512)
    return (int)launch<512, 4, 32, true>(q, k, v, dout, lse, dd, dq, B, N, C,
                                         scale, s);
  if (C == 1024)
    return (int)launch<1024, 8, 16, true>(q, k, v, dout, lse, dd, dq, B, N,
                                          C, scale, s);
  if (C == 384)
    return (int)launch<384, 4, 32, true>(q, k, v, dout, lse, dd, dq, B, N, C,
                                         scale, s);
  if (C <= 512)
    return (int)launch<512, 4, 32, false>(q, k, v, dout, lse, dd, dq, B, N,
                                          C, scale, s);
  return (int)launch<1024, 8, 16, false>(q, k, v, dout, lse, dd, dq, B, N, C,
                                         scale, s);
}
