// Single-head flash attention forward on the tensor cores for wide rows:
// o = softmax(q k^T * scale) v over [B, N, C] in bf16 with
// 256 < C <= 1024, with an optional f32 per-row log-sum-exp [B, N].
//
// Replaces the TPU kernel itsd_tpu/kernels/attention.py:_flash_fwd_kernel
// (launched by _flash_forward for _attention_flash and
// _attention_flash_stats) for bf16 inputs with C % 16 == 0 and
// 256 < C <= 1024: the CFG UNet's C=512 (16x16 and 2x2) and C=1024 (8x8
// and 4x4), and the 256x256 flagship's C=384. Narrower bf16 rows take
// csrc/flash_attention_mma.cu; f32 and every other width the CUDA-core
// kernel of csrc/flash_attention.cu, so that f32 never runs on the tensor
// cores. Same arithmetic as flash_attention_mma.cu: s = (q.k^T summed in
// f32) * scale, an online softmax with f32 running max m, denominator l
// and accumulator, p = exp(s - m) rounded to bf16 for the p.v product only
// (l sums the unrounded p), o = acc / l and lse = m + log(l).
//
// Bound on the card: at the CFG train step's [256, 256, 512] the call
// moves 4 tensors of 67.1 MB (80 us at 3.35 TB/s) and does 2 products of
// 2*B*N^2*C = 17.2 GFLOP (35 us at 989 TFLOP/s), so it is bound by bytes;
// mma.sync with operands through ldmatrix reaches well under the tensor
// cores' peak (wgmma is the full rate), so shared-memory reads and mma
// issue limit it first.
//
// Design. What the narrow kernel cannot do at these widths is hold the
// accumulator: one warp owning 16 rows x C columns would keep C/2 f32 a
// thread (256 at C=512, 512 at C=1024). So the head dimension is split
// across warps: kW warps share a block of 16 query rows (a "row group"),
// each owning a contiguous share of C (C/kW columns, in 16-column steps),
// which keeps the accumulator at 128 floats a thread: kW = 2 at C <= 512,
// 4 above. The scores still need all of C. Each warp multiplies its share
// of q's columns by the same columns of the K tile (a split-K), writes its
// partial 16 x kBK score tile to shared memory in fragment order, and
// after a barrier of the row group's kW warps every one of them adds the
// kW partials in warp order, so that all kW hold the same f32 scores and
// run the same online softmax (m, l and p agree bit for bit). Only the sum
// order of s changes against the narrow kernel: rounding, within the
// tolerances that hold it. p, rounded to bf16, goes from the score
// fragments straight into the A fragments of p.v, with the warp's columns
// of V through ldmatrix.trans.
//
// A block has 8 warps. At C <= 512: 4 row groups (64 query rows) of 2
// warps, keys in tiles of 32, K and V double-buffered with 16-byte
// cp.async copies; shared memory (64 + 4*32) * (C + 8) * 2 B plus 16 KB of
// partials: 216,064 B at C=512. At C <= 1024: 2 row groups (32 rows) of 4
// warps, 16-key tiles, double-buffered: 206,336 B at C=1024. Either way 1
// block an SM and up to 255 registers a thread. Rows are padded by 16
// bytes (C + 8 elements), so the 8 rows an ldmatrix reads lie in 8
// different bank groups. A key tile's copy is issued right after the
// barrier that opens the previous tile (every warp is then done with the
// stage it refills), so it overlaps that tile's products, and a tile takes
// two barriers: the block's, and the row group's around the partials.
// Rows and keys past N are zero-filled by the copies (src-size 0); keys
// past N get s = -inf (p = 0), and only rows below N are written. Each
// warp writes its own rows and columns of the output through the same
// place of the query tile in shared memory (no other warp reads it), so
// that the stores to device memory are 16-byte pieces. The guided eval's
// [16, 256, 512] gives 64 blocks for 132 SMs: under-filled by design.

#include <math.h>

#include "common.cuh"
#include "mma_tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;      // bf16 elements of padding a row (16 B)
constexpr int kMinC = 256;   // C up to this takes flash_attention_mma.cu
constexpr int kMaxC = 1024;

// The query tile, K and V tiles in two stages, and one f32 partial score
// tile (16 x kBK) a warp.
template <int kW, int kBK>
size_t smem_bytes(int C) {
  constexpr int kBQ = 16 * (kWarps / kW);
  return (size_t)(kBQ + 2 * 2 * kBK) * (C + kPad) * sizeof(bf16) +
         (size_t)kWarps * 16 * kBK * sizeof(float);
}

// kC: the largest C this instantiation takes (it sizes the accumulator);
// kW: warps a row group; kBK: keys a tile; kFull: C == kC, fixed at
// compile time, so that index arithmetic folds.
template <int kC, int kW, int kBK, bool kFull, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wide_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse, int N, int c_arg,
                          float scale) {
  constexpr int kRG = kWarps / kW;      // row groups a block
  constexpr int kBQ = 16 * kRG;         // query rows a block
  constexpr int kPer = kC / (16 * kW);  // most 16-column steps a warp owns
  constexpr int kNB = kBK / 8;          // n-blocks of 8 keys a tile
  static_assert(kWarps % kW == 0 && kC % (16 * kW) == 0 && kBK % 16 == 0 &&
                    kC <= kMaxC,
                "bad tiling");
  const int C = kFull ? kC : c_arg;
  const int ld = C + kPad;
  const int ksteps = C / 16;  // 16-column steps of C
  extern __shared__ uint4 smem_wide[];
  bf16* qs = reinterpret_cast<bf16*>(smem_wide);  // [kBQ][ld]
  bf16* ks = qs + kBQ * ld;                       // [2][kBK][ld]
  bf16* vs = ks + 2 * kBK * ld;                   // [2][kBK][ld]
  float4* part =
      reinterpret_cast<float4*>(vs + 2 * kBK * ld);  // [kWarps][kNB][32]

  const int b = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp / kW, wc = warp % kW;
  // this warp's 16-column steps of C, [first, first + nw): the kW shares
  // differ by at most one step (all equal, kPer, when kFull)
  const int first = wc * ksteps / kW;
  const int nw = (wc + 1) * ksteps / kW - first;
  const int c0 = 16 * first;
  const size_t off = (size_t)b * N * C;
  const bf16* kb = k + off;
  const bf16* vb = v + off;

  mma::stage_rows<kBQ, kThreads>(q + off, qs, q0, N, C, ld, tid);
  mma::stage_rows<kBK, kThreads>(kb, ks, 0, N, C, ld, tid);
  mma::stage_rows<kBK, kThreads>(vb, vs, 0, N, C, ld, tid);
  mma::cp_async_commit();

  // This lane's ldmatrix addresses, all within the warp's columns: q as
  // the A operand (the row group's 16 rows), K rows as the k x n operand
  // of s (2 n-blocks of 8 keys a load), V rows transposed as the k x n
  // operand of p.v (2 n-blocks of 8 columns a load).
  const bf16* q_lane =
      qs + (rg * 16 + (lane & 15)) * ld + (lane >> 4) * 8 + c0;
  const int k_off =
      ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8 + c0;
  const int v_off =
      ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8 + c0;
  const float4* group_part = part + rg * kW * kNB * 32 + lane;

  float acc[2 * kPer][4];
#pragma unroll
  for (int nb = 0; nb < 2 * kPer; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
  // rows g and g + 8 of the row group: running max, and this thread's
  // part of the denominator (summed over the quad at the end)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const int ntiles = (N + kBK - 1) / kBK;
  for (int j = 0; j < ntiles; ++j) {
    const int st = j & 1;
    mma::cp_async_wait<0>();
    // tile j has landed, and every warp is done with tile j - 1: its
    // stage and the partials may be written again
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

    // this warp's share of s = q.k^T: its columns of q and of K
    float s[kNB][4];
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kPer; ++kk) {
      if (kFull || kk < nw) {
        uint32_t a[4];
        mma::ldsm_x4(a, q_lane + kk * 16);
#pragma unroll
        for (int np = 0; np < kNB / 2; ++np) {
          uint32_t bk[4];
          mma::ldsm_x4(bk, kt + np * 16 * ld + k_off + kk * 16);
          mma::mma_bf16(s[2 * np], a, bk[0], bk[1]);
          mma::mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
        }
      }
    }
    // the shares, in fragment order (lane-consecutive float4: no bank
    // conflicts), then the row group's sum in warp order
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
      part[(warp * kNB + nb) * 32 + lane] =
          make_float4(s[nb][0], s[nb][1], s[nb][2], s[nb][3]);
    mma::bar_sync(1 + rg, kW * 32);
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      float4 x = group_part[nb * 32];
#pragma unroll
      for (int w = 1; w < kW; ++w) {
        const float4 y = group_part[(w * kNB + nb) * 32];
        x.x += y.x;
        x.y += y.y;
        x.z += y.z;
        x.w += y.w;
      }
      s[nb][0] = x.x;
      s[nb][1] = x.y;
      s[nb][2] = x.z;
      s[nb][3] = x.w;
    }

    // online softmax over the tile; element e of n-block nb is row
    // g + 8 * (e / 2), key k0 + 8 * nb + 2t + e % 2. The first tile always
    // holds a valid key, so m is finite from then on.
    const int k0 = j * kBK;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = k0 + 8 * nb + 2 * t + (e & 1) < N;
        s[nb][e] = valid ? s[nb][e] * scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
      }
    float corr[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nb][e] - m[e >> 1]);  // 0 where s = -inf
        rowsum[e >> 1] += p;
        s[nb][e] = p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rowsum[r];
#pragma unroll
    for (int nb = 0; nb < 2 * kPer; ++nb) {
      acc[nb][0] *= corr[0];
      acc[nb][1] *= corr[0];
      acc[nb][2] *= corr[1];
      acc[nb][3] *= corr[1];
    }

    // acc += bf16(p).v over this warp's columns: p's C fragments are the
    // A fragments, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {
          mma::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          mma::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          mma::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          mma::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < kPer; ++np) {
        if (kFull || np < nw) {
          uint32_t bv[4];
          mma::ldsm_x4_t(bv, vt + kk * 16 * ld + v_off + np * 16);
          mma::mma_bf16(acc[2 * np], a, bv[0], bv[1]);
          mma::mma_bf16(acc[2 * np + 1], a, bv[2], bv[3]);
        }
      }
    }
  }

  // o = acc / l, through this warp's own rows and columns of the query
  // tile (only this warp ever reads them), then 16-byte stores
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  bf16* ow = qs + rg * 16 * ld + c0;
#pragma unroll
  for (int nb = 0; nb < 2 * kPer; ++nb) {
    if (kFull || nb < 2 * nw) {
      const int c = 8 * nb + 2 * t;
      *reinterpret_cast<uint32_t*>(ow + g * ld + c) =
          mma::pack_bf16(acc[nb][0] / l[0], acc[nb][1] / l[0]);
      *reinterpret_cast<uint32_t*>(ow + (g + 8) * ld + c) =
          mma::pack_bf16(acc[nb][2] / l[1], acc[nb][3] / l[1]);
    }
  }
  __syncwarp();
  const int row0 = q0 + rg * 16;
  const int chunks = 2 * nw;  // 16-byte pieces of a row in this warp's share
  for (int i = lane; i < 16 * chunks; i += 32) {
    const int r = i / chunks, c = (i - r * chunks) * 8;
    if (row0 + r < N)
      *reinterpret_cast<uint4*>(o + off + (size_t)(row0 + r) * C + c0 + c) =
          *reinterpret_cast<const uint4*>(ow + r * ld + c);
  }
  if (kLse && wc == 0 && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (row < N) lse[(size_t)b * N + row] = m[r] + logf(l[r]);
    }
  }
}

template <int kC, int kW, int kBK, bool kFull, bool kLse>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int N, int C, float scale,
                   cudaStream_t stream) {
  constexpr int kBQ = 16 * (kWarps / kW);
  const size_t smem = smem_bytes<kW, kBK>(C);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wide_kernel<kC, kW, kBK, kFull, kLse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((N + kBQ - 1) / kBQ, B);
  flash_fwd_wide_kernel<kC, kW, kBK, kFull, kLse>
      <<<grid, kThreads, smem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<bf16*>(o),
          static_cast<float*>(lse), N, C, scale);
  return cudaGetLastError();
}

template <int kC, int kW, int kBK, bool kFull>
cudaError_t dispatch_lse(const void* q, const void* k, const void* v,
                         void* o, void* lse, int B, int N, int C,
                         float scale, cudaStream_t s) {
  return lse ? launch<kC, kW, kBK, kFull, true>(q, k, v, o, lse, B, N, C,
                                                scale, s)
             : launch<kC, kW, kBK, kFull, false>(q, k, v, o, lse, B, N, C,
                                                 scale, s);
}

}  // namespace

// As itsd_flash_attention (csrc/flash_attention.cu), for bf16 only
// (dtype must be ITSD_BF16): q, k, v, o: [B, N, C] contiguous bf16; lse:
// [B, N] f32, or null for the plain forward. Needs C % 16 == 0,
// 256 < C <= 1024, and 16-byte aligned q, k, v, o. Any N >= 1.
// Returns the first CUDA error of the launch, or 0.
extern "C" int itsd_flash_attention_wide(const void* q, const void* k,
                                         const void* v, void* o, void* lse,
                                         int B, int N, int C, float scale,
                                         int dtype, void* stream) {
  if (dtype != ITSD_BF16 || B <= 0 || B > 65535 || N <= 0 || C <= kMinC ||
      C > kMaxC || C % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the CFG UNet's widths and the flagship's have instantiations of their
  // own; any other width takes the next wider one
  if (C == 512)
    return (int)dispatch_lse<512, 2, 32, true>(q, k, v, o, lse, B, N, C,
                                               scale, s);
  if (C == 1024)
    return (int)dispatch_lse<1024, 4, 16, true>(q, k, v, o, lse, B, N, C,
                                                scale, s);
  if (C == 384)
    return (int)dispatch_lse<384, 2, 32, true>(q, k, v, o, lse, B, N, C,
                                               scale, s);
  if (C <= 512)
    return (int)dispatch_lse<512, 2, 32, false>(q, k, v, o, lse, B, N, C,
                                                scale, s);
  return (int)dispatch_lse<1024, 4, 16, false>(q, k, v, o, lse, B, N, C,
                                               scale, s);
}
