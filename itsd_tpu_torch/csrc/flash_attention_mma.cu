// Single-head flash attention forward on the tensor cores with Ampere's
// mma.sync, for bf16: o = softmax(q k^T * scale) v over [B, N, C], with an
// optional f32 per-row log-sum-exp [B, N].
//
// The "mma" route's forward until csrc/flash_attention_hopper.cu (wgmma,
// TMA) took its place; kept under the entry name itsd_flash_attention_mma_sync
// as the same-call yardstick of that kernel. No path routes here: only the
// forced calls of kernels/attention.py:_flash_mma_sync reach it (the CUDA
// tests and chip_smoke.py). It replaced the TPU kernel
// itsd_tpu/kernels/attention.py:_flash_fwd_kernel for bf16 inputs with
// C % 16 == 0 and C <= 256, with the same arithmetic as the Pallas kernel:
// s = (q.k^T summed in f32) * scale, an online softmax
// with f32 running max m, denominator l and accumulator, p = exp(s - m)
// rounded to bf16 for the p.v product only (l sums the unrounded p),
// o = acc / l and lse = m + log(l).
//
// Bound on the card: at the train path's shape (B=128, N=256, C=256) the
// call moves 4 tensors of 16.8 MB (20 us at 3.35 TB/s) and does 2 products
// of 2*B*N^2*C = 8.6 GFLOP (9 us at 989 TFLOP/s), so it is bound by bytes.
// mma.sync reaches well under the card's peak tensor rate on Hopper (wgmma
// is the full rate), and its operands come from shared memory through
// ldmatrix, so this kernel is bound by shared-memory reads and mma issue
// before it reaches the byte bound.
//
// Design: one block of 4 warps per (sample, 64-row query tile); each warp
// owns 16 query rows, the M of an m16n8k16 product. The block's query tile
// is copied once into shared memory as bf16; the keys are walked in tiles
// of 32, K and V double-buffered in shared memory with 16-byte cp.async
// copies, so the next tile's copy overlaps this tile's products. Rows are
// padded by 16 bytes (C + 8 elements), so the 8 rows an ldmatrix reads lie
// in 8 different bank groups. A warp computes its 16x32 score tile with
// mma.sync (q through ldmatrix, K rows through ldmatrix as the k x n
// operand); the online softmax runs on the f32 accumulator fragments, each
// thread holding 2 rows, with the row max and sum over the 4 lanes of a
// quad by shuffle (the sum only once, at the end: the correction factor is
// the same on the 4 lanes). p, rounded to bf16, goes from the score
// fragments straight into the A fragments of p.v, with V through
// ldmatrix.trans; the output accumulator stays in f32 registers (C/2 = 128
// floats a thread at C=256). At C=256 a block takes 99 KB of shared
// memory, so 2 blocks share an SM and a thread may use up to 255
// registers. Rows and keys past N are zero-filled by the copies (src-size
// 0); keys past N get s = -inf (p = 0), and only rows below N are written.
// The output goes through the warp's own rows of the query tile in shared
// memory, so that it is written to device memory in 16-byte pieces.

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
  return (size_t)(kBQ + 2 * 2 * kBK) * (C + kPad) * sizeof(bf16);
}

// kC: the largest C this instantiation takes (it sizes the accumulator);
// kFull: C == kC, fixed at compile time, so that index arithmetic folds.
template <int kC, bool kFull, bool kLse>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         float* __restrict__ lse, int N, int c_arg,
                         float scale) {
  static_assert(kC % 16 == 0 && kC <= kMaxC, "kC: a multiple of 16");
  constexpr int kNB = kC / 8;  // n-blocks of 8 output columns
  const int C = kFull ? kC : c_arg;
  const int ld = C + kPad;
  const int ksteps = C / 16;  // 16-column steps of C
  extern __shared__ uint4 smem_u4[];
  bf16* qs = reinterpret_cast<bf16*>(smem_u4);  // [kBQ][ld]
  bf16* ks = qs + kBQ * ld;                     // [2][kBK][ld]
  bf16* vs = ks + 2 * kBK * ld;                 // [2][kBK][ld]

  const int b = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t off = (size_t)b * N * C;
  const bf16* kb = k + off;
  const bf16* vb = v + off;

  mma::stage_rows<kBQ, kThreads>(q + off, qs, q0, N, C, ld, tid);
  mma::stage_rows<kBK, kThreads>(kb, ks, 0, N, C, ld, tid);
  mma::stage_rows<kBK, kThreads>(vb, vs, 0, N, C, ld, tid);
  mma::cp_async_commit();

  // This lane's ldmatrix addresses: q as the A operand (rows of the
  // warp's 16), K rows as the k x n operand of s (2 n-blocks of 8 keys a
  // load), V rows transposed as the k x n operand of p.v (2 n-blocks of 8
  // columns a load).
  const bf16* q_lane = qs + (warp * 16 + (lane & 15)) * ld + (lane >> 4) * 8;
  const int k_off = ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8;
  const int v_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;

  float acc[kNB][4];
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
  // rows g and g + 8 of the warp's 16: running max, and this thread's
  // part of the denominator (summed over the quad at the end)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const int ntiles = (N + kBK - 1) / kBK;
  for (int j = 0; j < ntiles; ++j) {
    const int st = j & 1;
    if (j + 1 < ntiles) {  // the next tile's copy overlaps this tile
      mma::stage_rows<kBK, kThreads>(kb, ks + (st ^ 1) * kBK * ld,
                                     (j + 1) * kBK, N, C, ld, tid);
      mma::stage_rows<kBK, kThreads>(vb, vs + (st ^ 1) * kBK * ld,
                                     (j + 1) * kBK, N, C, ld, tid);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks + st * kBK * ld;
    const bf16* vt = vs + st * kBK * ld;

    // s = q.k^T: 4 n-blocks of 8 keys
    float s[4][4];
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kC / 16; ++kk) {
      if (kFull || kk < ksteps) {
        uint32_t a[4];
        mma::ldsm_x4(a, q_lane + kk * 16);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bk[4];
          mma::ldsm_x4(bk, kt + np * 16 * ld + k_off + kk * 16);
          mma::mma_bf16(s[2 * np], a, bk[0], bk[1]);
          mma::mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
        }
      }
    }

    // online softmax over the tile; element e of n-block nb is row
    // g + 8 * (e / 2), key k0 + 8 * nb + 2t + e % 2. The first tile always
    // holds a valid key, so m is finite from then on.
    const int k0 = j * kBK;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
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
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nb][e] - m[e >> 1]);  // 0 where s = -inf
        rowsum[e >> 1] += p;
        s[nb][e] = p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rowsum[r];
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      acc[nb][0] *= corr[0];
      acc[nb][1] *= corr[0];
      acc[nb][2] *= corr[1];
      acc[nb][3] *= corr[1];
    }

    // acc += bf16(p).v: p's C fragments are the A fragments, 16 keys a step
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
          uint32_t bv[4];
          mma::ldsm_x4_t(bv, vt + kk * 16 * ld + v_off + np * 16);
          mma::mma_bf16(acc[2 * np], a, bv[0], bv[1]);
          mma::mma_bf16(acc[2 * np + 1], a, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  // o = acc / l, through the warp's own 16 rows of the query tile (after
  // the loop's last barrier no warp reads them), then 16-byte stores
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  bf16* ow = qs + warp * 16 * ld;
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb) {
    if (kFull || nb < 2 * ksteps) {
      const int c = 8 * nb + 2 * t;
      *reinterpret_cast<uint32_t*>(ow + g * ld + c) =
          mma::pack_bf16(acc[nb][0] / l[0], acc[nb][1] / l[0]);
      *reinterpret_cast<uint32_t*>(ow + (g + 8) * ld + c) =
          mma::pack_bf16(acc[nb][2] / l[1], acc[nb][3] / l[1]);
    }
  }
  __syncwarp();
  const int row0 = q0 + warp * 16;
  const int chunks = C / 8;
  for (int i = lane; i < 16 * chunks; i += 32) {
    const int r = i / chunks, c = (i - r * chunks) * 8;
    if (row0 + r < N)
      *reinterpret_cast<uint4*>(o + off + (size_t)(row0 + r) * C + c) =
          *reinterpret_cast<const uint4*>(ow + r * ld + c);
  }
  if (kLse && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (row < N) lse[(size_t)b * N + row] = m[r] + logf(l[r]);
    }
  }
}

template <int kC, bool kFull, bool kLse>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int N, int C, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(C);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<kC, kFull, kLse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((N + kBQ - 1) / kBQ, B);
  flash_fwd_mma_kernel<kC, kFull, kLse><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), N, C, scale);
  return cudaGetLastError();
}

template <int kC, bool kFull>
cudaError_t dispatch_lse(const void* q, const void* k, const void* v,
                         void* o, void* lse, int B, int N, int C,
                         float scale, cudaStream_t s) {
  return lse ? launch<kC, kFull, true>(q, k, v, o, lse, B, N, C, scale, s)
             : launch<kC, kFull, false>(q, k, v, o, lse, B, N, C, scale, s);
}

}  // namespace

// As itsd_flash_attention (csrc/flash_attention.cu), for bf16 only
// (dtype must be ITSD_BF16): q, k, v, o: [B, N, C] contiguous bf16; lse:
// [B, N] f32, or null for the plain forward. Needs C % 16 == 0, C <= 256,
// and 16-byte aligned q, k, v, o. Any N >= 1.
// Returns the first CUDA error of the launch, or 0.
extern "C" int itsd_flash_attention_mma_sync(const void* q, const void* k,
                                             const void* v, void* o,
                                             void* lse, int B, int N, int C,
                                             float scale, int dtype,
                                             void* stream) {
  if (dtype != ITSD_BF16 || B <= 0 || B > 65535 || N <= 0 || C <= 0 ||
      C > kMaxC || C % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 256) return (int)dispatch_lse<256, true>(q, k, v, o, lse, B, N, C,
                                                    scale, s);
  if (C <= 64) return (int)dispatch_lse<64, false>(q, k, v, o, lse, B, N, C,
                                                   scale, s);
  if (C <= 128) return (int)dispatch_lse<128, false>(q, k, v, o, lse, B, N, C,
                                                     scale, s);
  return (int)dispatch_lse<256, false>(q, k, v, o, lse, B, N, C, scale, s);
}
