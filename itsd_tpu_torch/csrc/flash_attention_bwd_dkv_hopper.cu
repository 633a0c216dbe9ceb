// Single-head flash attention backward, dk and dv, on Hopper's tensor cores
// (wgmma, TMA, mbarriers), for bf16 over [B, N, C]. The entry point of the
// "mma" route's dk/dv.
//
// Replaces the TPU kernel itsd_tpu/kernels/attention.py:_flash_bwd_dkv_kernel
// (launched by _attention_flash_bwd) for bf16 inputs with C % 16 == 0 and
// C <= 256; wider bf16 rows take csrc/flash_attention_bwd_wide.cu, f32
// inputs and other widths the CUDA-core kernel of
// csrc/flash_attention_bwd.cu. Same arithmetic as the Pallas kernel:
// s = q.k^T summed in f32, p = exp(s * scale - lse) from the forward's
// per-row log-sum-exp (taken base 2 in one fused multiply-add: exp2(s *
// scale * log2(e) - lse * log2(e))), dp = dO.v^T in f32,
// ds = p * (dp - dd) with dd = rowsum(dO * O) - dlse taken by the caller
// and p unrounded, then dv = p^T.dO and dk = scale * ds^T.q with p and ds
// rounded to bf16 for those products only and all sums in f32; dk is
// scaled once, at the end (the Pallas kernel scales each tile's partial
// sum, which differs only by f32 rounding). Each key row belongs to one
// block, which walks all the queries, so no sum crosses blocks and there
// are no atomics: the gradients are the same from run to run.
//
// Bound on the card: at the CFG UNet's shape (B=256, N=1024, C=128) the
// call does 4 products of 2*B*N^2*C = 137 GFLOP (0.139 ms at 989 TFLOP/s)
// and moves 6 tensors of 67 MB plus lse and dd (0.121 ms at 3.35 TB/s):
// bound by operations, which Hopper reaches only through wgmma. The earlier
// kernel (flash_attention_bwd_mma.cu, kept as itsd_flash_bwd_dkv_mma_sync)
// took 11x its bound there on mma.sync.
//
// Design: one block per (sample, 64-key tile) of two consumer warpgroups,
// both over the same 64 keys (the M of every product), and a producer
// warpgroup, which gives its registers to the consumers (setmaxnreg: 24 a
// thread against 240). The block's K and V are copied once by TMA and stay
// in shared memory; the producer's thread 0 brings the query tiles (64
// rows of q and dO, and their lse and dd) through a ring of stages (4 at
// C <= 128, 3 at C <= 192, 2 at C <= 256: as many as shared memory holds),
// with 3-D tensor maps [B][N][C] in the 128-byte swizzle for q and dO and
// 1-D maps over the [B*N] rows of lse and dd (a box of 68 rows from the
// tile's first row rounded down to a multiple of 4, since TMA starts a
// box on 16 bytes), each stage completing on an mbarrier. A stage is
// refilled once all 8 consumer warps have arrived on its "empty" barrier;
// the consumers never wait for the producer beyond the data itself. dk and
// dv for 64 keys at C=256 are 256 f32 a thread in one warpgroup, too many,
// so the work is split by output, each warpgroup with 2 products and kC/2
// accumulator registers:
//   warpgroup 0: s^T = K.q^T (wgmma m64n64k16, K and q K-major), p^T in f32
//   (0 for queries past N), p^T written to shared memory for warpgroup 1,
//   and dv += p^T.dO with bf16(p^T) from the score fragments as the A
//   registers and dO read MN-major (wgmma m64n{kC}k16, the transpose bit);
//   warpgroup 1: dp^T = V.dO^T, then, once warpgroup 0 has written p^T
//   (named barriers, one buffer: warpgroup 0 waits before overwriting it
//   until warpgroup 1 has read it), ds^T = p^T * (dp^T - dd) (0 past N) and
//   dk += bf16(ds^T).q with q read MN-major.
// The same q and dO tiles are read K-major by one product and MN-major by
// the other. C is padded to the next multiple of 64 (kC) and fixed at
// compile time; the columns past C arrive as zeros. After the loop each
// warpgroup writes its result in bf16 (dk times scale) into the tile it
// alone read (dv into K's, dk into V's) and stores it by TMA, which writes
// no key past N and no column past C. The lse and dd of a tile's columns
// are read and the exponentials computed whatever the column, and a
// column past N is dropped by a select: a branch around each element
// would make every shared-memory read wait in turn, and the kernel took
// twice as long that way. Shared memory at C=256: 213 KB, one block an
// SM. A small N takes fewer stages (one per query tile), laid out at run
// time.

#include <math.h>

#include <algorithm>

#include "common.cuh"
#include "hopper_tiles.cuh"

namespace {

using hopper::smem_addr;

constexpr int kMaxC = 256;
constexpr int kThreads = 384;  // two consumer warpgroups, a producer one
// Registers a thread after the shift: the producer warpgroup keeps few,
// each consumer thread takes up to 240 (3 warps a scheduler: 24 + 2 * 240
// of its 512 a lane)
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kBKey = 64;      // keys a block
constexpr int kBQ = 64;        // queries a tile
constexpr int kLdP = kBQ + 8;  // f32 row of the p^T tile (conflict-free)
// A tile's lse (or dd) box: TMA needs a 16-byte aligned start in the
// innermost dimension, so the box starts at the row index rounded down to
// a multiple of 4 and holds 4 more rows; the tile's rows begin `lead` in.
// Each box lands on a 128-byte boundary (kRowStride floats apart), as TMA
// needs.
constexpr int kRowBox = kBQ + 4;
constexpr int kRowStride = 96;
constexpr float kLog2e = 1.4426950408889634f;
// named barriers (0 is __syncthreads'): each warpgroup's own, and the p^T
// buffer's "written" and "read"
constexpr int kBarWG = 1, kBarPFull = 3, kBarPEmpty = 4;

template <int kC>
struct Tile {
  // q/dO/lse/dd ring: as deep as shared memory allows
  static constexpr int kStages = kC <= 128 ? 4 : kC <= 192 ? 3 : 2;
  static constexpr int kBytes = 64 * kC * 2;  // one [64][kC] bf16 tile
  static constexpr int kRows = kRowBox * 4;   // bytes of an lse (dd) box
  // K, V, nst q, nst dO (each 1024-byte aligned), nst lse, nst dd, p^T
  // [64][kLdP] f32, then the barriers: K/V, nst full, nst empty
  static int smem(int nst) {  // with a ring of nst stages
    return 1024 + (2 + 2 * nst) * kBytes + 2 * nst * kRowStride * 4 +
           kBKey * kLdP * 4 + 8 * (1 + 2 * nst);
  }
};

template <int kC>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_hopper_kernel(const __grid_constant__ CUtensorMap qmap,
                                const __grid_constant__ CUtensorMap kmap,
                                const __grid_constant__ CUtensorMap vmap,
                                const __grid_constant__ CUtensorMap domap,
                                const __grid_constant__ CUtensorMap lsemap,
                                const __grid_constant__ CUtensorMap ddmap,
                                const __grid_constant__ CUtensorMap dkmap,
                                const __grid_constant__ CUtensorMap dvmap,
                                int N, float scale, float scale_log2) {
  using T = Tile<kC>;
  constexpr int kCB = kC / 64;  // 64-column blocks
  const int ntiles = (N + kBQ - 1) / kBQ;
  const int nst = min(T::kStages, ntiles);  // stages of the ring
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* ks = smem;                            // [kCB][64][64]
  uint8_t* vs = ks + T::kBytes;                  // [kCB][64][64]
  uint8_t* qs = vs + T::kBytes;                  // [nst][kCB][64][64]
  uint8_t* dos = qs + nst * T::kBytes;           // [nst][kCB][64][64]
  float* lse_s = reinterpret_cast<float*>(dos + nst * T::kBytes);
  float* dd_s = lse_s + nst * kRowStride;        // [nst][kRowStride]
  float* pt = dd_s + nst * kRowStride;           // [kBKey][kLdP]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(pt + kBKey * kLdP);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + nst;

  const int b = blockIdx.y, k0 = blockIdx.x * kBKey;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const long long row_base = (long long)b * N;  // of this sample in lse, dd

  if (tid == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < nst; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // the producer: K and V, then q, dO, lse and dd of query tile j into
    // stage j % nst once all 8 consumer warps have released the tile that
    // held it before
    hopper::regs_dec<kProducerRegs>();
    if (tid == 256) {
      hopper::mbar_expect_tx(kv_full, 2 * T::kBytes);
#pragma unroll
      for (int cb = 0; cb < kCB; ++cb) {
        hopper::tma_load_3d(ks + cb * 64 * 128, &kmap, kv_full, cb * 64, k0,
                            b);
        hopper::tma_load_3d(vs + cb * 64 * 128, &vmap, kv_full, cb * 64, k0,
                            b);
      }
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % nst;
        if (j >= nst) hopper::mbar_wait(&empty[s], (j / nst - 1) & 1);
        hopper::mbar_expect_tx(&full[s], 2 * T::kBytes + 2 * T::kRows);
#pragma unroll
        for (int cb = 0; cb < kCB; ++cb) {
          hopper::tma_load_3d(qs + s * T::kBytes + cb * 64 * 128, &qmap,
                              &full[s], cb * 64, j * kBQ, b);
          hopper::tma_load_3d(dos + s * T::kBytes + cb * 64 * 128, &domap,
                              &full[s], cb * 64, j * kBQ, b);
        }
        const int row0 = (int)(row_base + j * kBQ) & ~3;
        hopper::tma_load_1d(lse_s + s * kRowStride, &lsemap, &full[s], row0);
        hopper::tma_load_1d(dd_s + s * kRowStride, &ddmap, &full[s], row0);
      }
    }
    return;
  }
  hopper::regs_inc<kConsumerRegs>();

  // dv (warpgroup 0) or the unscaled dk (warpgroup 1) of the thread's rows
  // (keys warp * 16 + g and + 8)
  float acc[kC / 2];
#pragma unroll
  for (int i = 0; i < kC / 2; ++i) acc[i] = 0.f;
  uint8_t* own = wg == 0 ? ks : vs;  // A of the first product, then the output
  const uint32_t a_first = smem_addr(own);

  hopper::mbar_wait(kv_full, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % nst;
    const uint32_t phase = (j / nst) & 1;
    const uint32_t qa = smem_addr(qs + s * T::kBytes);
    const uint32_t da = smem_addr(dos + s * T::kBytes);
    // warpgroup 0 reads q K-major, then dO MN-major; warpgroup 1 the other
    // way round
    const uint32_t b_first = wg == 0 ? qa : da;
    const uint32_t b_second = wg == 0 ? da : qa;

    // s^T = K.q^T (warpgroup 0) or dp^T = V.dO^T (warpgroup 1), unscaled
    float sc[kBQ / 2];
#pragma unroll
    for (int i = 0; i < kBQ / 2; ++i) sc[i] = 0.f;
    hopper::mbar_wait(&full[s], phase);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kC / 16; ++kk)
      hopper::mma_ss<kBQ>(sc, hopper::desc_k(a_first, 64, kk / 4, kk % 4),
                          hopper::desc_k(b_first, 64, kk / 4, kk % 4), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // element e of 8-query block nb is key row warp * 16 + g + 8 * (e / 2),
    // query column 8 * nb + 2t + e % 2 of the tile
    const int qend = N - j * kBQ;  // queries of this tile below N
    const int lead = (int)(row_base + j * kBQ) & 3;
    const float* lse_t = lse_s + s * kRowStride + lead;
    const float* dd_t = dd_s + s * kRowStride + lead;
    float* prow0 = pt + (warp * 16 + g) * kLdP + 2 * t;
    float* prow1 = prow0 + 8 * kLdP;
    // the thread's 16 columns' lse (times log2(e)) or dd, read whatever
    // the column (the box holds 68 rows: a column past N reads a finite
    // row or a zero), so that no load waits behind a branch; a column past
    // N is then dropped by a select
    float row[kBQ / 8][2];
#pragma unroll
    for (int nb = 0; nb < kBQ / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        row[nb][e] = wg == 0 ? lse_t[8 * nb + 2 * t + e] * kLog2e
                             : dd_t[8 * nb + 2 * t + e];
    if (wg == 0) {
#pragma unroll
      for (int nb = 0; nb < kBQ / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * nb + 2 * t + (e & 1);
          const float p = hopper::exp2_ftz(
              fmaf(sc[4 * nb + e], scale_log2, -row[nb][e & 1]));
          sc[4 * nb + e] = col < qend ? p : 0.f;
        }
      if (j > 0) hopper::bar_sync(kBarPEmpty, 256);  // tile j-1's p^T read
#pragma unroll
      for (int nb = 0; nb < kBQ / 8; ++nb) {
        *reinterpret_cast<float2*>(prow0 + 8 * nb) =
            make_float2(sc[4 * nb], sc[4 * nb + 1]);
        *reinterpret_cast<float2*>(prow1 + 8 * nb) =
            make_float2(sc[4 * nb + 2], sc[4 * nb + 3]);
      }
      hopper::bar_arrive(kBarPFull, 256);
    } else {
      hopper::bar_sync(kBarPFull, 256);
      float p[kBQ / 8][4];
#pragma unroll
      for (int nb = 0; nb < kBQ / 8; ++nb) {
        const float2 p0 = *reinterpret_cast<const float2*>(prow0 + 8 * nb);
        const float2 p1 = *reinterpret_cast<const float2*>(prow1 + 8 * nb);
        p[nb][0] = p0.x;
        p[nb][1] = p0.y;
        p[nb][2] = p1.x;
        p[nb][3] = p1.y;
      }
      if (j + 1 < ntiles) hopper::bar_arrive(kBarPEmpty, 256);
#pragma unroll
      for (int nb = 0; nb < kBQ / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * nb + 2 * t + (e & 1);
          const float ds = p[nb][e] * (sc[4 * nb + e] - row[nb][e & 1]);
          sc[4 * nb + e] = col < qend ? ds : 0.f;
        }
    }

    // dv += bf16(p^T).dO or dk += bf16(ds^T).q, 16 queries a step
    uint32_t pa[kBQ / 16][4];
#pragma unroll
    for (int q16 = 0; q16 < kBQ / 16; ++q16)
      hopper::a_from_acc(pa[q16], sc, q16);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int q16 = 0; q16 < kBQ / 16; ++q16)
      hopper::mma_rs<kC>(acc, pa[q16], hopper::desc_mn(b_second, 64, q16));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

  // dv, or dk = scale * sum, in bf16 into the K (V) tile, which only this
  // warpgroup read, then one TMA store per column block
  hopper::bar_sync(kBarWG + wg, 128);
  const float mul = wg == 0 ? 1.f : scale;
  hopper::acc_to_tile<kC>(own, acc, mul, mul, false);
  hopper::fence_proxy_async();
  hopper::bar_sync(kBarWG + wg, 128);
  if ((tid & 127) == 0) {
#pragma unroll
    for (int cb = 0; cb < kCB; ++cb)
      hopper::tma_store_3d(wg == 0 ? &dvmap : &dkmap, own + cb * 64 * 128,
                           cb * 64, k0, b);
    hopper::tma_store_wait();
  }
}

template <int kC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* dd,
                   void* dk, void* dv, int B, int N, int C, float scale,
                   cudaStream_t stream) {
  using T = Tile<kC>;
  static unsigned long long done = 0;
  cudaError_t e = hopper::smem_limit_once(flash_bwd_dkv_hopper_kernel<kC>,
                                          T::smem(T::kStages), &done);
  if (e != cudaSuccess) return e;
  CUtensorMap qm, km, vm, dom, lm, ddm, dkm, dvm;
  const long long rows = (long long)B * N;
  if ((e = hopper::map_bnc(&qm, q, B, N, C, kBQ)) != cudaSuccess ||
      (e = hopper::map_bnc(&km, k, B, N, C, kBKey)) != cudaSuccess ||
      (e = hopper::map_bnc(&vm, v, B, N, C, kBKey)) != cudaSuccess ||
      (e = hopper::map_bnc(&dom, dout, B, N, C, kBQ)) != cudaSuccess ||
      (e = hopper::map_f32(&lm, lse, rows, kRowBox)) != cudaSuccess ||
      (e = hopper::map_f32(&ddm, dd, rows, kRowBox)) != cudaSuccess ||
      (e = hopper::map_bnc(&dkm, dk, B, N, C, kBKey)) != cudaSuccess ||
      (e = hopper::map_bnc(&dvm, dv, B, N, C, kBKey)) != cudaSuccess)
    return e;
  const int nst = std::min(T::kStages, (N + kBQ - 1) / kBQ);
  dim3 grid((N + kBKey - 1) / kBKey, B);
  flash_bwd_dkv_hopper_kernel<kC><<<grid, kThreads, T::smem(nst), stream>>>(
      qm, km, vm, dom, lm, ddm, dkm, dvm, N, scale, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// As itsd_flash_bwd_dkv (csrc/flash_attention_bwd.cu), for bf16 only
// (dtype must be ITSD_BF16): q, k, v, dout, dk, dv: [B, N, C] contiguous
// bf16; lse, dd: [B, N] f32. Needs C % 16 == 0, C <= 256, B <= 65535,
// 16-byte aligned q, k, v, dout, dk, dv, lse and dd, and B * N < 2^31.
// Any N >= 1. Returns the first CUDA error of the tensor maps' encoding or
// the launch, or 0.
extern "C" int itsd_flash_bwd_dkv_mma(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* dd,
                                      void* dk, void* dv, int B, int N, int C,
                                      float scale, int dtype, void* stream) {
  if (dtype != ITSD_BF16 || B <= 0 || B > 65535 || N <= 0 || C <= 0 ||
      C > kMaxC || C % 16 != 0 || (long long)B * N >= (1ll << 31) - kBQ)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hopper::padded_c(C)) {
    case 64:
      return (int)launch<64>(q, k, v, dout, lse, dd, dk, dv, B, N, C, scale,
                             s);
    case 128:
      return (int)launch<128>(q, k, v, dout, lse, dd, dk, dv, B, N, C, scale,
                              s);
    case 192:
      return (int)launch<192>(q, k, v, dout, lse, dd, dk, dv, B, N, C, scale,
                              s);
    default:
      return (int)launch<256>(q, k, v, dout, lse, dd, dk, dv, B, N, C, scale,
                              s);
  }
}
