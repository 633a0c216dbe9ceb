// Single-head flash attention backward, dq, on Hopper's tensor cores
// (wgmma, TMA, mbarriers), for bf16 over [B, N, C]. The entry point of the
// "mma" route's dq.
//
// Replaces the TPU kernel itsd_tpu/kernels/attention.py:_flash_bwd_dq_kernel
// (launched by _attention_flash_bwd) for bf16 inputs with C % 16 == 0 and
// C <= 256; wider bf16 rows take csrc/flash_attention_bwd_dq_wide.cu, f32
// inputs and other widths the CUDA-core kernel of
// csrc/flash_attention_bwd.cu. Same arithmetic as the Pallas kernel:
// s = q.k^T summed in f32, p = exp(s * scale - lse) from the forward's
// per-row log-sum-exp (taken base 2 in one fused multiply-add: exp2(s *
// scale * log2(e) - lse * log2(e))), dp = dO.v^T in f32, ds = p * (dp - dd)
// with dd = rowsum(dO * O) - dlse taken by the caller, then dq = scale *
// ds.k with ds rounded to bf16 for that product only and the sum in f32;
// dq is scaled once, at the end (the Pallas kernel scales each tile's
// partial sum, which differs only by f32 rounding). Each query row belongs
// to one block, which walks all the keys, so no sum crosses blocks and
// there are no atomics: dq is the same from run to run.
//
// Bound on the card: at the CFG UNet's shape (B=256, N=1024, C=128) the
// call does 3 products of 2*B*N^2*C = 103 GFLOP (0.104 ms at 989 TFLOP/s)
// and moves 5 tensors of 67 MB plus lse and dd (0.101 ms at 3.35 TB/s):
// bound by operations, which Hopper reaches only through wgmma. The earlier
// kernel (flash_attention_bwd_dq_mma.cu, kept as
// itsd_flash_bwd_dq_mma_sync) took 7.7x its bound there on mma.sync.
//
// Design: dq owns query rows, as the forward does, so the block is the
// forward's (csrc/flash_attention_hopper.cu): two consumer warpgroups, each
// owning 64 query rows (the M of a wgmma), and a producer warpgroup, which
// gives its registers to the consumers (setmaxnreg: 24 a thread against
// 240) and whose thread 0 issues every copy through TMA with 3-D tensor
// maps [B][N][C] in the 128-byte swizzle: the block's q and dO tiles once,
// then K and V tiles of 64 keys through rings of stages, each copy
// completing on an mbarrier (K and V on barriers of their own, so that
// s = q.k^T starts before V has landed and V's stage is refilled as soon
// as dp is done, while K's is held until ds.k is). The producer refills a
// stage once every consumer warp has released it; the consumers never wait
// for it beyond the data itself. Each consumer reads the lse and dd of its
// two rows once, from memory. Per key tile a warpgroup issues s = q.k^T and
// dp = dO.v^T as two chains of wgmma m64n64k16 (q, K, dO and V all K-major
// from shared memory), computes p and ds on the score fragments (a key
// past N dropped by a select: a branch around each element would make
// every read wait in turn, which halved dk/dv's speed), packs ds to bf16
// straight into the A registers, and issues dq += ds.K as wgmma
// m64n{kC}k16 with K read MN-major (the transpose bit) from the same
// stage. The two warpgroups are independent, so one's products run on the
// tensor cores while the other computes its exponentials. C is padded to
// the next multiple of 64 (kC) and fixed at compile time: the columns past
// C arrive as zeros, so no guard or runtime width is left in the loops.
// dq (scale * acc in bf16) is written into the warpgroup's own q tile in
// the swizzled layout and stored by TMA, which writes no row past N and no
// column past C.
//
// Budgets. Shared memory: the q and dO tiles of 128 rows take 4 * 64 * kC
// * 2 bytes (128 KB at C=256) and a K or a V stage of 64 keys 64 * kC * 2
// (32 KB at C=256). At C=256 two K stages and one V stage fit (224 KB of
// the 227 KB a block may hold): V is free again first, so its single stage
// is refilled while the warpgroups compute ds and ds.K, and K's second
// stage holds the next tile. C <= 128 holds 4 stages of each (192 KB at
// C=128), C=192 3 of K and 2 of V (216 KB). Registers: the dq accumulator
// is kC / 2 f32 a thread (128 at C=256), s and dp 32 each, the packed ds
// 16: ~210 of the 240 a consumer thread holds. Issuing the next tile's s
// and dp before this tile's ds.K (FlashAttention-3's pipelining) would keep
// them all live at once; instead the two warpgroups give the overlap. When
// N <= 64 one warpgroup holds every row: the block has one consumer
// warpgroup, and a small N takes fewer stages (one per key tile), laid out
// at run time.
//
// Small N. With N <= 64 a block holds one sample, and the card one such
// block an SM (registers), so B > 132 samples take more than one wave of
// blocks: the CFG UNet's [256, 1, 256] took two waves of blocks that each
// did one row's work, slower than the mma.sync kernel. There (kPacked) the
// [B, N, C] tensors are read as [1, B * N, C], a tile holds the rows of S
// whole samples (R = S * N rows, S = ceil(B / 132) up to 64 / N: as few as
// bring the grid to one wave, since a block that loads more rows takes
// longer), its own rows are its only key tile, and a key counts for a
// query only when both belong to one sample (a block-diagonal mask,
// applied by the same select as the keys past the end); dq is stored R
// rows a block.

#include <math.h>

#include <algorithm>

#include "common.cuh"
#include "hopper_tiles.cuh"

namespace {

using hopper::smem_addr;

constexpr int kMaxC = 256;
constexpr int kMaxWG = 2;  // consumer warpgroups a block, 64 query rows each
constexpr int kMaxThreads = (kMaxWG + 1) * 128;  // and the producer's
// Registers a thread after the shift: the producer warpgroup keeps few,
// each consumer thread takes up to 240 (3 warps a scheduler: 24 + 2 * 240
// of its 512 a lane)
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kBK = 64;  // keys a tile
constexpr float kLog2e = 1.4426950408889634f;
// named barrier of each warpgroup (0 is __syncthreads')
constexpr int kBarWG = 1;

template <int kC>
struct Tile {
  // K and V rings: as deep as shared memory allows (see the note above)
  static constexpr int kKStages = kC <= 128 ? 4 : kC <= 192 ? 3 : 2;
  static constexpr int kVStages = kC <= 128 ? 4 : kC <= 192 ? 2 : 1;
  static constexpr int kBytes = 64 * kC * 2;  // one [64][kC] bf16 tile
  // nwg q tiles, nwg dO tiles, nk K tiles, nv V tiles (each 1024-byte
  // aligned), then the barriers: q, nk each of K full and empty, nv each
  // of V full and empty
  static int smem(int nwg, int nk, int nv) {
    return 1024 + (2 * nwg + nk + nv) * kBytes + 8 * (1 + 2 * nk + 2 * nv);
  }
};

// The block: nwg consumer warpgroups (1 when N <= 64, else 2; blockDim.x =
// 128 * (nwg + 1)), then the producer warpgroup, whose thread 0 issues
// every copy.
// kPacked: the rows of samples of `seq` rows each, R = `block_rows` a block
// (see the note above); else `block_rows` = 64 * nwg.
template <int kC, bool kPacked>
__global__ void __launch_bounds__(kMaxThreads, 1)
    flash_bwd_dq_hopper_kernel(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               const __grid_constant__ CUtensorMap domap,
                               const __grid_constant__ CUtensorMap dqmap,
                               const float* __restrict__ lse,
                               const float* __restrict__ dd, int N, int seq,
                               int block_rows, float scale,
                               float scale_log2) {
  using T = Tile<kC>;
  constexpr int kCB = kC / 64;  // 64-column blocks
  const int nwg = blockDim.x / 128 - 1;
  const int ntiles = kPacked ? 1 : (N + kBK - 1) / kBK;
  const int nk = min(T::kKStages, ntiles), nv = min(T::kVStages, ntiles);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;                    // [nwg][kCB][64][64]
  uint8_t* dos = qs + nwg * T::kBytes;   // [nwg][kCB][64][64]
  uint8_t* ks = dos + nwg * T::kBytes;   // [nk][kCB][64][64]
  uint8_t* vs = ks + nk * T::kBytes;     // [nv][kCB][64][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + nv * T::kBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + nk;
  uint64_t* v_full = k_empty + nk;
  uint64_t* v_empty = v_full + nv;

  const int b = blockIdx.y, q0 = blockIdx.x * block_rows;
  // the first row of key tile j: a packed tile's own rows
  auto key0 = [&](int j) { return kPacked ? q0 : j * kBK; };
  const int tid = threadIdx.x, wg = tid >> 7;
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  // warpgroups with a query row below N (the second one idles when N - q0
  // <= 64)
  const int active = min(nwg, (N - q0 + 63) / 64);

  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < nk; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&k_empty[s], 4 * active);
    }
    for (int s = 0; s < nv; ++s) {
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&v_empty[s], 4 * active);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == nwg) {
    // the producer: the q and dO tiles, then K (V) of key tile j into
    // stage j % nk (j % nv), each once every consumer warp has released
    // the K (V) of the tile that held it before
    hopper::regs_dec<kProducerRegs>();
    if (tid == 128 * nwg) {
      hopper::mbar_expect_tx(q_full, 2 * active * T::kBytes);
      for (int w = 0; w < active; ++w)
#pragma unroll
        for (int cb = 0; cb < kCB; ++cb) {
          hopper::tma_load_3d(qs + w * T::kBytes + cb * 64 * 128, &qmap,
                              q_full, cb * 64, q0 + 64 * w, b);
          hopper::tma_load_3d(dos + w * T::kBytes + cb * 64 * 128, &domap,
                              q_full, cb * 64, q0 + 64 * w, b);
        }
      for (int j = 0; j < ntiles; ++j) {
        const int sk = j % nk, sv = j % nv;
        if (j >= nk) hopper::mbar_wait(&k_empty[sk], (j / nk - 1) & 1);
        hopper::mbar_expect_tx(&k_full[sk], T::kBytes);
#pragma unroll
        for (int cb = 0; cb < kCB; ++cb)
          hopper::tma_load_3d(ks + sk * T::kBytes + cb * 64 * 128, &kmap,
                              &k_full[sk], cb * 64, key0(j), b);
        if (j >= nv) hopper::mbar_wait(&v_empty[sv], (j / nv - 1) & 1);
        hopper::mbar_expect_tx(&v_full[sv], T::kBytes);
#pragma unroll
        for (int cb = 0; cb < kCB; ++cb)
          hopper::tma_load_3d(vs + sv * T::kBytes + cb * 64 * 128, &vmap,
                              &v_full[sv], cb * 64, key0(j), b);
      }
    }
    return;
  }
  hopper::regs_inc<kConsumerRegs>();
  if (wg >= active) return;

  // lse (times log2(e)) and dd of the thread's rows g and g + 8 of its
  // warp's 16 (0 past N: those rows arrive as zeros and are not written)
  const int row0 = q0 + 64 * wg;
  float lse2[2], ddr[2];
  int sample[2];  // kPacked: the sample of each row, within the tile
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + g + 8 * r;
    const size_t at = (size_t)b * N + row;
    lse2[r] = row < N ? lse[at] * kLog2e : 0.f;
    ddr[r] = row < N ? dd[at] : 0.f;
    sample[r] = kPacked ? (warp * 16 + g + 8 * r) / seq : 0;
  }

  float acc[kC / 2];  // the unscaled dq of the thread's rows
#pragma unroll
  for (int i = 0; i < kC / 2; ++i) acc[i] = 0.f;
  uint8_t* qt = qs + wg * T::kBytes;
  const uint32_t qa = smem_addr(qt);
  const uint32_t da = smem_addr(dos + wg * T::kBytes);

  hopper::mbar_wait(q_full, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int sk = j % nk, sv = j % nv;
    const uint32_t ka = smem_addr(ks + sk * T::kBytes);
    const uint32_t va = smem_addr(vs + sv * T::kBytes);

    // s = q.K^T and dp = dO.V^T, unscaled, each its own group
    float sc[kBK / 2], dp[kBK / 2];
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) sc[i] = dp[i] = 0.f;
    hopper::mbar_wait(&k_full[sk], (j / nk) & 1);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kC / 16; ++kk)
      hopper::mma_ss<kBK>(sc, hopper::desc_k(qa, 64, kk / 4, kk % 4),
                          hopper::desc_k(ka, 64, kk / 4, kk % 4), kk > 0);
    hopper::wgmma_commit();
    hopper::mbar_wait(&v_full[sv], (j / nv) & 1);
#pragma unroll
    for (int kk = 0; kk < kC / 16; ++kk)
      hopper::mma_ss<kBK>(dp, hopper::desc_k(da, 64, kk / 4, kk % 4),
                          hopper::desc_k(va, 64, kk / 4, kk % 4), kk > 0);
    hopper::wgmma_commit();

    // element e of 8-key block nb is row g + 8 * (e / 2), key
    // 8 * nb + 2t + e % 2 of the tile; p while dp is still running
    hopper::wgmma_wait<1>();
    hopper::fence_regs(sc);
#pragma unroll
    for (int nb = 0; nb < kBK / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[4 * nb + e] = hopper::exp2_ftz(
            fmaf(sc[4 * nb + e], scale_log2, -lse2[e >> 1]));
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dp);
    if (lane == 0) hopper::mbar_arrive(&v_empty[sv]);
    // ds = p * (dp - dd); a key past N (its K and V rows arrive as zeros,
    // which would give ds = -p * dd), or of another sample, is dropped by
    // a select
    const int kend = N - key0(j);  // keys of this tile below N
#pragma unroll
    for (int nb = 0; nb < kBK / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * nb + 2 * t + (e & 1);
        const float ds = sc[4 * nb + e] * (dp[4 * nb + e] - ddr[e >> 1]);
        const bool keep =
            col < kend && (!kPacked || col / seq == sample[e >> 1]);
        sc[4 * nb + e] = keep ? ds : 0.f;
      }

    // dq += bf16(ds).K, 16 keys a step, K read MN-major
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int k16 = 0; k16 < kBK / 16; ++k16)
      hopper::a_from_acc(pa[k16], sc, k16);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < kBK / 16; ++k16)
      hopper::mma_rs<kC>(acc, pa[k16], hopper::desc_mn(ka, kBK, k16));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(pa);
    if (lane == 0) hopper::mbar_arrive(&k_empty[sk]);
  }

  // dq = scale * acc in bf16, into this warpgroup's q tile (every warp of
  // it is past its last product), then one TMA store per column block
  hopper::bar_sync(kBarWG + wg, 128);
  hopper::acc_to_tile<kC>(qt, acc, scale, scale, false);
  hopper::fence_proxy_async();
  hopper::bar_sync(kBarWG + wg, 128);
  if ((tid & 127) == 0) {
#pragma unroll
    for (int cb = 0; cb < kCB; ++cb)
      hopper::tma_store_3d(&dqmap, qt + cb * 64 * 128, cb * 64, row0, b);
    hopper::tma_store_wait();
  }
}

constexpr int kSMs = 132;  // an H100 SXM's SMs: the packing's target

template <int kC, bool kPacked>
cudaError_t launch_kernel(const CUtensorMap& qm, const CUtensorMap& km,
                          const CUtensorMap& vm, const CUtensorMap& dom,
                          const CUtensorMap& dqm, const void* lse,
                          const void* dd, int rows, int seq, int block_rows,
                          int nwg, int B, float scale, cudaStream_t stream) {
  using T = Tile<kC>;
  auto kernel = flash_bwd_dq_hopper_kernel<kC, kPacked>;
  static unsigned long long done = 0;
  cudaError_t e = hopper::smem_limit_once(
      kernel, T::smem(kMaxWG, T::kKStages, T::kVStages), &done);
  if (e != cudaSuccess) return e;
  const int ntiles = kPacked ? 1 : (rows + kBK - 1) / kBK;
  const int nk = std::min(T::kKStages, ntiles);
  const int nv = std::min(T::kVStages, ntiles);
  dim3 grid((rows + block_rows - 1) / block_rows, B);
  kernel<<<grid, 128 * (nwg + 1), T::smem(nwg, nk, nv), stream>>>(
      qm, km, vm, dom, dqm, static_cast<const float*>(lse),
      static_cast<const float*>(dd), rows, seq, block_rows, scale,
      scale * kLog2e);
  return cudaGetLastError();
}

template <int kC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* dd,
                   void* dq, int B, int N, int C, float scale,
                   cudaStream_t stream) {
  // packed: the B samples of N rows as one sequence of B * N rows, spt
  // samples a tile; else one warpgroup a block when one holds every row
  const int spt = N <= 64 ? std::min(64 / N, (B + kSMs - 1) / kSMs) : 1;
  const bool packed = spt > 1;
  const int mb = packed ? 1 : B, mn = packed ? B * N : N;
  const int block_rows = packed ? spt * N : (N <= 64 ? 64 : 128);
  CUtensorMap qm, km, vm, dom, dqm;
  cudaError_t e;
  if ((e = hopper::map_bnc(&qm, q, mb, mn, C, 64)) != cudaSuccess ||
      (e = hopper::map_bnc(&km, k, mb, mn, C, kBK)) != cudaSuccess ||
      (e = hopper::map_bnc(&vm, v, mb, mn, C, kBK)) != cudaSuccess ||
      (e = hopper::map_bnc(&dom, dout, mb, mn, C, 64)) != cudaSuccess ||
      (e = hopper::map_bnc(&dqm, dq, mb, mn, C,
                           packed ? block_rows : 64)) != cudaSuccess)
    return e;
  if (packed)
    return launch_kernel<kC, true>(qm, km, vm, dom, dqm, lse, dd, mn, N,
                                   block_rows, 1, 1, scale, stream);
  return launch_kernel<kC, false>(qm, km, vm, dom, dqm, lse, dd, N, 0,
                                  block_rows, block_rows / 64, B, scale,
                                  stream);
}

}  // namespace

// As itsd_flash_bwd_dq (csrc/flash_attention_bwd.cu), for bf16 only
// (dtype must be ITSD_BF16): q, k, v, dout, dq: [B, N, C] contiguous bf16;
// lse, dd: [B, N] f32. Needs C % 16 == 0, C <= 256, B <= 65535 and
// 16-byte aligned q, k, v, dout, dq. Any N >= 1. Returns the first CUDA
// error of the tensor maps' encoding or the launch, or 0.
extern "C" int itsd_flash_bwd_dq_mma(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* dd,
                                     void* dq, int B, int N, int C,
                                     float scale, int dtype, void* stream) {
  if (dtype != ITSD_BF16 || B <= 0 || B > 65535 || N <= 0 || C <= 0 ||
      C > kMaxC || C % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hopper::padded_c(C)) {
    case 64:
      return (int)launch<64>(q, k, v, dout, lse, dd, dq, B, N, C, scale, s);
    case 128:
      return (int)launch<128>(q, k, v, dout, lse, dd, dq, B, N, C, scale, s);
    case 192:
      return (int)launch<192>(q, k, v, dout, lse, dd, dq, B, N, C, scale, s);
    default:
      return (int)launch<256>(q, k, v, dout, lse, dd, dq, B, N, C, scale, s);
  }
}
