// Single-head flash attention forward on Hopper's tensor cores (wgmma, TMA,
// mbarriers), for bf16: o = softmax(q k^T * scale) v over [B, N, C], with
// an optional f32 per-row log-sum-exp [B, N]. The entry point of the "mma"
// route's forward.
//
// Replaces the TPU kernel itsd_tpu/kernels/attention.py:_flash_fwd_kernel
// (launched by _flash_forward for _attention_flash and
// _attention_flash_stats) for bf16 inputs with C % 16 == 0 and C <= 256;
// wider bf16 rows take csrc/flash_attention_wide_hopper.cu, f32 inputs
// csrc/flash_attention_tf32x3.cu and other bf16 widths
// csrc/flash_attention.cu. Same arithmetic as the Pallas kernel:
// s = (q.k^T summed in f32) * scale, an online softmax with f32 running max
// m, denominator l and accumulator, p = exp(s - m) rounded to bf16 for the
// p.v product only (l sums the unrounded p), o = acc / l and
// lse = m + log(l). The exponent is taken base 2 with scale * log2(e)
// folded into one fused multiply-add: p = exp2(s * c - m * c) for c =
// scale * log2(e) and the row max m of the unscaled scores, and
// lse = m * c * ln(2) + log(l).
//
// Bound on the card: at the CFG UNet's shape (B=256, N=1024, C=128) the
// call does 2 products of 2*B*N^2*C = 68.7 GFLOP (0.139 ms at 989
// TFLOP/s) and moves 4 tensors of 67 MB (0.080 ms at 3.35 TB/s): bound by
// operations, so the tensor cores' rate is what counts, and Hopper reaches
// it only through wgmma. The earlier kernel (flash_attention_mma.cu, kept
// as itsd_flash_attention_mma_sync) took 8x its bound there on mma.sync.
//
// Design: a block per (sample, 128-row query tile) of two consumer
// warpgroups, each owning 64 query rows (the M of a wgmma), and a producer
// warpgroup, which gives its registers to the consumers (setmaxnreg: 24 a
// thread against 240) and whose thread 0 issues every copy through TMA
// with 3-D tensor maps [B][N][C] in the 128-byte swizzle: the query tiles
// once, then K and V tiles of kBK keys (128 for C <= 128, 64 above, so
// that the accumulators fit the registers) through a ring of stages (3 at
// C <= 128, 2 above: as many as shared memory holds), each copy
// completing on an mbarrier (K and V on their own, so s = q.k^T starts
// before V has landed). The producer refills a stage's K (V) once every
// consumer warp has released it; the consumers never wait for it beyond
// the data itself. s = q.k^T is a chain of wgmma m64n{kBK}k16 with q and K
// both read from shared memory through descriptors. A tile's exponentials
// take about half as long as its products (the special-function unit does
// 16 a clock an SM: 1024 clocks for a 128 x 128 tile, against ~2000 for
// the products), and done in turn with them they add up; so each
// warpgroup issues s of tile j + 1 before p.v of tile j and computes tile
// j + 1's softmax while both run (FlashAttention-3's pipelining), and the
// two warpgroups take turns to issue (named barriers), so that one's
// products run while the other computes its exponentials. The online
// softmax runs on the f32 accumulator fragments (each thread holds 2 rows,
// reduced over the 4 lanes of a quad by shuffle; the mask of keys past N
// only on the last tile); p, rounded to bf16, goes from the score
// fragments straight into the A registers of acc += p.v, a chain of wgmma
// m64n{kC}k16 with V read MN-major (the transpose bit). C is padded to the
// next multiple of 64 (kC) and fixed at compile time: the columns past C
// arrive as zeros, so no guard or runtime width is left in the loops. The
// output (acc / l in bf16) is written into the warpgroup's query tile in
// shared memory in the swizzled layout, and stored by TMA, which writes no
// row past N and no column past C. Keys past N arrive as zeros and get
// s = -inf (p = 0). Shared memory: 113 KB (C <= 64), 225 KB (C <= 128),
// 145 KB (C <= 192) and 193 KB (C <= 256): one block an SM. When N <= 64
// (the CFG UNet's 1x1 and 4x4 maps) one warpgroup holds every row: the
// block has one consumer warpgroup and one stage.

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
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// named barriers (0 is __syncthreads'): each warpgroup's own, and the two
// turns of the products (warpgroup w issues its products on kBarTurn + w)
constexpr int kBarWG = 1, kBarTurn = 3;

// The running row max of the unscaled scores over one key tile; keys at
// or past `kend` get s = -inf first when kMasked (the last tile only).
template <int kBK, bool kMasked>
__device__ __forceinline__ void tile_max(float (&sc)[kBK / 2], float (&mx)[2],
                                         int kend, int t) {
#pragma unroll
  for (int nb = 0; nb < kBK / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kMasked && 8 * nb + 2 * t + (e & 1) >= kend)
        sc[4 * nb + e] = -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * nb + e]);
    }
}

// One key tile's online softmax, base 2: the row max m of the unscaled
// scores moves to this tile's, corr = 2^((m_old - m) * c) rescales what
// came before (0 on the first tile, where m_old = -inf), p = 2^(s * c -
// m * c) with c = scale * log2(e) in one fused multiply-add and one exp2
// an element, l = l * corr + the row sums of the unrounded p, and p
// rounded to bf16 into the A registers of p.v. Element e of 8-key block
// nb is row g + 8 * (e / 2), key 8 * nb + 2t + e % 2 of the tile; the
// first tile always holds a valid key, so m is finite from then on.
template <int kBK, bool kMasked>
__device__ __forceinline__ void softmax_tile(float (&sc)[kBK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2],
                                             uint32_t (&pa)[kBK / 16][4],
                                             float scale_log2, int kend,
                                             int t) {
  float mx[2] = {m[0], m[1]};
  tile_max<kBK, kMasked>(sc, mx, kend, t);
  float mc[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = hopper::exp2_ftz((m[r] - mx[r]) * scale_log2);
    m[r] = mx[r];
    mc[r] = mx[r] * scale_log2;
  }
#pragma unroll
  for (int nb = 0; nb < kBK / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // 0 at s = -inf
      const float p =
          hopper::exp2_ftz(fmaf(sc[4 * nb + e], scale_log2, -mc[e >> 1]));
      rowsum[e >> 1] += p;
      sc[4 * nb + e] = p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rowsum[r];
#pragma unroll
  for (int ks16 = 0; ks16 < kBK / 16; ++ks16)
    hopper::a_from_acc(pa[ks16], sc, ks16);
}

template <int kC>
struct Tile {
  static constexpr int kBK = kC <= 128 ? 128 : 64;  // keys a tile
  // K/V ring: as deep as shared memory allows
  static constexpr int kStages = kC <= 128 ? 3 : 2;
  static constexpr int kQBytes = 64 * kC * 2;       // a warpgroup's q tile
  static constexpr int kKVBytes = kBK * kC * 2;     // one K or V tile
  // nwg q tiles, nst K tiles, nst V tiles (each 1024-byte aligned), then
  // the barriers: q, nst each of K full, V full, K empty, V empty
  static int smem(int nwg, int nst) {
    return 1024 + nwg * kQBytes + 2 * nst * kKVBytes + 8 * (1 + 4 * nst);
  }
};

// The block: nwg consumer warpgroups (1 when N <= 64, else 2; blockDim.x =
// 128 * (nwg + 1)), then the producer warpgroup, whose thread 0 issues
// every copy.
// The ring holds nst = min(kStages, key tiles) stages, laid out at run
// time, so that a small N takes less shared memory.
template <int kC, bool kLse>
__global__ void __launch_bounds__(kMaxThreads, 1)
    flash_fwd_hopper_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __grid_constant__ CUtensorMap omap,
                            float* __restrict__ lse, int N,
                            float scale_log2) {
  using T = Tile<kC>;
  constexpr int kBK = T::kBK;
  constexpr int kCB = kC / 64;  // 64-column blocks
  const int nwg = blockDim.x / 128 - 1;
  const int ntiles = (N + kBK - 1) / kBK;
  const int nst = min(T::kStages, ntiles);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;                    // [nwg][kCB][64][64]
  uint8_t* ks = qs + nwg * T::kQBytes;   // [nst][kCB][kBK][64]
  uint8_t* vs = ks + nst * T::kKVBytes;  // [nst][kCB][kBK][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + nst * T::kKVBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + nst;
  uint64_t* k_empty = v_full + nst;
  uint64_t* v_empty = k_empty + nst;

  const int b = blockIdx.y, q0 = blockIdx.x * 64 * nwg;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int t = lane & 3;
  // warpgroups with a query row below N (the second one idles when N - q0
  // <= 64)
  const int active = min(nwg, (N - q0 + 63) / 64);

  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < nst; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&k_empty[s], 4 * active);
      hopper::mbar_init(&v_empty[s], 4 * active);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == nwg) {
    // the producer: the q tiles, then K and V of key tile j into stage
    // j % nst, each once every consumer warp has released the K (V) of
    // the tile that held it before
    hopper::regs_dec<kProducerRegs>();
    if (tid == 128 * nwg) {
      hopper::mbar_expect_tx(q_full, active * T::kQBytes);
      for (int w = 0; w < active; ++w)
#pragma unroll
        for (int cb = 0; cb < kCB; ++cb)
          hopper::tma_load_3d(qs + w * T::kQBytes + cb * 64 * 128, &qmap,
                              q_full, cb * 64, q0 + 64 * w, b);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % nst;
        if (j >= nst) hopper::mbar_wait(&k_empty[s], (j / nst - 1) & 1);
        hopper::mbar_expect_tx(&k_full[s], T::kKVBytes);
#pragma unroll
        for (int cb = 0; cb < kCB; ++cb)
          hopper::tma_load_3d(ks + s * T::kKVBytes + cb * kBK * 128, &kmap,
                              &k_full[s], cb * 64, j * kBK, b);
        if (j >= nst) hopper::mbar_wait(&v_empty[s], (j / nst - 1) & 1);
        hopper::mbar_expect_tx(&v_full[s], T::kKVBytes);
#pragma unroll
        for (int cb = 0; cb < kCB; ++cb)
          hopper::tma_load_3d(vs + s * T::kKVBytes + cb * kBK * 128, &vmap,
                              &v_full[s], cb * 64, j * kBK, b);
      }
    }
    return;
  }
  hopper::regs_inc<kConsumerRegs>();
  if (wg >= active) return;

  float acc[kC / 2];
#pragma unroll
  for (int i = 0; i < kC / 2; ++i) acc[i] = 0.f;
  // rows g and g + 8 of the warp's 16: running max of the unscaled scores
  // and this thread's part of the denominator (summed over the quad at the
  // end)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint8_t* qt = qs + wg * T::kQBytes;
  const uint32_t qa = smem_addr(qt);

  // Ping-pong: with both warpgroups at work, each issues its products (s
  // of the next tile and p.v of this one) only in its turn and hands the
  // turn over once they are issued, so that one warpgroup's products run
  // on the tensor cores while the other one computes its softmax (in
  // lockstep both would wait on the tensor cores, then both on the
  // exponentials). Warpgroup 0 takes the first turn; warpgroup 1 hands
  // over after every turn but its last, so that each barrier's arrivals
  // match its waits.
  const bool pingpong = active == 2;
  if (pingpong && wg == 1) hopper::bar_arrive(kBarTurn, 256);
  auto take_turn = [&] {
    if (pingpong) hopper::bar_sync(kBarTurn + wg, 256);
  };
  auto hand_over = [&](bool last) {
    if (pingpong && !(wg == 1 && last))
      hopper::bar_arrive(kBarTurn + 1 - wg, 256);
  };

  // s = q.k^T (unscaled) of key tile jj into sc, issued, not waited for
  auto issue_s = [&](float (&sc)[kBK / 2], int jj) {
    const int s = jj % nst;
    const uint32_t ka = smem_addr(ks + s * T::kKVBytes);
    hopper::mbar_wait(&k_full[s], (jj / nst) & 1);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kC / 16; ++kk)
      hopper::mma_ss<kBK>(sc, hopper::desc_k(qa, 64, kk / 4, kk % 4),
                          hopper::desc_k(ka, kBK, kk / 4, kk % 4), kk > 0);
    hopper::wgmma_commit();
  };
  auto softmax = [&](float (&sc)[kBK / 2], int jj, float (&corr)[2],
                     uint32_t (&pa)[kBK / 16][4]) {
    const int kend = N - jj * kBK;  // keys of this tile below N
    if (kend >= kBK)
      softmax_tile<kBK, false>(sc, m, l, corr, pa, scale_log2, kend, t);
    else
      softmax_tile<kBK, true>(sc, m, l, corr, pa, scale_log2, kend, t);
  };

  // acc += bf16(p).v for key tile jj, issued, not waited for: acc holds
  // the tiles before jj (their p.v is done), rescaled first to tile jj's
  // max, only when a row's max moved (times 1 is exact); p's fragments are
  // the A registers, 16 keys a step
  auto issue_pv = [&](const uint32_t (&pa)[kBK / 16][4], const float (&corr)[2],
                      int jj) {
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int nb = 0; nb < kC / 8; ++nb) {
        acc[4 * nb] *= corr[0];
        acc[4 * nb + 1] *= corr[0];
        acc[4 * nb + 2] *= corr[1];
        acc[4 * nb + 3] *= corr[1];
      }
    }
    const int s = jj % nst;
    const uint32_t va = smem_addr(vs + s * T::kKVBytes);
    hopper::mbar_wait(&v_full[s], (jj / nst) & 1);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks16 = 0; ks16 < kBK / 16; ++ks16)
      hopper::mma_rs<kC>(acc, pa[ks16], hopper::desc_mn(va, kBK, ks16));
    hopper::wgmma_commit();
  };

  // Software pipeline: s of tile j + 1 is issued before p.v of tile j, and
  // tile j + 1's softmax runs on the CUDA cores while p.v of tile j runs on
  // the tensor cores. sc holds s of the next tile; p of consecutive tiles
  // alternates between pa and pb, so that no register a running p.v reads
  // is written (the loop is unrolled by two for that, with the last tile
  // peeled off: ptxas then sees which products each wait retires and
  // keeps them asynchronous).
  float sc[kBK / 2];
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.f;
  uint32_t pa[kBK / 16][4], pb[kBK / 16][4];
  float corr[2];
  // tile j's p.v from `cur`, tile j + 1's s and softmax into `nxt`
  auto step = [&](uint32_t (&cur)[kBK / 16][4], uint32_t (&nxt)[kBK / 16][4],
                  int j) {
    take_turn();
    issue_s(sc, j + 1);
    issue_pv(cur, corr, j);
    hand_over(false);
    hopper::wgmma_wait<1>();  // s of tile j + 1; p.v of tile j may run on
    hopper::fence_regs(sc);
    if (lane == 0) hopper::mbar_arrive(&k_empty[(j + 1) % nst]);
    softmax(sc, j + 1, corr, nxt);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(cur);
    if (lane == 0) hopper::mbar_arrive(&v_empty[j % nst]);
  };
  // the last tile's p.v
  auto last = [&](uint32_t (&cur)[kBK / 16][4], int j) {
    take_turn();
    issue_pv(cur, corr, j);
    hand_over(true);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(cur);
    if (lane == 0) hopper::mbar_arrive(&v_empty[j % nst]);
  };
  hopper::mbar_wait(q_full, 0);
  take_turn();
  issue_s(sc, 0);
  hand_over(false);
  hopper::wgmma_wait<0>();
  hopper::fence_regs(sc);
  if (lane == 0) hopper::mbar_arrive(&k_empty[0]);
  softmax(sc, 0, corr, pa);
  int j = 0;
  for (; j + 2 < ntiles; j += 2) {
    step(pa, pb, j);
    step(pb, pa, j + 1);
  }
  if (j + 1 < ntiles) {
    step(pa, pb, j);
    last(pb, j + 1);
  } else {
    last(pa, j);
  }

  // o = acc / l in bf16, into this warpgroup's query tile (every warp of
  // it is past its last product), then one TMA store per column block
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  hopper::bar_sync(kBarWG + wg, 128);
  hopper::acc_to_tile<kC>(qt, acc, l[0], l[1], true);
  hopper::fence_proxy_async();
  hopper::bar_sync(kBarWG + wg, 128);
  const int row0 = q0 + 64 * wg;
  if ((tid & 127) == 0) {
#pragma unroll
    for (int cb = 0; cb < kCB; ++cb)
      hopper::tma_store_3d(&omap, qt + cb * 64 * 128, cb * 64, row0, b);
    hopper::tma_store_wait();
  }
  if (kLse && t == 0) {
    const int g = lane >> 2;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + warp * 16 + g + 8 * r;
      if (row < N)
        lse[(size_t)b * N + row] = m[r] * scale_log2 * kLn2 + logf(l[r]);
    }
  }
}

template <int kC, bool kLse>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int N, int C, float scale,
                   cudaStream_t stream) {
  using T = Tile<kC>;
  static unsigned long long done = 0;
  cudaError_t e = hopper::smem_limit_once(flash_fwd_hopper_kernel<kC, kLse>,
                                          T::smem(kMaxWG, T::kStages), &done);
  if (e != cudaSuccess) return e;
  CUtensorMap qm, km, vm, om;
  if ((e = hopper::map_bnc(&qm, q, B, N, C, 64)) != cudaSuccess ||
      (e = hopper::map_bnc(&km, k, B, N, C, T::kBK)) != cudaSuccess ||
      (e = hopper::map_bnc(&vm, v, B, N, C, T::kBK)) != cudaSuccess ||
      (e = hopper::map_bnc(&om, o, B, N, C, 64)) != cudaSuccess)
    return e;
  // one warpgroup a block when one holds every row, so that two such
  // blocks share an SM
  const int nwg = N <= 64 ? 1 : kMaxWG;
  const int nst = std::min(T::kStages, (N + T::kBK - 1) / T::kBK);
  dim3 grid((N + 64 * nwg - 1) / (64 * nwg), B);
  flash_fwd_hopper_kernel<kC, kLse>
      <<<grid, 128 * (nwg + 1), T::smem(nwg, nst), stream>>>(
          qm, km, vm, om, static_cast<float*>(lse), N, scale * kLog2e);
  return cudaGetLastError();
}

template <int kC>
cudaError_t dispatch_lse(const void* q, const void* k, const void* v,
                         void* o, void* lse, int B, int N, int C,
                         float scale, cudaStream_t s) {
  return lse ? launch<kC, true>(q, k, v, o, lse, B, N, C, scale, s)
             : launch<kC, false>(q, k, v, o, lse, B, N, C, scale, s);
}

}  // namespace

// As itsd_flash_attention (csrc/flash_attention.cu), for bf16 only
// (dtype must be ITSD_BF16): q, k, v, o: [B, N, C] contiguous bf16; lse:
// [B, N] f32, or null for the plain forward. Needs C % 16 == 0, C <= 256,
// B <= 65535 and 16-byte aligned q, k, v, o. Any N >= 1.
// Returns the first CUDA error of the tensor maps' encoding or the launch,
// or 0.
extern "C" int itsd_flash_attention_mma(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int B, int N, int C, float scale,
                                        int dtype, void* stream) {
  if (dtype != ITSD_BF16 || B <= 0 || B > 65535 || N <= 0 || C <= 0 ||
      C > kMaxC || C % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hopper::padded_c(C)) {
    case 64:
      return (int)dispatch_lse<64>(q, k, v, o, lse, B, N, C, scale, s);
    case 128:
      return (int)dispatch_lse<128>(q, k, v, o, lse, B, N, C, scale, s);
    case 192:
      return (int)dispatch_lse<192>(q, k, v, o, lse, B, N, C, scale, s);
    default:
      return (int)dispatch_lse<256>(q, k, v, o, lse, B, N, C, scale, s);
  }
}
