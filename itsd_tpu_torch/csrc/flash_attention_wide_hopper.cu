// Single-head flash attention forward on Hopper's tensor cores (wgmma, TMA,
// mbarriers) for wide rows: o = softmax(q k^T * scale) v over [B, N, C] in
// bf16 with 256 < C <= 1024, with an optional f32 per-row log-sum-exp
// [B, N]. The entry point of the "wide" route's forward.
//
// Replaces the TPU kernel itsd_tpu/kernels/attention.py:_flash_fwd_kernel
// (launched by _flash_forward for _attention_flash and
// _attention_flash_stats) for bf16 inputs with C % 16 == 0 and
// 256 < C <= 1024: the CFG UNet's C=512 (16x16 and 2x2) and C=1024 (8x8
// and 4x4), and the 256x256 flagship's C=384. Narrower bf16 rows take
// csrc/flash_attention_hopper.cu, f32 csrc/flash_attention_tf32x3.cu and
// other bf16 widths the CUDA-core kernel of csrc/flash_attention.cu. The mma.sync kernel this one replaced
// (csrc/flash_attention_wide.cu) stays as itsd_flash_attention_wide_sync.
// Same arithmetic as the Pallas kernel and flash_attention_hopper.cu:
// s = (q.k^T summed in f32) * scale, an online softmax with f32 running max
// m, denominator l and accumulator, p = exp(s - m) rounded to bf16 for the
// p.v product only (l sums the unrounded p), o = acc / l and
// lse = m + log(l); the exponent is taken base 2 with scale * log2(e)
// folded into one fused multiply-add.
//
// Bound on the card: at the flagship's [1, 4096, 384] the call does 2
// products of 2*N^2*C = 12.9 GFLOP (26 us at 989 TFLOP/s) and moves 4
// tensors of 3.1 MB (4 us): bound by operations. At the CFG train step's
// [256, 256, 512] it does 17.2 GFLOP (35 us) and moves 268 MB (80 us):
// bound by bytes, as are the CFG UNet's smaller maps.
//
// Design. A warpgroup's f32 accumulator of 64 rows x W columns costs W/2
// registers a thread, so a warpgroup owns at most 256 columns of o: the
// kernel splits the head dimension over column owners, each of which
// needs the same scores and the same softmax.
// * A block is one producer warpgroup (registers given away by setmaxnreg:
//   24 a thread against 240) and two consumer warpgroups over the same 64
//   query rows, each owning kO columns of o: 192 at C=384, 256 at C=512.
//   At C=1024 the 1024 columns need four owners, whose 4 x 128 threads x
//   ~200 registers exceed one SM: two blocks, the two ranks of a
//   thread-block cluster, own 512 columns each (cluster rank r columns
//   512r..512r+511), scheduled together, so that the second block's reads
//   of q and K find them in L2. (Copying q and K once by TMA multicast into
//   both blocks, with each K stage released across the cluster, was
//   slower: 0.0893 against 0.0844 ms at [256, 64, 1024], NVIDIA H100 80GB
//   HBM3, 700 W, chip_wide_probe.py; the pair then waits on its slower
//   block at every stage.)
// * Each owner computes the whole s = q.k^T over all of C itself, from the
//   same q and K tiles in shared memory by the same chain of wgmma: the
//   tensor cores give the same bits for the same operands in the same
//   order, so every owner of a row holds the same f32 scores, the same m,
//   l and p, with no exchange between warpgroups or blocks. The price is
//   the recomputed q.k^T: 1.5x the operations at C=384-512, 2.5x at
//   C=1024. The alternative, partial products over each owner's columns
//   summed through (distributed) shared memory, halves that, but costs two
//   barriers and a 64 x kBK f32 exchange a key tile, across blocks at
//   C=1024; the CFG UNet's calls are bound by bytes, where the recompute
//   is hidden, and the flagship's operations stay under SDPA's time.
// * Shared memory holds the block's q tile at full width (64 x C), and a
//   ring of kBK = 32 keys of K (all of C) and of V (the block's columns):
//   3 stages at C=384 (193 KB), 2 at C=512 (193 KB), 1 at C=1024 (225 KB:
//   q alone takes 128 KB). TMA copies every tile (3-D tensor maps [B][N][C]
//   in the 128-byte swizzle); K and V complete on barriers of their own, so
//   s of the next tile starts before V has landed, and a stage is refilled
//   once all 8 consumer warps have released it.
// * As in flash_attention_hopper.cu, each warpgroup issues s of tile j + 1
//   before p.v of tile j and computes tile j + 1's softmax while both run
//   (FlashAttention-3's pipelining), and the two warpgroups take turns to
//   issue (named barriers). s = q.k^T is a chain of C/16 wgmma m64n32k16
//   (q and K K-major in shared memory; two independent chains, added
//   after, measured no faster: 0.188 against 0.187 ms at [256, 256, 512],
//   chip_wide_probe.py); p, rounded to bf16, goes from the
//   score fragments into the A registers of acc += p.v, wgmma m64n{kO}k16
//   with the owner's columns of V read MN-major. C is padded to 384, 512
//   or 1024 and fixed at compile time: columns past C arrive as zeros from
//   TMA and are not stored.
// * The card is filled. At N <= 64 (the CFG UNet's 8x8, 4x4 and 2x2 maps)
//   a block would hold one sample, and past 132 / R samples (R blocks a
//   tile) the grid would take more than one wave of tiny blocks: there
//   (kPacked) the [B, N, C] tensors are read as [1, B * N, C], a tile
//   holds the rows of S = ceil(B * R / 132) whole samples (up to 64 / N),
//   and a key counts for a query only when both belong to one sample (a
//   block-diagonal mask), as in csrc/flash_attention_bwd_dq_hopper.cu. A
//   row whose first key tile holds only other samples' keys keeps
//   m = -inf until its own: p = 0 and nothing is rescaled there. A packed
//   tile's 1 or 2 key tiles run s, softmax and p.v in turn, without the
//   pipeline's second p (its registers spilled at C=1024).
// * The output (acc / l in bf16) is written, once both warpgroups are past
//   their last product, into the owner's columns of the q tile in the
//   swizzled layout and stored by TMA, which writes no row past N (nor past
//   a packed tile's rows) and no column past C (a column block wholly past
//   C is not stored at all).

#include <math.h>

#include <algorithm>

#include "common.cuh"
#include "hopper_tiles.cuh"

namespace {

using hopper::smem_addr;

constexpr int kMinC = 256;  // C up to this takes flash_attention_hopper.cu
constexpr int kMaxC = 1024;
constexpr int kThreads = 384;  // two consumer warpgroups, a producer one
// Registers a thread after the shift: the producer warpgroup keeps few,
// each consumer thread takes up to 240 (the block's 168 a thread at launch:
// 24 + 2 * 240 = 3 * 168)
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kBK = 32;  // keys a tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// named barriers (0 is __syncthreads'): each warpgroup's own, the two
// turns of the products (warpgroup w issues on kBarTurn + w), and both
// consumer warpgroups
constexpr int kBarWG = 1, kBarTurn = 3, kBarBoth = 5;

// The first of the two rows (g and g + 8 of its warp's 16) a consumer
// thread holds in a warpgroup's 64.
__device__ __forceinline__ int row_of(int tid) {
  return ((tid >> 5) & 3) * 16 + ((tid & 31) >> 2);
}

template <int kC>
struct Tile {
  // blocks (cluster ranks) a query tile: each owns kC / kRanks columns
  static constexpr int kRanks = kC > 512 ? 2 : 1;
  static constexpr int kCc = kC / kRanks;  // a block's columns of o and V
  static constexpr int kO = kCc / 2;       // a warpgroup's columns
  static constexpr int kStages = kC <= 384 ? 3 : kC <= 512 ? 2 : 1;

  static constexpr int kQBytes = 64 * kC * 2;   // the q tile
  static constexpr int kKBytes = kBK * kC * 2;  // one K tile
  static constexpr int kVBytes = kBK * kCc * 2;  // one V tile, own columns
  // q, nst K tiles, nst V tiles (each 1024-byte aligned), then the
  // barriers: q, nst each of K full, V full, K empty, V empty
  static int smem(int nst) {
    return 1024 + kQBytes + nst * (kKBytes + kVBytes) + 8 * (1 + 4 * nst);
  }
};

// One key tile's online softmax, base 2, as flash_attention_hopper.cu's
// softmax_tile, with the keys a row may not see set to -inf first: none
// (kMask 0), those at or past `kend` (1), or also those of another sample
// of a packed tile (2: key kbase + col against the row's sample rs).
template <int kMask>
__device__ __forceinline__ void softmax_tile(float (&sc)[kBK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2],
                                             uint32_t (&pa)[kBK / 16][4],
                                             float scale_log2, int kend,
                                             int kbase, int seq,
                                             const int (&rs)[2], int t) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int nb = 0; nb < kBK / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kMask) {
        const int col = 8 * nb + 2 * t + (e & 1);
        bool keep = col < kend;
        if (kMask == 2) keep = keep && (kbase + col) / seq == rs[e >> 1];
        if (!keep) sc[4 * nb + e] = -INFINITY;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * nb + e]);
    }
  float mc[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // a row that has seen no key yet keeps m = -inf: p = 0 below, and acc
    // and l (still 0) need no rescaling
    const bool none = mx[r] == -INFINITY;
    corr[r] = none ? 1.f : hopper::exp2_ftz((m[r] - mx[r]) * scale_log2);
    m[r] = mx[r];
    mc[r] = none ? 0.f : mx[r] * scale_log2;
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

// The block: two consumer warpgroups over the block's 64 query rows, then
// the producer warpgroup, whose thread 0 issues every copy. Grid: x the
// query tiles times kRanks (a cluster of kRanks along x), y the samples.
// kPacked: the rows of samples of `seq` rows each, `block_rows` a tile
// (the tensors read as [1, B * N, C], N = B * N); else `block_rows` = 64.
template <int kC, bool kPacked>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wide_hopper_kernel(const __grid_constant__ CUtensorMap qmap,
                                 const __grid_constant__ CUtensorMap kmap,
                                 const __grid_constant__ CUtensorMap vmap,
                                 const __grid_constant__ CUtensorMap omap,
                                 float* __restrict__ lse, int N, int C,
                                 int seq, int block_rows, float scale_log2) {
  using T = Tile<kC>;
  constexpr int kCB = kC / 64;      // 64-column blocks of q and K
  constexpr int kOB = T::kO / 64;   // a warpgroup's column blocks
  const int ntiles = ((kPacked ? block_rows : N) + kBK - 1) / kBK;
  const int nst = min(T::kStages, ntiles);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;                    // [kCB][64][64]
  uint8_t* ks = qs + T::kQBytes;         // [nst][kCB][kBK][64]
  uint8_t* vs = ks + nst * T::kKBytes;   // [nst][2 * kOB][kBK][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + nst * T::kVBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + nst;
  uint64_t* k_empty = v_full + nst;
  uint64_t* v_empty = k_empty + nst;

  const int rank = blockIdx.x % T::kRanks;  // the cluster rank (1-D)
  const int b = blockIdx.y, q0 = (blockIdx.x / T::kRanks) * block_rows;
  const int col0 = rank * T::kCc;  // the block's first column of o and V
  // the first row of key tile j: a packed tile's own rows
  auto key0 = [&](int j) { return (kPacked ? q0 : 0) + j * kBK; };
  const int tid = threadIdx.x, wg = tid >> 7;
  const int lane = tid & 31, t = lane & 3;

  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < nst; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&k_empty[s], 8);
      hopper::mbar_init(&v_empty[s], 8);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // the producer: the q tile, then K and V of key tile j into stage
    // j % nst, each once all 8 consumer warps have released the K (V) of
    // the tile that held it before
    hopper::regs_dec<kProducerRegs>();
    if (tid == 256) {
      hopper::mbar_expect_tx(q_full, T::kQBytes);
#pragma unroll
      for (int cb = 0; cb < kCB; ++cb)
        hopper::tma_load_3d(qs + cb * 64 * 128, &qmap, q_full, cb * 64, q0,
                            b);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % nst;
        if (j >= nst) hopper::mbar_wait(&k_empty[s], (j / nst - 1) & 1);
        hopper::mbar_expect_tx(&k_full[s], T::kKBytes);
#pragma unroll
        for (int cb = 0; cb < kCB; ++cb)
          hopper::tma_load_3d(ks + s * T::kKBytes + cb * kBK * 128, &kmap,
                              &k_full[s], cb * 64, key0(j), b);
        if (j >= nst) hopper::mbar_wait(&v_empty[s], (j / nst - 1) & 1);
        hopper::mbar_expect_tx(&v_full[s], T::kVBytes);
#pragma unroll
        for (int cb = 0; cb < 2 * kOB; ++cb)
          hopper::tma_load_3d(vs + s * T::kVBytes + cb * kBK * 128, &vmap,
                              &v_full[s], col0 + cb * 64, key0(j), b);
      }
    }
    return;
  }
  hopper::regs_inc<kConsumerRegs>();

  float acc[T::kO / 2];
#pragma unroll
  for (int i = 0; i < T::kO / 2; ++i) acc[i] = 0.f;
  // rows g and g + 8 of the warp's 16: running max of the unscaled scores
  // and this thread's part of the denominator (summed over the quad at the
  // end)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const uint32_t qa = smem_addr(qs);
  // this warpgroup's columns of a V tile start kOB column blocks in
  const uint32_t v_own = wg * kOB * kBK * 128;

  // Ping-pong, as in flash_attention_hopper.cu: each warpgroup issues its
  // products only in its turn and hands the turn over once they are
  // issued; warpgroup 0 takes the first turn, warpgroup 1 hands over after
  // every turn but its last.
  if (wg == 1) hopper::bar_arrive(kBarTurn, 256);
  auto take_turn = [&] { hopper::bar_sync(kBarTurn + wg, 256); };
  auto hand_over = [&](bool last) {
    if (!(wg == 1 && last)) hopper::bar_arrive(kBarTurn + 1 - wg, 256);
  };

  // s = q.k^T (unscaled) of key tile jj over all of C into sc, issued, not
  // waited for
  auto issue_s = [&](float (&sc)[kBK / 2], int jj) {
    const int s = jj % nst;
    uint32_t q_at = qa, ka = smem_addr(ks + s * T::kKBytes);
    // opaque to the compiler, so that it builds each of the 2 * C/16
    // descriptors when its product is issued instead of holding them all
    // in registers across the tile loop (at C=1024, 256 registers)
    asm volatile("" : "+r"(q_at), "+r"(ka));
    hopper::mbar_wait(&k_full[s], (jj / nst) & 1);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kC / 16; ++kk)
      hopper::mma_ss<kBK>(sc, hopper::desc_k(q_at, 64, kk / 4, kk % 4),
                          hopper::desc_k(ka, kBK, kk / 4, kk % 4), kk > 0);
    hopper::wgmma_commit();
  };
  auto softmax = [&](float (&sc)[kBK / 2], int jj, float (&corr)[2],
                     uint32_t (&pa)[kBK / 16][4]) {
    // keys of this tile the rows see: those below N (or below the packed
    // tile's end, which may lie past N on the last tile); the tile's first
    // row read again from the block's index, so that no register holds it
    // across the loop (one spilled at C=1024)
    const int kend =
        (kPacked ? min(block_rows,
                       N - (int)(blockIdx.x / T::kRanks) * block_rows)
                 : N) -
        jj * kBK;
    // under kPacked the rows' samples within the tile, from the thread's
    // index a tile (a value kept from the start to here spilled at C=1024)
    int rs[2] = {0, 0};
    if (kPacked) {
      const int row = row_of(threadIdx.x);
      rs[0] = row / seq;
      rs[1] = (row + 8) / seq;
    }
    if (kPacked)
      softmax_tile<2>(sc, m, l, corr, pa, scale_log2, kend, jj * kBK, seq,
                      rs, t);
    else if (kend >= kBK)
      softmax_tile<0>(sc, m, l, corr, pa, scale_log2, kend, 0, 1, rs, t);
    else
      softmax_tile<1>(sc, m, l, corr, pa, scale_log2, kend, 0, 1, rs, t);
  };

  // acc += bf16(p).v over this warpgroup's columns for key tile jj,
  // issued, not waited for; acc rescaled first to tile jj's max, only when
  // a row's max moved
  auto issue_pv = [&](const uint32_t (&pa)[kBK / 16][4], const float (&corr)[2],
                      int jj) {
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int nb = 0; nb < T::kO / 8; ++nb) {
        acc[4 * nb] *= corr[0];
        acc[4 * nb + 1] *= corr[0];
        acc[4 * nb + 2] *= corr[1];
        acc[4 * nb + 3] *= corr[1];
      }
    }
    const int s = jj % nst;
    const uint32_t va = smem_addr(vs + s * T::kVBytes) + v_own;
    hopper::mbar_wait(&v_full[s], (jj / nst) & 1);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks16 = 0; ks16 < kBK / 16; ++ks16)
      hopper::mma_rs<T::kO>(acc, pa[ks16], hopper::desc_mn(va, kBK, ks16));
    hopper::wgmma_commit();
  };

  // The software pipeline of flash_attention_hopper.cu: s of tile j + 1 is
  // issued before p.v of tile j, and tile j + 1's softmax runs while p.v
  // of tile j runs; p of consecutive tiles alternates between pa and pb.
  float sc[kBK / 2];
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.f;
  uint32_t pa[kBK / 16][4], pb[kBK / 16][4];
  float corr[2];
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
  if constexpr (kPacked) {
    // a packed tile's at most 64 keys are 1 or 2 key tiles: s, softmax and
    // p.v tile by tile, in turns, without the pipeline's second p (the
    // registers C=1024 lacks)
    for (int jj = 0; jj < ntiles; ++jj) {
      take_turn();
      issue_s(sc, jj);
      hand_over(false);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      if (lane == 0) hopper::mbar_arrive(&k_empty[jj % nst]);
      softmax(sc, jj, corr, pa);
      take_turn();
      issue_pv(pa, corr, jj);
      hand_over(jj + 1 == ntiles);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::fence_regs(pa);
      if (lane == 0) hopper::mbar_arrive(&v_empty[jj % nst]);
    }
  } else {
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
  }

  // o = acc / l in bf16 into the owner's columns of the q tile, once both
  // warpgroups are past their last product (the other one may still read
  // q), then one TMA store per column block
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  hopper::bar_sync(kBarBoth, 256);
  uint8_t* ot = qs + wg * kOB * 64 * 128;
  hopper::acc_to_tile<T::kO>(ot, acc, l[0], l[1], true);
  hopper::fence_proxy_async();
  hopper::bar_sync(kBarWG + wg, 128);
  if ((tid & 127) == 0) {
#pragma unroll
    for (int cb = 0; cb < kOB; ++cb) {
      const int col = col0 + wg * T::kO + cb * 64;
      if (col < C)
        hopper::tma_store_3d(&omap, ot + cb * 64 * 128, col, q0, b);
    }
    hopper::tma_store_wait();
  }
  // the lse when asked for (a null pointer: the plain forward), from one
  // block of the cluster
  if (lse != nullptr && rank == 0 && wg == 0 && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rel = row_of(threadIdx.x) + 8 * r;
      if (rel < block_rows && q0 + rel < N)
        lse[(size_t)b * N + q0 + rel] =
            m[r] * scale_log2 * kLn2 + logf(l[r]);
    }
  }
}

constexpr int kSMs = 132;  // an H100 SXM's SMs: the packing's target

template <int kC, bool kPacked>
cudaError_t launch_kernel(const CUtensorMap& qm, const CUtensorMap& km,
                          const CUtensorMap& vm, const CUtensorMap& om,
                          void* lse, int rows, int C, int seq,
                          int block_rows, int B, float scale,
                          cudaStream_t stream) {
  using T = Tile<kC>;
  auto kernel = flash_fwd_wide_hopper_kernel<kC, kPacked>;
  static unsigned long long done = 0;
  cudaError_t e = hopper::smem_limit_once(kernel, T::smem(T::kStages), &done);
  if (e != cudaSuccess) return e;
  const int ntiles = ((kPacked ? block_rows : rows) + kBK - 1) / kBK;
  const int nst = std::min(T::kStages, ntiles);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((rows + block_rows - 1) / block_rows * T::kRanks, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = T::smem(nst);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = T::kRanks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = T::kRanks > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, qm, km, vm, om,
                         static_cast<float*>(lse), rows, C, seq, block_rows,
                         scale * kLog2e);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int kC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int N, int C, float scale,
                   cudaStream_t stream) {
  // packed: the B samples of N rows as one sequence of B * N rows, spt
  // samples a tile, as few as bring the grid's kRanks blocks a tile to one
  // wave
  const int waves = (B * Tile<kC>::kRanks + kSMs - 1) / kSMs;
  const int spt = N <= 64 ? std::min(64 / N, waves) : 1;
  const bool packed = spt > 1;
  const int mb = packed ? 1 : B, mn = packed ? B * N : N;
  const int block_rows = packed ? spt * N : 64;
  CUtensorMap qm, km, vm, om;
  cudaError_t e;
  if ((e = hopper::map_bnc(&qm, q, mb, mn, C, 64)) != cudaSuccess ||
      (e = hopper::map_bnc(&km, k, mb, mn, C, kBK)) != cudaSuccess ||
      (e = hopper::map_bnc(&vm, v, mb, mn, C, kBK)) != cudaSuccess ||
      (e = hopper::map_bnc(&om, o, mb, mn, C, block_rows)) != cudaSuccess)
    return e;
  if (packed)
    return launch_kernel<kC, true>(qm, km, vm, om, lse, mn, C, N,
                                   block_rows, 1, scale, stream);
  return launch_kernel<kC, false>(qm, km, vm, om, lse, N, C, 1, 64, B, scale,
                                  stream);
}

}  // namespace

// As itsd_flash_attention (csrc/flash_attention.cu), for bf16 only
// (dtype must be ITSD_BF16): q, k, v, o: [B, N, C] contiguous bf16; lse:
// [B, N] f32, or null for the plain forward. Needs C % 16 == 0,
// 256 < C <= 1024, B <= 65535 and 16-byte aligned q, k, v, o. Any N >= 1.
// Returns the first CUDA error of the tensor maps' encoding or the launch,
// or 0.
extern "C" int itsd_flash_attention_wide(const void* q, const void* k,
                                         const void* v, void* o, void* lse,
                                         int B, int N, int C, float scale,
                                         int dtype, void* stream) {
  if (dtype != ITSD_BF16 || B <= 0 || B > 65535 || N <= 0 || C <= kMinC ||
      C > kMaxC || C % 16 != 0 || (long long)B * N >= (1ll << 31) - 64)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the flagship's C=384 and the CFG UNet's 512 and 1024 have
  // instantiations of their own; any other width takes the next wider one
  if (C <= 384) return (int)launch<384>(q, k, v, o, lse, B, N, C, scale, s);
  if (C <= 512) return (int)launch<512>(q, k, v, o, lse, B, N, C, scale, s);
  return (int)launch<1024>(q, k, v, o, lse, B, N, C, scale, s);
}
