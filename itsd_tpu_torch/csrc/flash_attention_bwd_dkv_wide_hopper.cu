// Single-head flash attention backward, dk and dv, on Hopper's tensor cores
// (wgmma, TMA, mbarriers) for wide rows: bf16 over [B, N, C] with
// 256 < C <= 1024. The entry point of the "wide" route's dk/dv.
//
// Replaces the TPU kernel itsd_tpu/kernels/attention.py:_flash_bwd_dkv_kernel
// (launched by _attention_flash_bwd) for bf16 inputs with C % 16 == 0 and
// 256 < C <= 1024: the CFG UNet's C=512 and C=1024 and the 256x256
// flagship's C=384. Narrower bf16 rows take
// csrc/flash_attention_bwd_dkv_hopper.cu, f32 and other widths the CUDA-core
// kernel of csrc/flash_attention_bwd.cu. The mma.sync kernel this one
// replaced (csrc/flash_attention_bwd_wide.cu) stays as
// itsd_flash_bwd_dkv_wide_sync. Same arithmetic as the Pallas kernel and
// flash_attention_bwd_dkv_hopper.cu: s = q.k^T summed in f32,
// p = exp(s * scale - lse) from the forward's lse (base 2 in one fused
// multiply-add), dp = dO.v^T in f32, ds = p * (dp - dd) with dd =
// rowsum(dO * O) - dlse taken by the caller, then dv = p^T.dO and
// dk = scale * ds^T.q with p and ds rounded to bf16 for those products
// only, all sums in f32 and dk scaled once. Each key row and column of dk
// and dv belongs to one block, which walks all the queries: no sum crosses
// blocks, there are no atomics, and two launches give the same bits.
//
// Bound on the card: at the CFG train step's [256, 256, 512] the call
// moves 6 tensors of 67.1 MB plus lse and dd (120 us at 3.35 TB/s) and
// does 4 products of 2*B*N^2*C = 17.2 GFLOP (69 us at 989 TFLOP/s): bound
// by bytes; at the flagship's [1, 4096, 384] 51.5 GFLOP (52 us) against
// 19 MB: bound by operations.
//
// Design. dk and dv of 64 keys are 2 x C f32 columns, 768-2048 at
// C=384-1024, and a warpgroup holds at most 256 (128 registers a thread).
// So each block owns a slice of kW columns of both: kR = 2 blocks a key
// tile at C=384 (kW = 192) and C=512 (256), 4 at C=1024 (256), the ranks
// of a thread-block cluster, so that the slices of one key tile are
// scheduled together and their shared reads of q, dO, K and V are served
// by L2. A block is a producer warpgroup (setmaxnreg: 24 a thread against
// 240; its thread 0 issues every copy through TMA) and two consumer
// warpgroups over the same 64 keys (the M of every product):
//   warpgroup 0: s^T = K.q^T over all of C, p^T (0 for queries past N or of
//   another sample), written to shared memory in f32 for warpgroup 1, and
//   dv[:, slice] += bf16(p^T).dO[:, slice];
//   warpgroup 1: dp^T = V.dO^T over all of C, ds^T = p^T * (dp^T - dd) with
//   warpgroup 0's p^T (named barriers; two buffers, so that warpgroup 0
//   runs a tile ahead), and
//   dk[:, slice] += bf16(ds^T).q[:, slice].
// Every slice's block computes s^T and dp^T over all of C itself, with the
// same chain of wgmma on the same operands: the same bits in every block,
// with no exchange across blocks (the other way, partial products over
// each slice summed through distributed shared memory in a fixed order,
// halves those products but exchanges 2 x 16 KB of f32 a query tile
// between 2-4 blocks). The recompute brings the operations to 1.5x the
// minimum at C=384-512 and 2.5x at C=1024, where the CFG UNet's calls are
// bound by bytes.
// Shared memory. At C <= 512 the block keeps K and V of its 64 keys at
// full width (96 KB at C=384, 128 KB at C=512) and brings q and dO at full
// width through a ring of 2 stages of kBQ queries (32 at C=384, 16 at
// C=512: as many as fit beside K and V), with their lse and dd through 1-D
// maps (a box from the tile's first row rounded down to a multiple of 4).
// Both blocks of the cluster read the same K, V, q and dO at full width;
// copying each once by TMA multicast into both (each stage released across
// the cluster) did not make the calls faster: 0.446 against 0.433 ms at
// [256, 256, 512] (NVIDIA H100 80GB HBM3, 700 W, chip_wide_probe.py), so
// L2's bandwidth is not what holds them: the per-tile latencies of 16 or
// 32 queries a tile are (the next redesign's matter).
// At C=1024, K and V of 64 keys alone would take 256 KB: the full-width
// products stream, for each query tile of 64, 64-column blocks of K, V, q
// and dO (32 KB a block) through a ring of 3, and the slice's q and dO
// (and lse and dd) arrive as a stage of their own. (The cluster's 4 blocks
// read the same column blocks; copying each once by TMA multicast into all
// four, each slot released across the cluster, was slower: 0.149 against
// 0.132 ms at [256, 64, 1024], NVIDIA H100 80GB HBM3, 700 W,
// chip_wide_probe.py: the four then wait on the slowest at every slot.)
// The CFG UNet's C=1024 maps hold N <= 64 tokens, one query tile, so each
// block reads K and V once; at larger N it reads them again from L2 for
// each query tile.
// C is padded to 384, 512 or 1024 at compile time: columns past C arrive
// as zeros from TMA, and no column past C (nor key past N) is stored.
// After the loop each warpgroup writes its result in bf16 (dk times scale)
// into a tile only it read (dv into K's, dk into V's; at C=1024 into the
// slice stage's dO and q) and stores it by TMA.
// Small N: at N <= 64 past 132 / kR samples (kPacked) the tensors are read
// as [1, B * N, C], a tile holds the rows of ceil(B * kR / 132) whole
// samples (up to 64 / N), and a query counts for a key only when both
// belong to one
// sample (a block-diagonal mask, the select that drops queries past N), as
// in csrc/flash_attention_bwd_dq_hopper.cu.
// Latency: s^T and dp^T over a resident K and V are C/16 products of
// m64n{kBQ}k16 each, too small to hide the latency of the one before in a
// dependent chain; they run as 2 (kBQ = 32) or 4 (kBQ = 16) independent
// chains, whose sums are added in a fixed order.

#include <math.h>

#include <algorithm>

#include "common.cuh"
#include "hopper_tiles.cuh"

namespace {

using hopper::smem_addr;

// C up to kMinC takes flash_attention_bwd_dkv_hopper.cu
constexpr int kMinC = 256;
constexpr int kMaxC = 1024;
constexpr int kThreads = 384;  // two consumer warpgroups, a producer one
// Registers a thread after the shift: the producer warpgroup keeps few,
// each consumer thread takes up to 240
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kBKey = 64;  // keys a block
constexpr float kLog2e = 1.4426950408889634f;
// named barriers (0 is __syncthreads'): each warpgroup's own, and each of
// the two p^T buffers' "written" (kBarPFull + buffer) and "read"
// (kBarPEmpty + buffer)
constexpr int kBarWG = 1, kBarPFull = 3, kBarPEmpty = 5;

template <int kC>
struct Tile {
  // K and V at full width do not fit beside the stages: stream them
  static constexpr bool kStream = kC > 512;
  static constexpr int kR = kC > 512 ? 4 : 2;  // blocks (slices) a key tile
  static constexpr int kW = kC / kR;           // a slice's columns
  static constexpr int kBQ = kC <= 384 ? 32 : kC <= 512 ? 16 : 64;  // queries
  // independent chains of the k-steps of s^T (dp^T) over a resident K (V):
  // a chain of dependent m64n{kBQ}k16 products waits on each one's latency,
  // far longer than their 8-16 clocks of work; the chains' sums are added
  // in a fixed order
  static constexpr int kChains = kBQ == 16 ? 4 : 2;
  static constexpr int kStages = kStream ? 1 : 2;  // q/dO (slice) stages
  static constexpr int kRing = 3;                  // streamed column blocks
  static constexpr int kKV = kBKey * kC * 2;       // resident K or V
  // a stage's q or dO: full width, or the slice's columns when streaming
  static constexpr int kQ = kBQ * (kStream ? kW : kC) * 2;
  static constexpr int kBlkKV = kBKey * 64 * 2;  // a 64-column block of K
  static constexpr int kBlkQ = kBQ * 64 * 2;     // of q
  static constexpr int kChunk = 2 * kBlkKV + 2 * kBlkQ;  // K, V, q, dO
  // A tile's lse (or dd) box: TMA needs a 16-byte aligned start, so the
  // box starts at the tile's first row rounded down to a multiple of 4 and
  // holds 4 more rows; boxes land kRowStride floats (a multiple of 128
  // bytes) apart.
  static constexpr int kRowBox = kBQ + 4;
  static constexpr int kRowStride = (kRowBox + 31) / 32 * 32;
  static constexpr int kRows = kRowBox * 4;  // bytes of a box
  static constexpr int kLdP = kBQ + 8;       // f32 row of the p^T tile
  // (K, V) or the ring, nst q, nst dO (each 1024-byte aligned), nst lse,
  // nst dd, two p^T [64][kLdP], then the barriers: K/V, nst full, nst
  // empty, kRing chunk full, kRing chunk empty
  static int smem(int nst) {
    return 1024 + (kStream ? kRing * kChunk : 2 * kKV) + 2 * nst * kQ +
           2 * nst * kRowStride * 4 + 2 * kBKey * kLdP * 4 +
           8 * (1 + 2 * nst + 2 * kRing);
  }
};

// The block: two consumer warpgroups over the block's keys, then the
// producer warpgroup. Grid: x the key tiles times kR (a cluster of kR
// along x: the slices), y the samples. kPacked: the rows of samples of
// `seq` rows each, `block_rows` a tile (tensors read as [1, B * N, C]);
// else `block_rows` = 64.
template <int kC, bool kPacked>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_wide_hopper_kernel(
        const __grid_constant__ CUtensorMap qmap,
        const __grid_constant__ CUtensorMap kmap,
        const __grid_constant__ CUtensorMap vmap,
        const __grid_constant__ CUtensorMap domap,
        const __grid_constant__ CUtensorMap lsemap,
        const __grid_constant__ CUtensorMap ddmap,
        const __grid_constant__ CUtensorMap dkmap,
        const __grid_constant__ CUtensorMap dvmap, int N, int C, int seq,
        int block_rows, float scale, float scale_log2) {
  using T = Tile<kC>;
  constexpr int kBQ = T::kBQ;
  constexpr int kCB = kC / 64;       // 64-column blocks of the full width
  constexpr int kWB = T::kW / 64;    // of a slice
  constexpr int kSB = T::kStream ? kWB : kCB;  // of a stage's q and dO
  const int ntiles = ((kPacked ? block_rows : N) + kBQ - 1) / kBQ;
  const int nst = min(T::kStages, ntiles);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  // resident: K [kCB][64][64] and V; streamed: the ring of column blocks
  uint8_t* ks = smem;
  uint8_t* vs = ks + T::kKV;
  uint8_t* ring = smem;  // [kRing] x (K, V [64][64], q, dO [kBQ][64])
  uint8_t* qs = smem + (T::kStream ? T::kRing * T::kChunk : 2 * T::kKV);
  uint8_t* dos = qs + nst * T::kQ;  // [nst][kSB][kBQ][64] each
  float* lse_s = reinterpret_cast<float*>(dos + nst * T::kQ);
  float* dd_s = lse_s + nst * T::kRowStride;  // [nst][kRowStride] each
  float* pt = dd_s + nst * T::kRowStride;     // [2][kBKey][kLdP]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(pt + 2 * kBKey * T::kLdP);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + nst;
  uint64_t* c_full = empty + nst;
  uint64_t* c_empty = c_full + T::kRing;

  const int rank = blockIdx.x % T::kR;  // the cluster rank (1-D): the slice
  const int b = blockIdx.y, k0 = (blockIdx.x / T::kR) * block_rows;
  const int col0 = rank * T::kW;  // the slice's first column
  // the first row of query tile j: a packed tile's own rows
  auto qrow0 = [&](int j) { return (kPacked ? k0 : 0) + j * kBQ; };
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
    for (int s = 0; s < T::kRing; ++s) {
      hopper::mbar_init(&c_full[s], 1);
      hopper::mbar_init(&c_empty[s], 8);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // the producer: K and V once (resident), then for each query tile j
    // its column blocks of K, V, q and dO into the ring (streamed), and q,
    // dO, lse and dd into stage j % nst, each slot once all 8 consumer
    // warps have released what it held before
    hopper::regs_dec<kProducerRegs>();
    if (tid == 256) {
      if constexpr (!T::kStream) {
        hopper::mbar_expect_tx(kv_full, 2 * T::kKV);
#pragma unroll
        for (int cb = 0; cb < kCB; ++cb) {
          hopper::tma_load_3d(ks + cb * kBKey * 128, &kmap, kv_full, cb * 64,
                              k0, b);
          hopper::tma_load_3d(vs + cb * kBKey * 128, &vmap, kv_full, cb * 64,
                              k0, b);
        }
      }
      int c = 0;  // column blocks streamed so far
      for (int j = 0; j < ntiles; ++j) {
        if constexpr (T::kStream) {
          for (int cb = 0; cb < kCB; ++cb, ++c) {
            const int slot = c % T::kRing;
            if (c >= T::kRing)
              hopper::mbar_wait(&c_empty[slot], (c / T::kRing - 1) & 1);
            hopper::mbar_expect_tx(&c_full[slot], T::kChunk);
            uint8_t* at = ring + slot * T::kChunk;
            hopper::tma_load_3d(at, &kmap, &c_full[slot], cb * 64, k0, b);
            hopper::tma_load_3d(at + T::kBlkKV, &vmap, &c_full[slot],
                                cb * 64, k0, b);
            hopper::tma_load_3d(at + 2 * T::kBlkKV, &qmap, &c_full[slot],
                                cb * 64, qrow0(j), b);
            hopper::tma_load_3d(at + 2 * T::kBlkKV + T::kBlkQ, &domap,
                                &c_full[slot], cb * 64, qrow0(j), b);
          }
        }
        const int s = j % nst;
        if (j >= nst) hopper::mbar_wait(&empty[s], (j / nst - 1) & 1);
        hopper::mbar_expect_tx(&full[s], 2 * T::kQ + 2 * T::kRows);
        // resident: q and dO at full width; streamed: the slice's columns
        const int cfirst = T::kStream ? col0 : 0;
#pragma unroll
        for (int cb = 0; cb < kSB; ++cb) {
          hopper::tma_load_3d(qs + s * T::kQ + cb * kBQ * 128, &qmap,
                              &full[s], cfirst + cb * 64, qrow0(j), b);
          hopper::tma_load_3d(dos + s * T::kQ + cb * kBQ * 128, &domap,
                              &full[s], cfirst + cb * 64, qrow0(j), b);
        }
        const int row0 = (int)(row_base + qrow0(j)) & ~3;
        hopper::tma_load_1d(lse_s + s * T::kRowStride, &lsemap, &full[s],
                            row0);
        hopper::tma_load_1d(dd_s + s * T::kRowStride, &ddmap, &full[s],
                            row0);
      }
    }
    return;
  }
  hopper::regs_inc<kConsumerRegs>();

  // dv (warpgroup 0) or the unscaled dk (warpgroup 1) of the thread's rows
  // (keys warp * 16 + g and + 8) and the slice's columns
  float acc[T::kW / 2];
#pragma unroll
  for (int i = 0; i < T::kW / 2; ++i) acc[i] = 0.f;
  // kPacked: the first row of each of the thread's two keys' samples
  // within the tile
  int first[2] = {0, 0};
  if (kPacked) {
    first[0] = (warp * 16 + g) / seq * seq;
    first[1] = (warp * 16 + g + 8) / seq * seq;
  }
  // queries of the block's rows: those below N (or below the packed
  // tile's end, which may lie past N on the last tile)
  const int qend_all = kPacked ? min(block_rows, N - k0) : N;
  // resident: warpgroup 0 reads K, warpgroup 1 V, at full width
  const uint32_t a_res = smem_addr(wg == 0 ? ks : vs);
  // the slice's first column block within a stage's q or dO
  const uint32_t slice_off = T::kStream ? 0 : rank * kWB * kBQ * 128;

  if constexpr (!T::kStream) hopper::mbar_wait(kv_full, 0);
  int c = 0;  // column blocks consumed so far (streamed)
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % nst;
    const uint32_t qa = smem_addr(qs + s * T::kQ);
    const uint32_t da = smem_addr(dos + s * T::kQ);

    // s^T = K.q^T (warpgroup 0) or dp^T = V.dO^T (warpgroup 1) over all of
    // C, unscaled
    float sc[kBQ / 2];
#pragma unroll
    for (int i = 0; i < kBQ / 2; ++i) sc[i] = 0.f;
    if constexpr (T::kStream) {
      // 4 steps of 16 columns a streamed block, each block its own group;
      // a block's slot is released once its products are done
      for (int cb = 0; cb < kCB; ++cb, ++c) {
        const int slot = c % T::kRing;
        const uint32_t at = smem_addr(ring + slot * T::kChunk);
        const uint32_t a = at + (wg == 0 ? 0 : T::kBlkKV);
        const uint32_t bq = at + 2 * T::kBlkKV + (wg == 0 ? 0 : T::kBlkQ);
        hopper::mbar_wait(&c_full[slot], (c / T::kRing) & 1);
        hopper::fence_regs(sc);
        hopper::wgmma_fence();
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4)
          hopper::mma_ss<kBQ>(sc, hopper::desc_k(a, kBKey, 0, k4),
                              hopper::desc_k(bq, kBQ, 0, k4),
                              cb > 0 || k4 > 0);
        hopper::wgmma_commit();
        if (cb > 0) {
          hopper::wgmma_wait<1>();
          if (lane == 0) hopper::mbar_arrive(&c_empty[(c - 1) % T::kRing]);
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      if (lane == 0) hopper::mbar_arrive(&c_empty[(c - 1) % T::kRing]);
      hopper::mbar_wait(&full[s], (j / nst) & 1);
    } else {
      constexpr int kCh = T::kChains;
      const uint32_t b_first = wg == 0 ? qa : da;
      float sp[kCh][kBQ / 2];  // k-step kk into chain kk % kCh
#pragma unroll
      for (int ch = 0; ch < kCh; ++ch)
#pragma unroll
        for (int i = 0; i < kBQ / 2; ++i) sp[ch][i] = 0.f;
      hopper::mbar_wait(&full[s], (j / nst) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kC / 16; ++kk)
        hopper::mma_ss<kBQ>(sp[kk % kCh],
                            hopper::desc_k(a_res, kBKey, kk / 4, kk % 4),
                            hopper::desc_k(b_first, kBQ, kk / 4, kk % 4),
                            kk >= kCh);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int ch = 0; ch < kCh; ++ch) hopper::fence_regs(sp[ch]);
#pragma unroll
      for (int i = 0; i < kBQ / 2; ++i) {
        sc[i] = sp[0][i];
#pragma unroll
        for (int ch = 1; ch < kCh; ++ch) sc[i] += sp[ch][i];
      }
    }

    // element e of 8-query block nb is key row warp * 16 + g + 8 * (e / 2),
    // query column 8 * nb + 2t + e % 2 of the tile
    const int qend = qend_all - j * kBQ;  // queries of this tile the keys see
    const int lead = (int)(row_base + qrow0(j)) & 3;
    const float* lse_t = lse_s + s * T::kRowStride + lead;
    const float* dd_t = dd_s + s * T::kRowStride + lead;
    // p^T of tile j in buffer j % 2, so that warpgroup 0 runs a tile ahead
    const int pbuf = j & 1;
    float* prow0 = pt + (pbuf * kBKey + warp * 16 + g) * T::kLdP + 2 * t;
    float* prow1 = prow0 + 8 * T::kLdP;
    // the tile's queries key row r sees: lo[r] <= col < hi[r] (those
    // below N; in a packed tile, of the key's own sample)
    int lo[2] = {0, 0}, hi[2] = {qend, qend};
    if (kPacked) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lo[r] = first[r] - j * kBQ;
        hi[r] = min(qend, lo[r] + seq);
      }
    }
    auto keep = [&](int nb, int e) {
      const int col = 8 * nb + 2 * t + (e & 1);
      return col >= lo[e >> 1] && col < hi[e >> 1];
    };
    // the thread's columns' lse (times log2(e)) or dd, read whatever the
    // column (the box holds kBQ + 4 rows: a column past N reads a finite
    // row or a zero), so that no load waits behind a branch; a column a
    // key does not see is then dropped by a select
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
          const float p = hopper::exp2_ftz(
              fmaf(sc[4 * nb + e], scale_log2, -row[nb][e & 1]));
          sc[4 * nb + e] = keep(nb, e) ? p : 0.f;
        }
      // tile j - 2's p^T, in the same buffer, read
      if (j > 1) hopper::bar_sync(kBarPEmpty + pbuf, 256);
#pragma unroll
      for (int nb = 0; nb < kBQ / 8; ++nb) {
        *reinterpret_cast<float2*>(prow0 + 8 * nb) =
            make_float2(sc[4 * nb], sc[4 * nb + 1]);
        *reinterpret_cast<float2*>(prow1 + 8 * nb) =
            make_float2(sc[4 * nb + 2], sc[4 * nb + 3]);
      }
      hopper::bar_arrive(kBarPFull + pbuf, 256);
    } else {
      hopper::bar_sync(kBarPFull + pbuf, 256);
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
      if (j + 2 < ntiles) hopper::bar_arrive(kBarPEmpty + pbuf, 256);
#pragma unroll
      for (int nb = 0; nb < kBQ / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ds = p[nb][e] * (sc[4 * nb + e] - row[nb][e & 1]);
          sc[4 * nb + e] = keep(nb, e) ? ds : 0.f;
        }
    }

    // dv[:, slice] += bf16(p^T).dO[:, slice] or dk[:, slice] +=
    // bf16(ds^T).q[:, slice], 16 queries a step, read MN-major
    const uint32_t b_second = (wg == 0 ? da : qa) + slice_off;
    uint32_t pa[kBQ / 16][4];
#pragma unroll
    for (int q16 = 0; q16 < kBQ / 16; ++q16)
      hopper::a_from_acc(pa[q16], sc, q16);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int q16 = 0; q16 < kBQ / 16; ++q16)
      hopper::mma_rs<T::kW>(acc, pa[q16],
                            hopper::desc_mn(b_second, kBQ, q16));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(pa);
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

  // dv, or dk = scale * sum, in bf16 into a tile only this warpgroup read
  // (K's or V's; streamed: the last stage's dO or q), then one TMA store
  // per column block below C
  const int sl = (ntiles - 1) % nst;
  uint8_t* out = T::kStream ? (wg == 0 ? dos : qs) + sl * T::kQ
                            : (wg == 0 ? ks : vs);
  hopper::bar_sync(kBarWG + wg, 128);
  const float mul = wg == 0 ? 1.f : scale;
  hopper::acc_to_tile<T::kW>(out, acc, mul, mul, false);
  hopper::fence_proxy_async();
  hopper::bar_sync(kBarWG + wg, 128);
  if ((tid & 127) == 0) {
#pragma unroll
    for (int cb = 0; cb < kWB; ++cb)
      if (col0 + cb * 64 < C)
        hopper::tma_store_3d(wg == 0 ? &dvmap : &dkmap, out + cb * 64 * 128,
                             col0 + cb * 64, k0, b);
    hopper::tma_store_wait();
  }
}

constexpr int kSMs = 132;  // an H100 SXM's SMs: the packing's target

template <int kC, bool kPacked>
cudaError_t launch_kernel(const CUtensorMap (&m)[8], int rows, int C,
                          int seq, int block_rows, int B, float scale,
                          cudaStream_t stream) {
  using T = Tile<kC>;
  auto kernel = flash_bwd_dkv_wide_hopper_kernel<kC, kPacked>;
  static unsigned long long done = 0;
  cudaError_t e = hopper::smem_limit_once(kernel, T::smem(T::kStages), &done);
  if (e != cudaSuccess) return e;
  const int ntiles = ((kPacked ? block_rows : rows) + T::kBQ - 1) / T::kBQ;
  const int nst = std::min(T::kStages, ntiles);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((rows + block_rows - 1) / block_rows * T::kR, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = T::smem(nst);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = T::kR;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, m[0], m[1], m[2], m[3], m[4], m[5],
                         m[6], m[7], rows, C, seq, block_rows, scale,
                         scale * kLog2e);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int kC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* dd,
                   void* dk, void* dv, int B, int N, int C, float scale,
                   cudaStream_t stream) {
  using T = Tile<kC>;
  // packed: the B samples of N rows as one sequence of B * N rows, spt
  // samples a tile, as few as bring the grid's kR blocks a tile to one
  // wave
  const int waves = (B * T::kR + kSMs - 1) / kSMs;
  const int spt = N <= 64 ? std::min(64 / N, waves) : 1;
  const bool packed = spt > 1;
  const int mb = packed ? 1 : B, mn = packed ? B * N : N;
  const int block_rows = packed ? spt * N : kBKey;
  const long long rows = (long long)B * N;
  // q, k, v, dO, lse, dd, dk, dv
  CUtensorMap m[8];
  cudaError_t e;
  if ((e = hopper::map_bnc(&m[0], q, mb, mn, C, T::kBQ)) != cudaSuccess ||
      (e = hopper::map_bnc(&m[1], k, mb, mn, C, kBKey)) != cudaSuccess ||
      (e = hopper::map_bnc(&m[2], v, mb, mn, C, kBKey)) != cudaSuccess ||
      (e = hopper::map_bnc(&m[3], dout, mb, mn, C, T::kBQ)) != cudaSuccess ||
      (e = hopper::map_f32(&m[4], lse, rows, T::kRowBox)) != cudaSuccess ||
      (e = hopper::map_f32(&m[5], dd, rows, T::kRowBox)) != cudaSuccess ||
      (e = hopper::map_bnc(&m[6], dk, mb, mn, C, block_rows)) !=
          cudaSuccess ||
      (e = hopper::map_bnc(&m[7], dv, mb, mn, C, block_rows)) != cudaSuccess)
    return e;
  if (packed)
    return launch_kernel<kC, true>(m, mn, C, N, block_rows, 1, scale,
                                   stream);
  return launch_kernel<kC, false>(m, N, C, 1, kBKey, B, scale, stream);
}

}  // namespace

// As itsd_flash_bwd_dkv (csrc/flash_attention_bwd.cu), for bf16 only
// (dtype must be ITSD_BF16): q, k, v, dout, dk, dv: [B, N, C] contiguous
// bf16; lse, dd: [B, N] f32. Needs C % 16 == 0, 256 < C <= 1024,
// B <= 65535, 16-byte aligned q, k, v, dout, dk, dv, lse and dd, and
// B * N < 2^31. Any N >= 1. Returns the first CUDA error of the tensor
// maps' encoding or the launch, or 0.
extern "C" int itsd_flash_bwd_dkv_wide(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* dd,
                                       void* dk, void* dv, int B, int N,
                                       int C, float scale, int dtype,
                                       void* stream) {
  if (dtype != ITSD_BF16 || B <= 0 || B > 65535 || N <= 0 || C <= kMinC ||
      C > kMaxC || C % 16 != 0 || (long long)B * N >= (1ll << 31) - 64)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the flagship's C=384 and the CFG UNet's 512 and 1024 have
  // instantiations of their own; any other width takes the next wider one
  if (C <= 384)
    return (int)launch<384>(q, k, v, dout, lse, dd, dk, dv, B, N, C, scale,
                            s);
  if (C <= 512)
    return (int)launch<512>(q, k, v, dout, lse, dd, dk, dv, B, N, C, scale,
                            s);
  return (int)launch<1024>(q, k, v, dout, lse, dd, dk, dv, B, N, C, scale, s);
}
