// Single-head flash attention forward on the tensor cores for f32 inputs,
// with f32-accurate products: o = softmax(q k^T * scale) v over [B, N, C]
// in f32 with C % 4 == 0 and C <= 1024, with an optional f32 per-row
// log-sum-exp [B, N]. The entry point of the "tf32x3" route, the forward
// of every f32 call the kernels take.
//
// Replaces the TPU kernel itsd_tpu/kernels/attention.py:_flash_fwd_kernel
// (launched by _flash_forward for _attention_flash and
// _attention_flash_stats) for f32 inputs. bf16 takes the "mma" and "wide"
// kernels (and the CUDA-core kernel of csrc/flash_attention.cu at
// C % 16 != 0); the f32 backward stays on the CUDA-core kernels of
// csrc/flash_attention_bwd.cu. The CUDA-core forward this one replaced for
// f32 (csrc/flash_attention.cu) stays as its same-call yardstick, through
// the forced call _flash_simt. Same arithmetic as that kernel, in f32
// throughout: s = q.k^T * scale, an online softmax with f32 running max m,
// denominator l and accumulator, p kept in f32 (nothing is rounded before
// p.v), o = acc / l and lse = m + log(l); the exponent is taken base 2,
// with scale * log2(e) folded into the scores.
//
// Products in error-compensated TF32 ("3xTF32", CUTLASS's
// OpMultiplyAddFastF32). Each f32 operand is split as x = hi + lo, with
// hi = tf32(x) rounded to nearest, ties away (cvt.rna.tf32.f32's
// rounding, done on the bits: see split), and lo = x - hi, exact in f32
// with |lo| <= 2^-11 |x|, truncated to TF32. Then a.b = a_hi.b_hi +
// a_hi.b_lo + a_lo.b_hi + a_lo.b_lo, of which the last, <= 2^-22 |a.b|, is
// dropped, and the three others are tensor-core products with f32
// accumulation, the two small ones added first. One TF32 product alone
// keeps ~11 bits and misses the f32 limits (o and lse within 2e-5 of the
// plain f32 version); the split keeps them (chip_tf32x3_probe.py's sweep
// holds the kernel and the CUDA-core one to those limits).
//
// The tensor cores' f32 sums are not rounded to nearest, and their error
// leans one way: into one accumulator over all 4096 keys, p.v drifted with
// the accumulator's size where v has a mean (the inference config's
// activations; random test inputs with mean zero hide it), and one
// forward of its model ended 9.94e-5 from the plain path's eps
// (chip_smoke.py's phase 4, limit 5e-5). So every product chain starts
// from zero registers and stays short: s sums each round of four 8-column
// steps apart, p.v each key tile's products for each 8-column block, and
// f32 adds (and multiply-adds, with the softmax's rescale) join them to
// the running sums.
//
// Bound on the card: at the inference config's [64, 4096, 384] the call
// does 2 products of 2*B*N^2*C = 824.6 GFLOP: 24.6 ms on the CUDA cores'
// f32 peak (67 TFLOP/s), and 10.0 ms on the tensor cores at three TF32
// products each (495 TFLOP/s / 3); it moves 4 tensors of 403 MB (0.48 ms).
// Bound by operations at every f32 shape of the UNets.
//
// Design.
// * mma.sync.m16n8k8 in TF32, not wgmma: TF32 wgmma reads both operands
//   K-major, so p.v would need V transposed in shared memory, and hi and lo
//   tiles of every shared operand would double the shared memory that f32
//   tiles already fill. mma.sync's fragments load 32 bits a lane from plain
//   f32 tiles (ldmatrix over rows of 16 bytes for q and K, two 32-bit loads
//   for V), and the split happens in registers as they load. mma.sync's
//   TF32 rate on the card is a fraction of the 495 TFLOP/s that wgmma
//   reaches (chip_tf32x3_probe.py measures it), and a third of it is left
//   for f32-accurate products.
// * The split costs three integer or f32 operations a value (ptxas expands
//   cvt.rna.tf32.f32 into a longer compare-and-select sequence, which
//   measured slower), and every value is split as it is loaded: K and V
//   by each row group that reads them, q once a key tile.
// * p.v without a trip through shared memory: the C fragment of s holds
//   keys 2t and 2t + 1 of an 8-key block where the A fragment of an m16n8k8
//   TF32 product wants keys t and t + 4. The sum over keys does not care in
//   which order they come, so the A fragment's column t stands for key 2t
//   and column t + 4 for key 2t + 1, and the B fragment reads V's rows
//   2t and 2t + 1 to match: p goes from the score registers into the
//   product.
// * The head dimension is split over kW warps that share 16 query rows
//   (a row group), as in csrc/flash_attention_wide.cu: each owns C / kW
//   columns of o (an accumulator of C / (2 kW) registers) and computes s
//   over the same columns of q and K (a split-K); the kW partial score
//   tiles meet in shared memory and every owner adds them in warp order,
//   so all hold the same s, m, l and p. Blocks of 8 warps: kW = 1 at
//   C <= 128, 2 at C = 384 (192 columns a warp), 8 at C = 1024; of 16
//   warps, whose 128 registers a thread the short chains fit: kW = 2 at
//   C = 256, 4 at C = 512 (128 columns a warp). Each was the fastest of
//   the tilings measured for its width.
// * Shared memory holds the block's q tile (f32, rows padded by 16 bytes:
//   the row stride is 4 words past a multiple of 32, so ldmatrix reads and
//   V's column reads hit 32 distinct banks) and one K and one V tile of
//   kBK keys, refilled in turns by cp.async: V of tile j loads while s of
//   tile j is computed, K of tile j + 1 while p.v of tile j is, two block
//   barriers a tile. A 64-row q tile takes 96 KB at C = 384 and 128 KB at
//   C = 512, so the blocks take 128 rows up to C = 256, 64 up to C = 512
//   and 16 at C = 1024, with 64 keys a tile at C <= 128, 32 at C = 384
//   and 16 at the others: at most 210 KB.
// * A row group with no row below N (a small N's last tile) takes no
//   product.
// * C is padded at compile time to 64, 128, 256, 384, 512 or 1024: the
//   copies fill columns past C (and rows past N) with zeros, which add
//   nothing to s or to p.v, and only rows below N and columns below C are
//   stored. Keys past N get s = -inf (p = 0).
// * Small N fills fewer, fuller blocks: where two or more samples fit
//   both a query tile and a key tile (N <= R / 2, R the smaller of the
//   two), the [B, N, C] tensors are read as [B / S, S * N, C] with S = R / N
//   samples a tile, and a key counts for a query only when both belong to
//   one sample (a block-diagonal mask). The S samples' keys fit one key
//   tile, so a packed block costs what an unpacked one does, and every
//   row's first (and only) tile holds its own keys: m is finite after it.
//   The CFG UNet's [256, 4, 512] takes 64 blocks instead of 256.
// * Each row of o and lse belongs to one block, which walks every key in
//   a fixed order, with no atomics: two launches agree bit for bit, and
//   the variant with lse writes the same o as the one without.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma_tiles.cuh"

namespace {

constexpr int kPad = 4;  // floats of padding a row (16 bytes)
constexpr int kMaxC = 1024;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The tiling of one padded width kC: kW warps own the columns of a row
// group of 16 query rows, kBK keys a tile.
template <int kC, int kW, int kBK, int kWarps = 8>
struct Tiling {
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kRG = kWarps / kW;  // row groups a block
  static constexpr int kBQ = 16 * kRG;     // query rows a block
  static constexpr int kLd = kC + kPad;    // row stride in shared memory
  static constexpr int kCw = kC / kW;      // columns a warp owns
  static constexpr int kKS = kCw / 8;      // 8-column steps of s a warp
  static constexpr int kNB = kBK / 8;      // 8-key blocks of s
  static constexpr int kON = kCw / 8;      // 8-column blocks of o a warp
  static_assert(kWarps % kW == 0 && kCw % 32 == 0 && kBK % 16 == 0 &&
                    kC <= kMaxC && kC % 32 == 0,
                "bad tiling");
  // q, K and V tiles, and a partial score tile (16 x kBK) a warp when
  // the columns are split
  static constexpr size_t kSmem =
      (size_t)(kBQ + 2 * kBK) * kLd * sizeof(float) +
      (kW > 1 ? (size_t)kWarps * 16 * kBK * sizeof(float) : 0);
};

// x = hi + lo as two TF32 values (32-bit patterns whose low 13 mantissa
// bits are zero): hi = x rounded to nearest, ties away from zero, the
// rounding of cvt.rna.tf32.f32, done on the bits (half a TF32 unit added
// to the magnitude, the carry reaching the exponent where it should:
// the same bits for every finite x, in two integer operations where
// ptxas expands cvt.rna into a compare-and-select sequence); lo = x - hi,
// exact in f32 and |lo| <= 2^-11 |x|, truncated to TF32 (its error
// <= 2^-21 |x|).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

template <int kN>
__device__ __forceinline__ void split_all(const uint32_t (&x)[kN],
                                          uint32_t (&hi)[kN],
                                          uint32_t (&lo)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) split(__uint_as_float(x[i]), hi[i], lo[i]);
}

// c += A.B for one m16n8k8 tile: TF32 operands, f32 accumulation. With
// g = lane / 4 and t = lane % 4: a = A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4]; b = B[t][g], B[t+4][g]; c = C[g][2t..2t+1],
// C[g+8][2t..2t+1] (PTX ISA, "Matrix Fragments for mma.m16n8k8").
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage rows [r0, r0 + kRows) of a [rows, C] f32 matrix into shared memory
// as [kRows][kC + kPad], 16 bytes a copy, zeros past `rows` and past C.
template <int kRows, int kC, int kThreads>
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      float* dst, int r0, int rows, int C,
                                      int tid) {
  constexpr int kChunks = kC / 4;  // 16-byte chunks a padded row
#pragma unroll 4
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i - r * kChunks) * 4;
    const bool valid = r0 + r < rows && c < C;
    // a copy past the matrix reads nothing; its address is the base
    mma::cp_async16(dst + r * (kC + kPad) + c,
                    valid ? src + (size_t)(r0 + r) * C + c : src, valid);
  }
}

// Grid: (query tiles of kBQ rows, groups of `pack` samples). A block
// reads its group's samples as one [rows, C] matrix, rows = pack * N (less
// in the last group); with pack > 1 a key counts only for the queries of
// its own sample.
template <int kC, int kW, int kBK, int kWarps>
__global__ void __launch_bounds__(kWarps * 32, 1)
    flash_fwd_tf32x3_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ o, float* __restrict__ lse,
                            int B, int N, int C, int pack, float scale) {
  using T = Tiling<kC, kW, kBK, kWarps>;
  constexpr int kLd = T::kLd;
  extern __shared__ float4 smem_tf32[];
  float* qs = reinterpret_cast<float*>(smem_tf32);  // [kBQ][kLd]
  float* ks = qs + T::kBQ * kLd;                    // [kBK][kLd]
  float* vs = ks + kBK * kLd;                       // [kBK][kLd]
  float4* part =
      reinterpret_cast<float4*>(vs + kBK * kLd);  // [kWarps][kNB][32]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp / kW, wc = warp % kW;
  const int b0 = blockIdx.y * pack;
  const int rows = min(pack, B - b0) * N;
  const int q0 = blockIdx.x * T::kBQ;
  const size_t off = (size_t)b0 * N * C;
  const float* kb = k + off;
  const float* vb = v + off;

  stage<T::kBQ, kC, T::kThreads>(q + off, qs, q0, rows, C, tid);
  stage<kBK, kC, T::kThreads>(kb, ks, 0, rows, C, tid);
  mma::cp_async_commit();

  // This lane's addresses, within the warp's columns c0 = wc * kCw: q's
  // A fragment and K's B fragments (two 8-key blocks) by ldmatrix, whose
  // 8x8 16-bit matrices are 8 rows of 4 floats; V's B fragment by two
  // 32-bit loads from rows 2t and 2t + 1 (see the header).
  const int c0 = wc * T::kCw;
  const float* q_lane = qs +
                        (rg * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                        c0 + (lane >> 4) * 4;
  const int k_off =
      ((lane & 7) + (lane >> 4) * 8) * kLd + c0 + ((lane >> 3) & 1) * 4;
  const int v_off = 2 * t * kLd + c0 + g;
  const float4* group_part = part + rg * kW * T::kNB * 32 + lane;

  float acc[T::kON][4];
#pragma unroll
  for (int nb = 0; nb < T::kON; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
  // rows g and g + 8 of the row group: running max (of the scores times
  // scale * log2(e)), and this thread's part of the denominator (summed
  // over the quad at the end)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float sl2 = scale * kLog2e;
  // the sample of rows g and g + 8 within the group (packed tiles only;
  // rows past the group's take its last sample, and are not stored)
  const int row_g = q0 + rg * 16 + g;
  const int sample[2] = {min(row_g, rows - 1) / N,
                         min(row_g + 8, rows - 1) / N};
  // a row group with no row below the group's (a small N's last tile)
  // takes no product: its scores stay 0 and nothing of it is stored
  const int steps = q0 + rg * 16 < rows ? T::kKS : 0;

  const int ntiles = (rows + kBK - 1) / kBK;
  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * kBK;
    mma::cp_async_wait<0>();
    // K of tile j (and q) has landed, and every warp is done with V of
    // tile j - 1: V of tile j loads while s is computed
    __syncthreads();
    stage<kBK, kC, T::kThreads>(vb, vs, k0, rows, C, tid);
    mma::cp_async_commit();

    // this warp's share of s = q.k^T: its columns of q and of K, four
    // 8-column steps a round (two or one measured slower). The tensor
    // cores' f32 sums are not rounded to nearest: a long chain of products
    // into one accumulator drifts with the accumulator's size. So each
    // round sums into fresh registers, and the rounds are added in f32.
    float s[T::kNB][4];
#pragma unroll
    for (int nb = 0; nb < T::kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll 1
    for (int k4 = 0; k4 < steps; k4 += 4) {
      float r[T::kNB][4];
#pragma unroll
      for (int nb = 0; nb < T::kNB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) r[nb][e] = 0.f;
#pragma unroll
      for (int kk = k4; kk < k4 + 4; ++kk) {
        uint32_t a[4], ah[4], al[4];
        mma::ldsm_x4(a, q_lane + kk * 8);
        split_all(a, ah, al);
        uint32_t bh[T::kNB / 2][4], bl[T::kNB / 2][4];
#pragma unroll
        for (int np = 0; np < T::kNB / 2; ++np) {
          uint32_t bk[4];
          mma::ldsm_x4(bk, ks + np * 16 * kLd + k_off + kk * 8);
          split_all(bk, bh[np], bl[np]);
        }
        // the small terms first, then the large one, each over every
        // 8-key block (independent accumulators between dependent products)
#pragma unroll
        for (int np = 0; np < T::kNB / 2; ++np) {
          mma_tf32(r[2 * np], al, bh[np][0], bh[np][1]);
          mma_tf32(r[2 * np + 1], al, bh[np][2], bh[np][3]);
        }
#pragma unroll
        for (int np = 0; np < T::kNB / 2; ++np) {
          mma_tf32(r[2 * np], ah, bl[np][0], bl[np][1]);
          mma_tf32(r[2 * np + 1], ah, bl[np][2], bl[np][3]);
        }
#pragma unroll
        for (int np = 0; np < T::kNB / 2; ++np) {
          mma_tf32(r[2 * np], ah, bh[np][0], bh[np][1]);
          mma_tf32(r[2 * np + 1], ah, bh[np][2], bh[np][3]);
        }
      }
#pragma unroll
      for (int nb = 0; nb < T::kNB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] += r[nb][e];
    }
    if constexpr (kW > 1) {
      // the shares, in fragment order (lane-consecutive float4: no bank
      // conflicts), then the row group's sum in warp order
#pragma unroll
      for (int nb = 0; nb < T::kNB; ++nb)
        part[(warp * T::kNB + nb) * 32 + lane] =
            make_float4(s[nb][0], s[nb][1], s[nb][2], s[nb][3]);
      mma::bar_sync(1 + rg, kW * 32);
#pragma unroll
      for (int nb = 0; nb < T::kNB; ++nb) {
        float4 x = group_part[nb * 32];
#pragma unroll
        for (int w = 1; w < kW; ++w) {
          const float4 y = group_part[(w * T::kNB + nb) * 32];
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
    }

    // online softmax over the tile, base 2: element e of block nb is row
    // g + 8 * (e / 2), key k0 + 8 * nb + 2t + e % 2. The first tile holds
    // a valid key of every stored row, so m is finite from then on.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nb = 0; nb < T::kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * nb + 2 * t + (e & 1);
        const bool valid =
            key < rows && (pack == 1 || key / N == sample[e >> 1]);
        s[nb][e] = valid ? s[nb][e] * sl2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
      }
    float corr[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int nb = 0; nb < T::kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nb][e] - m[e >> 1]);  // 0 where s = -inf
        rowsum[e >> 1] += p;
        s[nb][e] = p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rowsum[r];

    mma::cp_async_wait<0>();
    // V of tile j has landed, and every warp is done with K of tile j: K
    // of tile j + 1 loads while p.v is computed
    __syncthreads();
    if (j + 1 < ntiles) {
      stage<kBK, kC, T::kThreads>(kb, ks, k0 + kBK, rows, C, tid);
      mma::cp_async_commit();
    }

    // acc = acc * corr + p.v over this warp's columns: each 8-column
    // block's products over the tile's keys go to fresh registers (see s)
    // and join the rescaled accumulator in one f32 multiply-add. The A
    // fragment's column t is key 2t and column t + 4 key 2t + 1, which the
    // C fragment of s holds as (c0, c1) of row g and (c2, c3) of row g + 8.
    if (steps) {
      uint32_t ph[T::kNB][4], pl[T::kNB][4];
#pragma unroll
      for (int kk = 0; kk < T::kNB; ++kk) {
        const uint32_t pa[4] = {
            __float_as_uint(s[kk][0]), __float_as_uint(s[kk][2]),
            __float_as_uint(s[kk][1]), __float_as_uint(s[kk][3])};
        split_all(pa, ph[kk], pl[kk]);
      }
#pragma unroll
      for (int nb = 0; nb < T::kON; ++nb) {
        float r[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < T::kNB; ++kk) {
          const float* vrow = vs + 8 * kk * kLd + v_off + nb * 8;
          uint32_t bh[2], bl[2];
          split(vrow[0], bh[0], bl[0]);
          split(vrow[kLd], bh[1], bl[1]);
          mma_tf32(r, pl[kk], bh[0], bh[1]);
          mma_tf32(r, ph[kk], bl[0], bl[1]);
          mma_tf32(r, ph[kk], bh[0], bh[1]);
        }
        acc[nb][0] = fmaf(acc[nb][0], corr[0], r[0]);
        acc[nb][1] = fmaf(acc[nb][1], corr[0], r[1]);
        acc[nb][2] = fmaf(acc[nb][2], corr[1], r[2]);
        acc[nb][3] = fmaf(acc[nb][3], corr[1], r[3]);
      }
    }
  }

  // o = acc / l for rows below the group's and columns below C
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* ob = o + off;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_g + 8 * r;
    if (row >= rows) continue;
    float* orow = ob + (size_t)row * C;
#pragma unroll
    for (int nb = 0; nb < T::kON; ++nb) {
      const int c = c0 + 8 * nb + 2 * t;  // even, and C is a multiple of 4
      if (c < C)
        *reinterpret_cast<float2*>(orow + c) = make_float2(
            acc[nb][2 * r] / l[r], acc[nb][2 * r + 1] / l[r]);
    }
    if (lse != nullptr && wc == 0 && t == 0)
      lse[(size_t)b0 * N + row] = m[r] * kLn2 + logf(l[r]);
  }
}

template <int kC, int kW, int kBK, int kWarps = 8>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int N, int C, float scale,
                   cudaStream_t stream) {
  using T = Tiling<kC, kW, kBK, kWarps>;
  // samples a tile: as many as fit both a query tile and a key tile, where
  // that is two or more
  constexpr int kTile = T::kBQ < kBK ? T::kBQ : kBK;
  const int pack = N <= kTile / 2 ? kTile / N : 1;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_tf32x3_kernel<kC, kW, kBK, kWarps>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
  if (e != cudaSuccess) return e;
  dim3 grid((pack * N + T::kBQ - 1) / T::kBQ, (B + pack - 1) / pack);
  flash_fwd_tf32x3_kernel<kC, kW, kBK, kWarps>
      <<<grid, T::kThreads, T::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), B, N, C, pack, scale);
  return cudaGetLastError();
}

}  // namespace

// As itsd_flash_attention (csrc/flash_attention.cu), for f32 only (dtype
// must be ITSD_F32): q, k, v, o: [B, N, C] contiguous f32; lse: [B, N]
// f32, or null for the plain forward. Needs C % 4 == 0, C <= 1024 and
// 16-byte aligned q, k, v, o. Any N >= 1.
// Returns the first CUDA error of the launch, or 0.
extern "C" int itsd_flash_attention_tf32x3(const void* q, const void* k,
                                           const void* v, void* o, void* lse,
                                           int B, int N, int C, float scale,
                                           int dtype, void* stream) {
  if (dtype != ITSD_F32 || B <= 0 || B > 65535 || N <= 0 || C <= 0 ||
      C > kMaxC || C % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 64)
    return (int)launch<64, 1, 64>(q, k, v, o, lse, B, N, C, scale, s);
  if (C <= 128)
    return (int)launch<128, 1, 64>(q, k, v, o, lse, B, N, C, scale, s);
  if (C <= 256)
    return (int)launch<256, 2, 16, 16>(q, k, v, o, lse, B, N, C, scale, s);
  if (C <= 384)
    return (int)launch<384, 2, 32>(q, k, v, o, lse, B, N, C, scale, s);
  if (C <= 512)
    return (int)launch<512, 4, 16, 16>(q, k, v, o, lse, B, N, C, scale, s);
  return (int)launch<1024, 8, 16>(q, k, v, o, lse, B, N, C, scale, s);
}


