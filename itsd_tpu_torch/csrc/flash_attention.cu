// Single-head flash attention forward: o = softmax(q k^T * scale) v over
// [B, N, C], with an optional f32 per-row log-sum-exp [B, N].
//
// Replaces the TPU kernel itsd_tpu/kernels/attention.py:_flash_fwd_kernel
// (launched by _flash_forward for _attention_flash and
// _attention_flash_stats). Same arithmetic: q.k^T with f32 accumulation,
// an online softmax with f32 running max m, denominator l and accumulator,
// p rounded to the input dtype before the p.v product, o = acc / l and
// lse = m + log(l).
//
// Bound on the card: at the UNet's shape (B=8, N=256, C=256, bf16) the call
// does 0.54 GFLOP and must move 4.2 MB; at 989 TFLOP/s and 3.35 TB/s the
// least time is ~1.25 us, set by the bytes. This version does its products
// on the CUDA cores in f32 FMA (no tensor cores), so it is bound by
// shared-memory reads and FMA throughput, far above that least time. With
// only B*N/16 blocks (128 at the UNet's shape, one per SM), little latency
// is hidden by other warps, so each thread issues all its global loads of a
// tile before it stores any of them to shared memory: one memory latency a
// tile, not one per element.
//
// Design: one block of 8 warps per (sample, 16-row query tile). The query
// tile stays in shared memory as f32; the block walks the keys in tiles of
// 32, staging K and V in shared memory, 4 elements per load. K rows are
// padded to C + 4 floats, so that lane j reads 4 channels of key j in one
// float4 and the 8 lanes of a quarter-warp hit distinct banks. Each warp
// owns 2 query rows: lane j computes the scores of key j against both rows
// (the q reads are broadcasts), the row max and sum are warp shuffles, and
// p reaches the p.v loop by shuffle, so no score tile is stored. The
// accumulator lives in registers: lane l holds columns l, l+32, ... of its
// warp's 2 rows (8 floats a row at C=256, 16 at C=512). The UNet's C=256
// has an instantiation of its own, so that its index arithmetic folds at
// compile time; one more takes any C <= 512. Shared memory is
// (16*C + 32*(C+4) + 32*C)*4 bytes, 161 KB at C=512, so the wrapper raises
// the dynamic shared-memory limit. Rows and keys past N are masked, so any
// N works (the UNet's middle block has N=16).

#include <math.h>

#include "attention_tiles.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 2;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBK = 32;                     // keys per tile: one per lane
constexpr int kPad = 4;  // K rows padded to C + 4 floats, so that the
                         // float4 reads of 8 lanes (8 keys) hit 32 banks
constexpr int kMaxC = 512;

size_t smem_bytes(int C) {
  return (size_t)(kBQ * C + kBK * (C + kPad) + kBK * C) * sizeof(float);
}

// Stage query rows [q0, q0 + kBQ) into qs [kBQ][C] as f32. Each thread
// issues kBatch loads before it stores any of them.
template <int kBatch, typename T>
__device__ __forceinline__ void stage_q(const T* __restrict__ q, float* qs,
                                        int q0, int N, int C, int tid) {
  const int n4 = kBQ * C / 4;
  for (int base = 0; base < n4; base += kThreads * kBatch) {
    float4 val[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kThreads + tid;
      if (i < n4) val[u] = load_group(q, i, q0, N, C);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kThreads + tid;
      if (i < n4) reinterpret_cast<float4*>(qs)[i] = val[u];
    }
  }
}

// Stage key rows [k0, k0 + kBK) of K into ks [kBK][C + kPad] and of V into
// vs [kBK][C], as f32, zeros past N (p is 0 there, and 0*0 = 0).
// Each thread issues the loads of kBatch groups of K and of V before it
// stores any of them.
template <int kBatch, typename T>
__device__ __forceinline__ void stage_kv(const T* __restrict__ k,
                                         const T* __restrict__ v, float* ks,
                                         float* vs, int k0, int N, int C,
                                         int tid) {
  const int n4 = kBK * C / 4;
  for (int base = 0; base < n4; base += kThreads * kBatch) {
    float4 kval[kBatch], vval[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kThreads + tid;
      if (i < n4) {
        kval[u] = load_group(k, i, k0, N, C);
        vval[u] = load_group(v, i, k0, N, C);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kThreads + tid;
      if (i >= n4) continue;
      const int j = 4 * i / C, c = 4 * i - j * C;
      *reinterpret_cast<float4*>(ks + j * (C + kPad) + c) = kval[u];
      reinterpret_cast<float4*>(vs)[i] = vval[u];
    }
  }
}

// kC: the channel count fixed at compile time (the UNet's 256), so that
// index arithmetic folds and loops unroll; 0 takes any C <= kMaxC from
// `c_arg`. kChunks: accumulator columns a lane holds per row.
template <typename T, bool kLse, int kC>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int N, int c_arg, float scale) {
  static_assert(kC % 32 == 0 && kC <= kMaxC, "kC: a multiple of 32");
  constexpr int kChunks = (kC ? kC : kMaxC) / 32;
  // 4-element loads a thread has in flight at once: fewer where the
  // accumulator is larger, so that the kernel does not spill
  constexpr int kBatch = kChunks > 8 ? 4 : 8;
  const int C = kC ? kC : c_arg;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBQ][C]
  float* ks = qs + kBQ * C;                     // [kBK][C + kPad]
  float* vs = ks + kBK * (C + kPad);            // [kBK][C]

  const int b = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t off = (size_t)b * N * C;
  const T* qb = q + off;
  const T* kb = k + off;
  const T* vb = v + off;

  stage_q<kBatch>(qb, qs, q0, N, C, tid);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kChunks];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) acc[r][ch] = 0.f;
  }
  const float* qw = qs + warp * kRowsPerWarp * C;

  for (int k0 = 0; k0 < N; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and q is staged)
    stage_kv<kBatch>(kb, vb, ks, vs, k0, N, C, tid);
    __syncthreads();

    // scores of key k0+lane against this warp's rows, in two partial sums
    // a row (channel groups c..c+3 and c+4..c+7 of every 8), so that four
    // FMA chains run side by side
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.f;
    const float* krow = ks + lane * (C + kPad);
    int c = 0;
#pragma unroll 4
    for (; c + 8 <= C; c += 8) {
      const float4 ka = *reinterpret_cast<const float4*>(krow + c);
      const float4 kb4 = *reinterpret_cast<const float4*>(krow + c + 4);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float* qr = qw + r * C + c;
        s[r][0] = dot4(*reinterpret_cast<const float4*>(qr), ka, s[r][0]);
        s[r][1] = dot4(*reinterpret_cast<const float4*>(qr + 4), kb4,
                       s[r][1]);
      }
    }
    if (c < C) {  // C % 8 == 4: one group left
      const float4 ka = *reinterpret_cast<const float4*>(krow + c);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        s[r][0] = dot4(*reinterpret_cast<const float4*>(qw + r * C + c), ka,
                       s[r][0]);
    }

    // online softmax; the first tile always holds a valid key (k0 < N), so
    // m is finite from then on and exp(m_prev - m_new) is never NaN
    const bool valid = k0 + lane < N;
    float p[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float sr = valid ? (s[r][0] + s[r][1]) * scale : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float corr = expf(m[r] - m_new);
      const float pr = valid ? expf(sr - m_new) : 0.f;
      l[r] = l[r] * corr + warp_sum(pr);
      m[r] = m_new;
      p[r] = round_to<T>(pr);
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch) acc[r][ch] *= corr;
    }

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pj[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        pj[r] = __shfl_sync(0xffffffffu, p[r], j);
      const float* vrow = vs + j * C;
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch) {
        const int c = lane + 32 * ch;
        if (c < C) {
          const float vv = vrow[c];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r)
            acc[r][ch] = fmaf(pj[r], vv, acc[r][ch]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + warp * kRowsPerWarp + r;
    if (row >= N) continue;
    T* orow = o + off + (size_t)row * C;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      const int c = lane + 32 * ch;
      if (c < C) orow[c] = from_f32<T>(acc[r][ch] / l[r]);
    }
    if (kLse && lane == 0) lse[(size_t)b * N + row] = m[r] + logf(l[r]);
  }
}

template <typename T, bool kLse, int kC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int N, int C, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(C);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, kLse, kC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((N + kBQ - 1) / kBQ, B);
  flash_fwd_kernel<T, kLse, kC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), N, C, scale);
  return cudaGetLastError();
}

template <typename T, int kC>
cudaError_t dispatch_lse(const void* q, const void* k, const void* v,
                         void* o, void* lse, int B, int N, int C,
                         float scale, cudaStream_t s) {
  return lse ? launch<T, true, kC>(q, k, v, o, lse, B, N, C, scale, s)
             : launch<T, false, kC>(q, k, v, o, lse, B, N, C, scale, s);
}

template <typename T>
cudaError_t dispatch_c(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int N, int C, float scale,
                       cudaStream_t s) {
  return C == 256 ? dispatch_lse<T, 256>(q, k, v, o, lse, B, N, C, scale, s)
                  : dispatch_lse<T, 0>(q, k, v, o, lse, B, N, C, scale, s);
}

}  // namespace

// q, k, v, o: [B, N, C] contiguous (f32 or bf16, per `dtype`); lse: [B, N]
// f32, or null for the plain forward. Needs C % 4 == 0, C <= 512 and
// 16-byte aligned q, k, v.
// Returns the first CUDA error of the launch, or 0.
extern "C" int itsd_flash_attention(const void* q, const void* k,
                                    const void* v, void* o, void* lse, int B,
                                    int N, int C, float scale, int dtype,
                                    void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || C <= 0 || C > kMaxC || C % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (dtype) {
    case ITSD_F32:
      e = dispatch_c<float>(q, k, v, o, lse, B, N, C, scale, s);
      break;
    case ITSD_BF16:
      e = dispatch_c<__nv_bfloat16>(q, k, v, o, lse, B, N, C, scale, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)e;
}
