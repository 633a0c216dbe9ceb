// Single-head flash attention backward over [B, N, C]: two kernels, one
// for dq and one for dk and dv, as on the TPU.
//
// Replace the TPU kernels itsd_tpu/kernels/attention.py:_flash_bwd_dq_kernel
// and _flash_bwd_dkv_kernel (launched by _attention_flash_bwd). Same
// arithmetic: p = exp(q.k^T * scale - lse) recomputed in f32 from the
// forward's per-row log-sum-exp, dp = dO.v^T in f32, ds = p * (dp - dd)
// with dd = rowsum(dO * O) - dlse taken by the caller, then
//   dq = scale * ds.k     with ds rounded to the input dtype first,
//   dv = p^T.dO           with p rounded to the input dtype first,
//   dk = scale * ds^T.q   with ds rounded to the input dtype first,
// all sums in f32. Each output row belongs to one block, which loops over
// the other side's tiles, so no sum crosses blocks and there are no
// atomics: the gradients are the same from run to run.
//
// Bound on the card: at the UNet's train shape (B=128, N=256, C=256, bf16)
// the dq kernel does 3 products of 2*B*N^2*C (12.9 GFLOP) and must move
// 5 tensors of 16.8 MB plus lse and dd; the dk/dv kernel does 4 products
// (17.2 GFLOP) and moves 6 tensors. At 989 TFLOP/s and 3.35 TB/s the least
// times are ~0.025 and ~0.030 ms, set by the bytes. This version does its
// products on the CUDA cores in f32 FMA, reading its operands from shared
// memory, so it is bound by shared-memory reads and FMA issue, far above
// those least times. The tensor cores are later work.
//
// Design (the forward's layout, csrc/flash_attention.cu): blocks of 8 warps.
// * dq: one block per (sample, 16-row query tile). q and dO of the tile
//   stay in shared memory; the block walks the keys in tiles of 32, staging
//   K and V with rows padded to C + 4 floats. Each warp owns 2 query rows;
//   lane j computes s and dp of key j against both rows (the q and dO reads
//   are broadcasts), so ds never leaves registers; ds reaches the ds.k loop
//   by shuffle. Lane l accumulates columns l, l+32, ... of dq for its
//   warp's 2 rows (16 floats at C=256).
// * dk/dv: one block per (sample, 16-key tile). K and V of the tile stay in
//   shared memory; the block walks the queries in tiles of 32, staging q
//   and dO with padded rows. Each warp owns 2 keys; lane j computes s and
//   dp of query j against both keys, with query j's lse and dd, and p and
//   ds reach the accumulation loop by shuffle. Lane l accumulates columns
//   l, l+32, ... of dk and dv for its warp's 2 keys (32 floats at C=256).
// Both take f32 or bf16, C % 4 == 0 up to 512, and any N >= 1: rows past N
// are staged as zeros and masked (p = 0 for keys or queries past N), and
// only rows below N are written. C=256, the UNet's width at attention, has
// an instantiation of its own; one more takes any C <= 512. Shared memory
// is (2*16*C + 2*32*(C+4))*4 bytes, 197 KB at C=512, so the wrapper raises
// the dynamic shared-memory limit.

#include <math.h>

#include "attention_tiles.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 2;
constexpr int kOwn = kWarps * kRowsPerWarp;  // rows a block owns: 16
constexpr int kWalk = 32;  // rows of the other side per tile: one per lane
constexpr int kPad = 4;    // walked rows padded to C + 4 floats, so that the
                           // float4 reads of 8 lanes (8 rows) hit 32 banks
constexpr int kMaxC = 512;

size_t smem_bytes(int C) {
  return (size_t)(2 * kOwn * C + 2 * kWalk * (C + kPad)) * sizeof(float);
}

// Two dot products of the lane's walked rows (a_row, b_row, padded) with
// the warp's owned rows r of the shared arrays ao, bo ([kOwn][C], rows
// broadcast to the warp): sa[r] = ao_r . a_row and sb[r] = bo_r . b_row,
// each in two partial sums (channel groups c..c+3 and c+4..c+7 of every 8),
// so that four FMA chains run side by side.
__device__ __forceinline__ void dots(const float* ao, const float* bo,
                                     const float* a_row, const float* b_row,
                                     int C, float (&sa)[kRowsPerWarp],
                                     float (&sb)[kRowsPerWarp]) {
  float pa[kRowsPerWarp][2], pb[kRowsPerWarp][2];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
    pa[r][0] = pa[r][1] = pb[r][0] = pb[r][1] = 0.f;
  int c = 0;
#pragma unroll 2
  for (; c + 8 <= C; c += 8) {
    const float4 a0 = *reinterpret_cast<const float4*>(a_row + c);
    const float4 a1 = *reinterpret_cast<const float4*>(a_row + c + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(b_row + c);
    const float4 b1 = *reinterpret_cast<const float4*>(b_row + c + 4);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float* ar = ao + r * C + c;
      const float* br = bo + r * C + c;
      pa[r][0] = dot4(*reinterpret_cast<const float4*>(ar), a0, pa[r][0]);
      pa[r][1] = dot4(*reinterpret_cast<const float4*>(ar + 4), a1, pa[r][1]);
      pb[r][0] = dot4(*reinterpret_cast<const float4*>(br), b0, pb[r][0]);
      pb[r][1] = dot4(*reinterpret_cast<const float4*>(br + 4), b1, pb[r][1]);
    }
  }
  if (c < C) {  // C % 8 == 4: one group left
    const float4 a0 = *reinterpret_cast<const float4*>(a_row + c);
    const float4 b0 = *reinterpret_cast<const float4*>(b_row + c);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      pa[r][0] = dot4(*reinterpret_cast<const float4*>(ao + r * C + c), a0,
                      pa[r][0]);
      pb[r][0] = dot4(*reinterpret_cast<const float4*>(bo + r * C + c), b0,
                      pb[r][0]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    sa[r] = pa[r][0] + pa[r][1];
    sb[r] = pb[r][0] + pb[r][1];
  }
}

// kC: the channel count fixed at compile time (256), so that index
// arithmetic folds and loops unroll; 0 takes any C <= kMaxC from `c_arg`.
// 2 blocks fit an SM at C=256 (99 KB of shared memory each), so that
// instantiation is held to 128 registers a thread.
template <typename T, int kC>
__global__ void __launch_bounds__(kThreads, kC == 256 ? 2 : 1)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dd, T* __restrict__ dq,
                        int N, int c_arg, float scale) {
  static_assert(kC % 32 == 0 && kC <= kMaxC, "kC: a multiple of 32");
  constexpr int kChunks = (kC ? kC : kMaxC) / 32;
  constexpr int kBatch = kChunks > 8 ? 2 : 4;  // loads in flight: 2*kBatch
  const int C = kC ? kC : c_arg;
  const int ld = C + kPad;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kOwn][C]
  float* dos = qs + kOwn * C;                   // [kOwn][C]
  float* ks = dos + kOwn * C;                   // [kWalk][C + kPad]
  float* vs = ks + kWalk * ld;                  // [kWalk][C + kPad]

  const int b = blockIdx.y, q0 = blockIdx.x * kOwn;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t off = (size_t)b * N * C;

  stage_rows2<kOwn, kThreads, kBatch>(q + off, dout + off, qs, dos, C, q0, N,
                                      C, tid);
  float lse_r[kRowsPerWarp], dd_r[kRowsPerWarp];
  float acc[kRowsPerWarp][kChunks];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + warp * kRowsPerWarp + r;
    lse_r[r] = row < N ? lse[(size_t)b * N + row] : 0.f;
    dd_r[r] = row < N ? dd[(size_t)b * N + row] : 0.f;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) acc[r][ch] = 0.f;
  }
  const float* qw = qs + warp * kRowsPerWarp * C;
  const float* dow = dos + warp * kRowsPerWarp * C;

  for (int k0 = 0; k0 < N; k0 += kWalk) {
    __syncthreads();  // the previous tile is consumed (and q, dO staged)
    stage_rows2<kWalk, kThreads, kBatch>(k + off, v + off, ks, vs, ld, k0, N,
                                         C, tid);
    __syncthreads();

    float s[kRowsPerWarp], dp[kRowsPerWarp];
    dots(qw, dow, ks + lane * ld, vs + lane * ld, C, s, dp);
    const bool valid = k0 + lane < N;
    float ds[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float p = valid ? expf(s[r] * scale - lse_r[r]) : 0.f;
      ds[r] = round_to<T>(p * (dp[r] - dd_r[r]));
    }

    const int nk = min(kWalk, N - k0);
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      float dsj[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        dsj[r] = __shfl_sync(0xffffffffu, ds[r], j);
      const float* krow = ks + j * ld;
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch) {
        const int c = lane + 32 * ch;
        if (c < C) {
          const float kv = krow[c];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r)
            acc[r][ch] = fmaf(dsj[r], kv, acc[r][ch]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + warp * kRowsPerWarp + r;
    if (row >= N) continue;
    T* out = dq + off + (size_t)row * C;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      const int c = lane + 32 * ch;
      if (c < C) out[c] = from_f32<T>(scale * acc[r][ch]);
    }
  }
}

template <typename T, int kC>
__global__ void __launch_bounds__(kThreads, kC == 256 ? 2 : 1)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dd, T* __restrict__ dk,
                         T* __restrict__ dv, int N, int c_arg, float scale) {
  static_assert(kC % 32 == 0 && kC <= kMaxC, "kC: a multiple of 32");
  constexpr int kChunks = (kC ? kC : kMaxC) / 32;
  // 2 groups of q and of dO in flight a thread: with 4, the C=256
  // instantiation spills at its 128 registers (ptxas, H100)
  constexpr int kBatch = 2;
  const int C = kC ? kC : c_arg;
  const int ld = C + kPad;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [kOwn][C]
  float* vs = ks + kOwn * C;                    // [kOwn][C]
  float* qs = vs + kOwn * C;                    // [kWalk][C + kPad]
  float* dos = qs + kWalk * ld;                 // [kWalk][C + kPad]

  const int b = blockIdx.y, k0 = blockIdx.x * kOwn;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t off = (size_t)b * N * C;

  stage_rows2<kOwn, kThreads, kBatch>(k + off, v + off, ks, vs, C, k0, N, C,
                                      tid);
  float dk_acc[kRowsPerWarp][kChunks], dv_acc[kRowsPerWarp][kChunks];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) dk_acc[r][ch] = dv_acc[r][ch] = 0.f;
  const float* kw = ks + warp * kRowsPerWarp * C;
  const float* vw = vs + warp * kRowsPerWarp * C;

  for (int q0 = 0; q0 < N; q0 += kWalk) {
    const int row = q0 + lane;  // this lane's query
    const bool valid = row < N;
    const float lse_j = valid ? lse[(size_t)b * N + row] : 0.f;
    const float dd_j = valid ? dd[(size_t)b * N + row] : 0.f;
    __syncthreads();  // the previous tile is consumed (and K, V staged)
    stage_rows2<kWalk, kThreads, kBatch>(q + off, dout + off, qs, dos, ld,
                                         q0, N, C, tid);
    __syncthreads();

    float s[kRowsPerWarp], dp[kRowsPerWarp];
    dots(kw, vw, qs + lane * ld, dos + lane * ld, C, s, dp);
    float p[kRowsPerWarp], ds[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float pf = valid ? expf(s[r] * scale - lse_j) : 0.f;
      p[r] = round_to<T>(pf);
      ds[r] = round_to<T>(pf * (dp[r] - dd_j));
    }

    const int nq = min(kWalk, N - q0);
#pragma unroll 2
    for (int j = 0; j < nq; ++j) {
      float pj[kRowsPerWarp], dsj[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        pj[r] = __shfl_sync(0xffffffffu, p[r], j);
        dsj[r] = __shfl_sync(0xffffffffu, ds[r], j);
      }
      const float* qrow = qs + j * ld;
      const float* dorow = dos + j * ld;
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch) {
        const int c = lane + 32 * ch;
        if (c < C) {
          const float qv = qrow[c], dov = dorow[c];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            dv_acc[r][ch] = fmaf(pj[r], dov, dv_acc[r][ch]);
            dk_acc[r][ch] = fmaf(dsj[r], qv, dk_acc[r][ch]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int key = k0 + warp * kRowsPerWarp + r;
    if (key >= N) continue;
    T* dk_out = dk + off + (size_t)key * C;
    T* dv_out = dv + off + (size_t)key * C;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      const int c = lane + 32 * ch;
      if (c < C) {
        dk_out[c] = from_f32<T>(scale * dk_acc[r][ch]);
        dv_out[c] = from_f32<T>(dv_acc[r][ch]);
      }
    }
  }
}

bool bad_shape(int B, int N, int C) {
  return B <= 0 || B > 65535 || N <= 0 || C <= 0 || C > kMaxC || C % 4 != 0;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int C) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes(C));
}

template <typename T, int kC>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* dd,
                      void* dq, int B, int N, int C, float scale,
                      cudaStream_t stream) {
  cudaError_t e = prepare(flash_bwd_dq_kernel<T, kC>, C);
  if (e != cudaSuccess) return e;
  dim3 grid((N + kOwn - 1) / kOwn, B);
  flash_bwd_dq_kernel<T, kC><<<grid, kThreads, smem_bytes(C), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dd),
      static_cast<T*>(dq), N, C, scale);
  return cudaGetLastError();
}

template <typename T, int kC>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* dd,
                       void* dk, void* dv, int B, int N, int C, float scale,
                       cudaStream_t stream) {
  cudaError_t e = prepare(flash_bwd_dkv_kernel<T, kC>, C);
  if (e != cudaSuccess) return e;
  dim3 grid((N + kOwn - 1) / kOwn, B);
  flash_bwd_dkv_kernel<T, kC><<<grid, kThreads, smem_bytes(C), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dd),
      static_cast<T*>(dk), static_cast<T*>(dv), N, C, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dq_by_c(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* dd,
                    void* dq, int B, int N, int C, float scale,
                    cudaStream_t s) {
  return C == 256
             ? launch_dq<T, 256>(q, k, v, dout, lse, dd, dq, B, N, C, scale, s)
             : launch_dq<T, 0>(q, k, v, dout, lse, dd, dq, B, N, C, scale, s);
}

template <typename T>
cudaError_t dkv_by_c(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* dd,
                     void* dk, void* dv, int B, int N, int C, float scale,
                     cudaStream_t s) {
  return C == 256 ? launch_dkv<T, 256>(q, k, v, dout, lse, dd, dk, dv, B, N,
                                       C, scale, s)
                  : launch_dkv<T, 0>(q, k, v, dout, lse, dd, dk, dv, B, N, C,
                                     scale, s);
}

}  // namespace

// q, k, v, dout, dq: [B, N, C] contiguous (f32 or bf16, per `dtype`); lse,
// dd: [B, N] f32 (dd = rowsum(dout * o) - dlse). Needs C % 4 == 0,
// C <= 512 and 16-byte aligned q, k, v, dout.
// Returns the first CUDA error of the launch, or 0.
extern "C" int itsd_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* dd, void* dq, int B, int N,
                                 int C, float scale, int dtype,
                                 void* stream) {
  if (bad_shape(B, N, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ITSD_F32:
      return (int)dq_by_c<float>(q, k, v, dout, lse, dd, dq, B, N, C, scale,
                                 s);
    case ITSD_BF16:
      return (int)dq_by_c<__nv_bfloat16>(q, k, v, dout, lse, dd, dq, B, N, C,
                                         scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// As itsd_flash_bwd_dq, writing dk and dv ([B, N, C], the input dtype).
extern "C" int itsd_flash_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* dd, void* dk,
                                  void* dv, int B, int N, int C, float scale,
                                  int dtype, void* stream) {
  if (bad_shape(B, N, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ITSD_F32:
      return (int)dkv_by_c<float>(q, k, v, dout, lse, dd, dk, dv, B, N, C,
                                  scale, s);
    case ITSD_BF16:
      return (int)dkv_by_c<__nv_bfloat16>(q, k, v, dout, lse, dd, dk, dv, B,
                                          N, C, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
