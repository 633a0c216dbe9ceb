// GroupNorm (+ optional swish) over NCHW activations.
//
// Replaces the TPU kernel itsd_tpu/kernels/groupnorm.py:_gn_kernel (launched
// by groupnorm_swish_pallas). It is held against the two-pass reference
// groupnorm_swish_xla (same file, 32-44), not against the Pallas kernel's
// one-pass E[x^2]-mean^2 variance.
//
// Bound on the card: bytes. The work is ~10 flops per element, far below
// Hopper's ~20 flops/byte f32 ridge, so the least time is one read of x and
// one write of y. At the CIFAR-10 UNet's train batch (128) the 32x32 calls
// move 17-50 MB each (5-15 us of HBM time); at its eval batch (8) a call
// moves at most 3 MB, about 1 us, so a launch costs more than either bound.
//
// Design. In NCHW one (sample, group) pair is ONE contiguous span of
// cg*HW elements (cg = C/G channels), and the spans of a tensor follow one
// another. Each block reads its part of the x once from device memory,
// 16 bytes a load (8 bf16 or 4 f32; a scalar path takes HW that is not a
// multiple of that or an unaligned pointer), with cp.async straight into
// shared memory, and takes both passes of the two-pass f32 statistics
// (sum x for the mean, then sum (x - mean)^2 for the variance) over the
// held values. Then the span's cg channels get a = weight * rsqrt(var +
// eps) and shift = bias - mean * a once, in shared memory, and the last
// pass is one FMA (and the swish) per element, stored 16 bytes at a time.
// The launch plan is picked from the span alone (plan(), below), so the
// sums are taken in the same order on every run and every card:
// * a thread takes 1 vector while the card holds a thread for each (every
//   eval call), up to 4 on larger calls;
// * spans of up to 32 threads' worth (the CIFAR path's 4x4 and 8x8 stages)
//   get a team of 2-32 threads each, several spans a block of 32-256
//   threads (at least 2 blocks an SM where the call allows), the sums by
//   shuffle within the team;
// * larger spans (up to the CIFAR path's 12288 elements, 24 KB in bf16)
//   get one block each, of up to 1024 threads, the sums by warp shuffle and
//   one exchange through shared memory;
// * spans of 16384 elements and more are split over a thread-block cluster
//   of 2-8 blocks (the 256x256 flagship's spans, up to 786,432 elements at
//   [B, 384, 256, 256], 1.5 MB in bf16) when there are too few spans to
//   fill the card or a span does not fit one block's shared memory. Each
//   block reduces its part; the cluster combines the partial sums through
//   distributed shared memory, every block adding the cluster's partials in
//   rank order, so no atomics are used, no sum crosses a launch, and the
//   result is the same from run to run. A part of at most 200 KB is held
//   in shared memory (bf16 at 786,432 / 8 = 192 KB); a larger part (f32 at
//   786,432 / 8 = 384 KB) is not held: its second and third reads come
//   again from memory, most of it from the 50 MB L2, which the cluster's
//   just-read span (3 MB) fits.
//
// GroupNorm over row shards (itsd_groupnorm_partial_stats and
// itsd_groupnorm_apply, below) replaces no TPU kernel of its own: under
// JAX's spatial sharding GSPMD splits the XLA GroupNorm
// (itsd_tpu/kernels/groupnorm.py:groupnorm_swish_xla) into per-shard
// partial sums and a cross-device reduction. When the seq ranks each hold
// some rows of an image, the two passes of the statistics need the sums of
// every rank: the stats kernel gives this rank's partial sum of a span (x,
// or (x - mean)^2 around a given mean), the caller all-reduces it, and the
// apply kernel normalizes with the global mean and rstd. Both are bound by
// bytes (one read of x; one read and one write), and use the plan above:
// the stats kernel is the fused kernel's reduction pass, a cluster's
// partials added in rank order (no atomics: the sum is the same from run
// to run); the apply kernel is its last pass, a grid-stride loop of 16-byte
// vectors.

#include <cooperative_groups.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "mma_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxTeamBlock = 256;        // threads of a block of small spans
constexpr int kMaxCluster = 8;            // the portable cluster size
constexpr int kSMs = 132;                 // an H100 SXM's SMs (the plan's
                                          // target: a constant, so that the
                                          // plan depends on the shape alone)
constexpr long long kResident = kSMs * 2048LL;  // threads the card holds
constexpr int kMinPart = 8192;            // elements: smallest cluster part
constexpr size_t kHoldBytes = 200 * 1024; // largest part held on chip
constexpr int kMaxVecsPerThread = 4;      // 16-byte vectors a thread, target

long long pow2_ceil(long long n) {
  long long p = 1;
  while (p < n) p *= 2;
  return p;
}

// How a launch covers the tensor: `nblk` blocks (a cluster) a span, or
// `spb` spans a block, each span (or part) walked by a team of `team`
// threads; `hold`: the block's part of x is held in shared memory.
struct Plan {
  int vec, team, threads, spb, nblk, part, blocks;
  bool hold;
  size_t smem;
};

Plan plan(long long spans, int span, int cg_, int itemsize, bool vec_ok) {
  Plan p{};
  p.vec = vec_ok ? 16 / itemsize : 1;
  p.nblk = 1;
  auto part_of = [&](int n) {
    const int per = (span + n - 1) / n;
    return (per + p.vec - 1) / p.vec * p.vec;
  };
  while (p.nblk < kMaxCluster &&
         ((size_t)part_of(p.nblk) * itemsize > kHoldBytes ||
          (spans * p.nblk < 2 * kSMs && span / (2 * p.nblk) >= kMinPart)))
    p.nblk *= 2;
  p.part = p.nblk > 1 ? part_of(p.nblk) : span;
  const int vecs = (p.part + p.vec - 1) / p.vec;
  // vectors a thread: 1 while the card holds a thread for each, so that a
  // small call's passes are short; up to 4 on a large one
  const long long vpt = std::min<long long>(
      kMaxVecsPerThread,
      pow2_ceil((spans * p.nblk * vecs + kResident - 1) / kResident));
  p.team = (int)std::min<long long>(
      kMaxThreads, std::max<long long>(2, pow2_ceil((vecs + vpt - 1) / vpt)));
  if (p.team <= 32) {  // several spans a block: at least 2 blocks an SM
    const long long per = spans * p.team / (2 * kSMs);
    int t = 32;
    while (t < kMaxTeamBlock && 2 * t <= per) t *= 2;
    p.threads = t;
    p.spb = t / p.team;
  } else {
    p.threads = p.team;
    p.spb = 1;
  }
  // the scalar path reads x from memory in every pass
  p.hold = p.vec > 1 && (size_t)p.spb * p.part * itemsize <= kHoldBytes;
  p.blocks = (int)(p.nblk > 1 ? spans * p.nblk
                              : (spans + p.spb - 1) / p.spb);
  const size_t data = p.hold ? (size_t)p.spb * p.part * itemsize : 0;
  p.smem = (data + 15) / 16 * 16 + (size_t)p.spb * cg_ * sizeof(float2);
  return p;
}

// kVec consecutive elements as f32: one 16-byte load when kVec > 1.
template <typename T, int kVec>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[kVec]) {
  if constexpr (kVec == 1) {
    f[0] = to_f32(*p);
  } else if constexpr (sizeof(T) == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    f[0] = u.x, f[1] = u.y, f[2] = u.z, f[3] = u.w;
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 h = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = h.x, f[2 * i + 1] = h.y;
    }
  }
}

// kVec f32 values stored as T: one 16-byte store when kVec > 1.
template <typename T, int kVec>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[kVec]) {
  if constexpr (kVec == 1) {
    *p = from_f32<T>(f[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(mma::pack_bf16(f[0], f[1]), mma::pack_bf16(f[2], f[3]),
                   mma::pack_bf16(f[4], f[5]), mma::pack_bf16(f[6], f[7]));
  }
}

// The sum of v over the team (all of the block when team > 32: then the
// block holds one team); every thread of the team gets it.
__device__ __forceinline__ float team_sum(float v, int team, float* scratch) {
  if (team > 32) return block_sum(v, scratch);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < team) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// With nblk > 1, the sum of v (each block's partial, the same in all its
// threads) over the cluster, added in rank order in every block; `slot`
// is this block's shared word for it.
__device__ __forceinline__ float cluster_sum(float v, int nblk, float* slot) {
  if (nblk == 1) return v;
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) *slot = v;
  cluster.sync();
  float total = 0.f;
  for (int r = 0; r < nblk; ++r) total += *cluster.map_shared_rank(slot, r);
  return total;
}

// kVec: elements a load (16 bytes, or 1 for the scalar path); kHold: the
// block's part of x is copied into shared memory once and the passes read
// it there, else every pass reads x from memory.
template <typename T, int kVec, bool kHold>
__global__ void __launch_bounds__(kMaxThreads)
    groupnorm_swish_kernel(const T* __restrict__ x,
                           const float* __restrict__ weight,
                           const float* __restrict__ bias, T* __restrict__ y,
                           long long spans, int span, int cg_, int HW, int G,
                           int team, int nblk, int part, float eps, int act) {
  __shared__ float scratch[32];
  __shared__ float slots[2];  // this block's partials, for the cluster
  extern __shared__ uint4 smem_gn[];
  const int tid = threadIdx.x;
  const int spb = blockDim.x / team;
  const int ti = tid / team, lt = tid % team;  // team, thread in the team
  // [lo, hi): the elements of x this block holds (absolute indices);
  // [mlo, mhi): those of this thread's team; s: the team's span
  long long s, lo, hi, mlo, mhi;
  if (nblk > 1) {
    const int rank = (int)cg::this_cluster().block_rank();
    s = blockIdx.x / nblk;
    lo = s * span + (long long)rank * part;
    hi = s * span + min((long long)span, (long long)(rank + 1) * part);
    lo = min(lo, hi);
    mlo = lo, mhi = hi;
  } else {
    const long long s0 = (long long)blockIdx.x * spb;
    s = s0 + ti;
    lo = s0 * span;
    hi = min(s0 + spb, spans) * span;
    mlo = min(s * span, hi), mhi = min((s + 1) * span, hi);
  }
  const int data_bytes =
      kHold ? (int)(((long long)spb * part * sizeof(T) + 15) / 16 * 16) : 0;
  float2* table = reinterpret_cast<float2*>(
      reinterpret_cast<char*>(smem_gn) + data_bytes);  // [spb][cg_]
  T* held = reinterpret_cast<T*>(smem_gn);             // [hi - lo]
  const T* src = kHold ? held : x + lo;  // the block's part: src[i - lo]

  if constexpr (kHold) {  // one read of x, 16 bytes a copy
    const int n = (int)((hi - lo) / kVec);
    for (int i = tid; i < n; i += blockDim.x)
      mma::cp_async16(held + (size_t)i * kVec, x + lo + (size_t)i * kVec,
                      true);
    mma::cp_async_commit();
    mma::cp_async_wait<0>();
    __syncthreads();
  }
  const int v0 = (int)((mlo - lo) / kVec), v1 = (int)((mhi - lo) / kVec);

  float sum = 0.f;
  for (int i = v0 + lt; i < v1; i += team) {
    float f[kVec];
    load_vec<T, kVec>(src + (size_t)i * kVec, f);
#pragma unroll
    for (int e = 0; e < kVec; ++e) sum += f[e];
  }
  sum = cluster_sum(team_sum(sum, team, scratch), nblk, &slots[0]);
  const float mean = sum / (float)span;

  float sq = 0.f;
  for (int i = v0 + lt; i < v1; i += team) {
    float f[kVec];
    load_vec<T, kVec>(src + (size_t)i * kVec, f);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float d = f[e] - mean;
      sq += d * d;
    }
  }
  sq = cluster_sum(team_sum(sq, team, scratch), nblk, &slots[1]);
  const float inv = rsqrtf(sq / (float)span + eps);

  // a and shift of the span's channels, once per channel
  if (s < spans) {
    const int c0 = (int)(s % G) * cg_;
    for (int c = lt; c < cg_; c += team) {
      const float a = weight[c0 + c] * inv;
      table[ti * cg_ + c] = make_float2(a, bias[c0 + c] - mean * a);
    }
  }
  __syncthreads();

  const float2* tc = table + ti * cg_;
  const int in_span0 = (int)(lo - s * span);  // where src starts in the span
  for (int i = v0 + lt; i < v1; i += team) {
    float f[kVec];
    load_vec<T, kVec>(src + (size_t)i * kVec, f);
    // the channel; a 16-byte vector lies in one (HW % kVec == 0)
    const float2 ab = tc[(in_span0 + i * kVec) / HW];
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      float u = fmaf(f[e], ab.x, ab.y);
      if (act) u = u * (1.f / (1.f + expf(-u)));
      f[e] = u;
    }
    store_vec<T, kVec>(y + lo + (size_t)i * kVec, f);
  }
  // no block leaves while another block of its cluster may still read
  // its slots
  if (nblk > 1) cg::this_cluster().sync();
}

template <typename T, int kVec, bool kHold>
cudaError_t launch(const Plan& p, const void* x, const void* w,
                   const void* b, void* y, long long spans, int span, int cg_,
                   int HW, int G, float eps, int act, cudaStream_t stream) {
  auto kernel = groupnorm_swish_kernel<T, kVec, kHold>;
  if (p.smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.blocks);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.nblk;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.nblk > 1 ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<T*>(y), spans, span, cg_, HW,
      G, p.team, p.nblk, p.part, eps, act);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w, const void* b, void* y,
                     int B, int C, int HW, int G, float eps, int act,
                     cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int cg_ = C / G;
  const int span = cg_ * HW;
  const long long spans = (long long)B * G;
  const bool vec_ok = HW % kVec == 0 &&
                      ((uintptr_t)x | (uintptr_t)y) % 16 == 0;
  const Plan p = plan(spans, span, cg_, sizeof(T), vec_ok);
  if (!vec_ok)
    return launch<T, 1, false>(p, x, w, b, y, spans, span, cg_, HW, G, eps,
                               act, stream);
  if (p.hold)
    return launch<T, kVec, true>(p, x, w, b, y, spans, span, cg_, HW, G, eps,
                                 act, stream);
  return launch<T, kVec, false>(p, x, w, b, y, spans, span, cg_, HW, G, eps,
                                act, stream);
}

// The stats kernel: out[s] = the f32 sum over span s of x, or with kSq of
// (x - mean[s])^2. The launch covers the spans as plan() says; the team of
// a span (or the cluster of its parts) reduces as the fused kernel does.
template <typename T, int kVec, bool kSq>
__global__ void __launch_bounds__(kMaxThreads)
    groupnorm_stats_kernel(const T* __restrict__ x,
                           const float* __restrict__ mean,
                           float* __restrict__ out, long long spans, int span,
                           int team, int nblk, int part) {
  __shared__ float scratch[32];
  __shared__ float slot;  // this block's partial, for the cluster
  const int tid = threadIdx.x;
  const int spb = blockDim.x / team;
  const int ti = tid / team, lt = tid % team;
  long long s, lo, hi;  // the team's span and its elements [lo, hi)
  int rank = 0;
  if (nblk > 1) {
    rank = (int)cg::this_cluster().block_rank();
    s = blockIdx.x / nblk;
    lo = s * span + (long long)rank * part;
    hi = s * span + min((long long)span, (long long)(rank + 1) * part);
    lo = min(lo, hi);
  } else {
    s = (long long)blockIdx.x * spb + ti;
    lo = min(s, spans) * span;
    hi = min(s + 1, spans) * span;
  }
  const float m = (kSq && s < spans) ? mean[s] : 0.f;
  float acc = 0.f;
  for (long long i = lo / kVec + lt; i < hi / kVec; i += team) {
    float f[kVec];
    load_vec<T, kVec>(x + i * kVec, f);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      if constexpr (kSq) {
        const float d = f[e] - m;
        acc += d * d;
      } else {
        acc += f[e];
      }
    }
  }
  acc = cluster_sum(team_sum(acc, team, scratch), nblk, &slot);
  if (s < spans && lt == 0 && rank == 0) out[s] = acc;
  // no block leaves while another block of its cluster may still read its
  // slot
  if (nblk > 1) cg::this_cluster().sync();
}

// The apply kernel: y = swish?((x - mean[s]) * rstd[s] * weight[c] +
// bias[c]) with the fused kernel's arithmetic (a = weight * rstd, shift =
// bias - mean * a, one FMA), kVec elements a thread and step.
template <typename T, int kVec>
__global__ void __launch_bounds__(256)
    groupnorm_apply_kernel(const T* __restrict__ x,
                           const float* __restrict__ mean,
                           const float* __restrict__ rstd,
                           const float* __restrict__ weight,
                           const float* __restrict__ bias, T* __restrict__ y,
                           long long n_vec, int C, int HW, int G, int act) {
  const int cg_ = C / G;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_vec; i += (long long)gridDim.x * blockDim.x) {
    const long long e0 = i * kVec;
    const long long bc = e0 / HW;  // b * C + c; a vector lies in one channel
    const int c = (int)(bc % C);
    const long long s = (bc / C) * G + c / cg_;
    const float a = weight[c] * rstd[s];
    const float shift = bias[c] - mean[s] * a;
    float f[kVec];
    load_vec<T, kVec>(x + e0, f);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      float u = fmaf(f[e], a, shift);
      if (act) u = u * (1.f / (1.f + expf(-u)));
      f[e] = u;
    }
    store_vec<T, kVec>(y + e0, f);
  }
}

template <typename T, int kVec, bool kSq>
cudaError_t launch_stats(const Plan& p, const void* x, const float* mean,
                         float* out, long long spans, int span,
                         cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.blocks);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.nblk;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.nblk > 1 ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, groupnorm_stats_kernel<T, kVec, kSq>, static_cast<const T*>(x),
      mean, out, spans, span, p.team, p.nblk, p.part);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_stats(const void* x, const void* mean, void* out, int B,
                           int C, int HW, int G, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int cg_ = C / G;
  const int span = cg_ * HW;
  const long long spans = (long long)B * G;
  const bool vec_ok = HW % kVec == 0 && (uintptr_t)x % 16 == 0;
  // the fused kernel's plan; nothing is held in shared memory here
  const Plan p = plan(spans, span, cg_, sizeof(T), vec_ok);
  const float* m = static_cast<const float*>(mean);
  float* o = static_cast<float*>(out);
  if (mean == nullptr)
    return vec_ok ? launch_stats<T, kVec, false>(p, x, m, o, spans, span,
                                                 stream)
                  : launch_stats<T, 1, false>(p, x, m, o, spans, span,
                                              stream);
  return vec_ok ? launch_stats<T, kVec, true>(p, x, m, o, spans, span, stream)
                : launch_stats<T, 1, true>(p, x, m, o, spans, span, stream);
}

template <typename T>
cudaError_t dispatch_apply(const void* x, const void* mean, const void* rstd,
                           const void* w, const void* b, void* y, int B,
                           int C, int HW, int G, int act,
                           cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec_ok = HW % kVec == 0 &&
                      ((uintptr_t)x | (uintptr_t)y) % 16 == 0;
  const long long n = (long long)B * C * HW;
  const int vec = vec_ok ? kVec : 1;
  const long long n_vec = n / vec;
  constexpr int kThreads = 256;
  const int blocks = (int)std::min<long long>((n_vec + kThreads - 1) /
                                                  kThreads,
                                              (long long)kSMs * 16);
  const float* mf = static_cast<const float*>(mean);
  const float* rf = static_cast<const float*>(rstd);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  if (vec_ok)
    groupnorm_apply_kernel<T, kVec><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), mf, rf, wf, bf, static_cast<T*>(y), n_vec,
        C, HW, G, act);
  else
    groupnorm_apply_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), mf, rf, wf, bf, static_cast<T*>(y), n_vec,
        C, HW, G, act);
  return cudaGetLastError();
}

}  // namespace

// x, y: [B, C, HW] contiguous (f32 or bf16, per `dtype`); weight, bias: [C]
// f32. Returns the first CUDA error of the launch, or 0.
extern "C" int itsd_groupnorm_swish(const void* x, const void* weight,
                                    const void* bias, void* y, int B, int C,
                                    int HW, int G, float eps, int act,
                                    int dtype, void* stream) {
  if (B <= 0 || C <= 0 || HW <= 0 || G <= 0 || C % G != 0 || B > 65535 ||
      (long long)(C / G) * HW > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ITSD_F32:
      return (int)dispatch<float>(x, weight, bias, y, B, C, HW, G, eps, act,
                                  s);
    case ITSD_BF16:
      return (int)dispatch<__nv_bfloat16>(x, weight, bias, y, B, C, HW, G,
                                          eps, act, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

namespace {

bool bad_shape(int B, int C, int HW, int G) {
  return B <= 0 || C <= 0 || HW <= 0 || G <= 0 || C % G != 0 ||
         B > 65535 || (long long)(C / G) * HW > (1LL << 30);
}

}  // namespace

// x: [B, C, HW] contiguous (f32 or bf16, per `dtype`); out: [B, G] f32,
// each (sample, group) span's sum of x, or, given `mean` [B, G] f32 (else
// null), its sum of (x - mean)^2. Returns the first CUDA error of the
// launch, or 0.
extern "C" int itsd_groupnorm_partial_stats(const void* x, const void* mean,
                                            void* out, int B, int C, int HW,
                                            int G, int dtype, void* stream) {
  if (bad_shape(B, C, HW, G)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ITSD_F32:
      return (int)dispatch_stats<float>(x, mean, out, B, C, HW, G, s);
    case ITSD_BF16:
      return (int)dispatch_stats<__nv_bfloat16>(x, mean, out, B, C, HW, G,
                                                s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// x, y: [B, C, HW] contiguous (f32 or bf16); mean, rstd: [B, G] f32;
// weight, bias: [C] f32. y = x normalized with the given statistics, the
// affine, then swish when `act`. Returns the first CUDA error, or 0.
extern "C" int itsd_groupnorm_apply(const void* x, const void* mean,
                                    const void* rstd, const void* weight,
                                    const void* bias, void* y, int B, int C,
                                    int HW, int G, int act, int dtype,
                                    void* stream) {
  if (bad_shape(B, C, HW, G)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ITSD_F32:
      return (int)dispatch_apply<float>(x, mean, rstd, weight, bias, y, B, C,
                                        HW, G, act, s);
    case ITSD_BF16:
      return (int)dispatch_apply<__nv_bfloat16>(x, mean, rstd, weight, bias,
                                                y, B, C, HW, G, act, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
