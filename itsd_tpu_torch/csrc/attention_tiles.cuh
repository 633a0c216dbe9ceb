// Tile helpers shared by the flash attention kernels (forward and
// backward): 4-element loads as f32, a 4-wide dot product, and the staging
// of rows of a [N, C] matrix into shared memory.
#pragma once

#include "common.cuh"

// 4 consecutive elements as f32; p is 4-element aligned (C % 4 == 0 and
// the wrappers check that the base pointers are 16-byte aligned).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// acc + a . b, in the order x, y, z, w
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// The 4-element group i, counted from row r0, of a [N, C] matrix, as f32;
// zeros past N.
template <typename T>
__device__ __forceinline__ float4 load_group(const T* __restrict__ src,
                                             int i, int r0, int N, int C) {
  const int r = 4 * i / C;
  return r0 + r < N ? load4(src + (size_t)(r0 + r) * C + (4 * i - r * C))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
}

// Stage rows [r0, r0 + kRows) of two [N, C] matrices a and b into the
// shared arrays as [kRows][ld] and [kRows][ld] f32 (ld = C, or C plus a
// pad), zeros past N. Each of the kThreads threads issues the loads of
// kBatch groups of a and of b before it stores any of them, so a tile
// costs one memory latency, not one per element.
template <int kRows, int kThreads, int kBatch, typename T>
__device__ __forceinline__ void stage_rows2(const T* __restrict__ a,
                                            const T* __restrict__ b,
                                            float* as, float* bs, int ld,
                                            int r0, int N, int C, int tid) {
  const int n4 = kRows * C / 4;
  for (int base = 0; base < n4; base += kThreads * kBatch) {
    float4 av[kBatch], bv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kThreads + tid;
      if (i < n4) {
        av[u] = load_group(a, i, r0, N, C);
        bv[u] = load_group(b, i, r0, N, C);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kThreads + tid;
      if (i >= n4) continue;
      const int j = 4 * i / C, c = 4 * i - j * C;
      *reinterpret_cast<float4*>(as + j * ld + c) = av[u];
      *reinterpret_cast<float4*>(bs + j * ld + c) = bv[u];
    }
  }
}
