// GroupNorm (+ optional swish) over NCHW activations.
//
// Replaces the TPU kernel itsd_tpu/kernels/groupnorm.py:_gn_kernel (launched
// by groupnorm_swish_pallas). It is held against the two-pass reference
// groupnorm_swish_xla (same file, 32-44), not against the Pallas kernel's
// one-pass E[x^2]-mean^2 variance.
//
// Bound on the card: bytes. The work is ~10 flops per element, far below
// Hopper's ~20 flops/byte f32 ridge, so the least time is one read of x and
// one write of y. At the UNet's batch of 8 the largest group span is 12288
// elements and the largest tensor 6 MB (about 2 us of HBM time), so a call
// is dominated by its launch, not by either bound.
//
// Design: in NCHW one (sample, group) pair is ONE contiguous span of
// cg*HW elements, so one block owns it and no reduction crosses blocks.
// Pass 1 sums x for the mean, pass 2 sums (x-mean)^2 for the variance
// (two-pass f32, as the reference), pass 3 applies the affine and swish and
// stores in the input dtype. Passes 2 and 3 re-read the span, which was
// just read and sits in L1/L2 (at most 48 KB per block), so device memory
// sees about one read.

#include "common.cuh"

namespace {

constexpr int kGnThreads = 512;

template <typename T>
__global__ void __launch_bounds__(kGnThreads)
    groupnorm_swish_kernel(const T* __restrict__ x,
                           const float* __restrict__ weight,
                           const float* __restrict__ bias, T* __restrict__ y,
                           int C, int HW, int G, float eps, int act) {
  __shared__ float scratch[32];
  const int g = blockIdx.x, b = blockIdx.y;
  const int cg = C / G;
  const int span = cg * HW;
  const size_t base = ((size_t)b * C + (size_t)g * cg) * HW;
  const T* xs = x + base;
  T* ys = y + base;

  float s = 0.f;
  for (int i = threadIdx.x; i < span; i += blockDim.x) s += to_f32(xs[i]);
  const float mean = block_sum(s, scratch) / (float)span;

  float s2 = 0.f;
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const float d = to_f32(xs[i]) - mean;
    s2 += d * d;
  }
  const float var = block_sum(s2, scratch) / (float)span;
  const float inv = rsqrtf(var + eps);

  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const int c = g * cg + i / HW;
    float v = (to_f32(xs[i]) - mean) * inv * weight[c] + bias[c];
    if (act) v = v * (1.f / (1.f + expf(-v)));
    ys[i] = from_f32<T>(v);
  }
}

template <typename T>
void launch(const void* x, const void* w, const void* b, void* y, int B,
            int C, int HW, int G, float eps, int act, cudaStream_t stream) {
  dim3 grid(G, B);
  groupnorm_swish_kernel<T><<<grid, kGnThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<T*>(y), C, HW, G, eps, act);
}

}  // namespace

// x, y: [B, C, HW] contiguous (f32 or bf16, per `dtype`); weight, bias: [C]
// f32. Returns cudaGetLastError() after the launch.
extern "C" int itsd_groupnorm_swish(const void* x, const void* weight,
                                    const void* bias, void* y, int B, int C,
                                    int HW, int G, float eps, int act,
                                    int dtype, void* stream) {
  if (B <= 0 || C <= 0 || HW <= 0 || G <= 0 || C % G != 0 || B > 65535 ||
      (long long)(C / G) * HW > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ITSD_F32:
      launch<float>(x, weight, bias, y, B, C, HW, G, eps, act, s);
      break;
    case ITSD_BF16:
      launch<__nv_bfloat16>(x, weight, bias, y, B, C, HW, G, eps, act, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
