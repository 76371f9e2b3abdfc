// The inference epilogue of a YOLO ConvBlock (K7): BatchNorm with its
// running statistics, leaky ReLU (0.1) and the residual add, in place over
// the float32 NCHW conv output y:
//
//   y <- [skip +] leaky(((y - mean[c]) * mul[c]) + bias[c])
//
// It replaces no TPU kernel: the JAX package leaves this chain to XLA,
// which fuses it into the conv.  In the port the chain was four full-size
// passes of PyTorch's elementwise kernels (subtract, multiply, add, leaky
// ReLU), BatchNorm's three on the strided broadcast path, and a fifth pass
// for the shortcut add of YOLOv3's 23 residual units.
//
// Bit for bit the chain's result.  Each element runs the chain's operations
// in its order, each rounded to float32 on its own (__fsub_rn, __fmul_rn,
// __fadd_rn: no FMA contraction), then t > 0 ? t : t * 0.1f as PyTorch's
// leaky_relu, then skip + t.  mul = rsqrt(var + eps) * weight comes from the
// caller's PyTorch expression, since rsqrtf's bits may differ from it.
//
// What bounds it on the H100: bytes.  A pass reads y (and skip) and writes
// y once, 8 (12) bytes an element for 5 (6) operations; at YOLOv3-608's
// layer 0, [128, 32, 608, 608], that is 12.1 GB, 3.6 ms at 3.35 TB/s.  The
// design keeps many 16-byte loads in flight and everything else off the
// memory path:
//   - One warp per work item: a tile of one channel plane (n, c) of
//     32 lanes x 8 float4 (1024 elements) where the plane's size H*W is a
//     multiple of 4 and y and skip are 16-byte aligned, else 32 lanes x 8
//     floats (256 elements).  The warp reads its channel's mean, mul and
//     bias once (the same address in every lane: one broadcast load each),
//     issues all its loads, then computes and stores.  Lane l takes vector
//     l, l + 32, ...: each load instruction of the warp covers 512
//     contiguous bytes (128 on the scalar path).
//   - Loads and stores carry the streaming hint (ld.global.cs /
//     st.global.cs): every byte is touched once, and a layer's output
//     (189 MB to 6 GB at batch 128) is larger than the 50 MB L2.
//   - Offsets are 64-bit (a plane's start = plane x H*W); within a plane
//     they are 32-bit.  182 YOLOv3-608 frames at layer 0 pass 2^31
//     elements.
// Eight warps a CTA, each on its own item, no shared memory, no
// synchronisation.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerLane = 8;                 // float4 or float a lane
constexpr float kSlope = 0.1f;

__device__ __forceinline__ float apply(float y, float mean, float mul,
                                      float bias) {
  const float t = __fadd_rn(__fmul_rn(__fsub_rn(y, mean), mul), bias);
  return t > 0.f ? t : __fmul_rn(t, kSlope);
}

__device__ __forceinline__ float4 apply(float4 v, float mean, float mul,
                                       float bias) {
  return make_float4(apply(v.x, mean, mul, bias),
                     apply(v.y, mean, mul, bias),
                     apply(v.z, mean, mul, bias),
                     apply(v.w, mean, mul, bias));
}

__device__ __forceinline__ float add(float skip, float t) {
  return __fadd_rn(skip, t);
}

__device__ __forceinline__ float4 add(float4 skip, float4 t) {
  return make_float4(__fadd_rn(skip.x, t.x), __fadd_rn(skip.y, t.y),
                     __fadd_rn(skip.z, t.z), __fadd_rn(skip.w, t.w));
}

// T = float4 (vector path: units of 4 elements) or float (scalar path).
// units = H*W / (elements a unit); tiles = the items of one plane.
template <typename T, bool kSkip>
__global__ void __launch_bounds__(kThreads)
epilogue_kernel(T* __restrict__ y, const T* __restrict__ skip,
                const float* __restrict__ mean, const float* __restrict__ mul,
                const float* __restrict__ bias, long long items, int tiles,
                int units, int channels) {
  const long long item =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= items) return;
  const int lane = threadIdx.x & 31;
  const long long plane = item / tiles;
  const int tile = (int)(item - plane * tiles);
  const int c = (int)(plane % channels);
  const float m = __ldg(mean + c), s = __ldg(mul + c), b = __ldg(bias + c);
  const long long base = plane * units;
  const int first = tile * (32 * kPerLane) + lane;
  T v[kPerLane], r[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int j = first + 32 * i;
    if (j < units) {
      v[i] = __ldcs(y + base + j);
      if (kSkip) r[i] = __ldcs(skip + base + j);
    }
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int j = first + 32 * i;
    if (j < units) {
      T o = apply(v[i], m, s, b);
      if (kSkip) o = add(r[i], o);
      __stcs(y + base + j, o);
    }
  }
}

template <typename T>
int launch(void* y, const void* skip, const void* mean, const void* mul,
           const void* bias, long long planes, int channels, int units,
           cudaStream_t stream) {
  const int tiles = (units + 32 * kPerLane - 1) / (32 * kPerLane);
  const long long items = planes * tiles;
  const long long ctas = (items + kWarps - 1) / kWarps;
  if (ctas == 0) return (int)cudaGetLastError();
  const float* m = static_cast<const float*>(mean);
  const float* s = static_cast<const float*>(mul);
  const float* b = static_cast<const float*>(bias);
  if (skip) {
    epilogue_kernel<T, true><<<(unsigned)ctas, kThreads, 0, stream>>>(
        static_cast<T*>(y), static_cast<const T*>(skip), m, s, b, items,
        tiles, units, channels);
  } else {
    epilogue_kernel<T, false><<<(unsigned)ctas, kThreads, 0, stream>>>(
        static_cast<T*>(y), nullptr, m, s, b, items, tiles, units,
        channels);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K7.  y [planes = N * C, hw] float32, written in place; skip (or null) the
// same shape; mean, mul, bias [channels] float32, plane p is channel
// p % channels.  vector != 0: hw % 4 == 0 and y, skip 16-byte aligned (the
// float4 path).  The caller keeps hw below 2^31 - 1024 and the grid below
// 2^31 CTAs.  Returns cudaGetLastError().
extern "C" int tpu_mot_epilogue(void* y, const void* skip, const void* mean,
                                const void* mul, const void* bias,
                                long long planes, int channels, int hw,
                                int vector, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vector)
    return launch<float4>(y, skip, mean, mul, bias, planes, channels, hw / 4,
                          st);
  return launch<float>(y, skip, mean, mul, bias, planes, channels, hw, st);
}
