// Per-track ROI extraction from a mip pyramid: bilinear resample of each
// track's context window to an S x S template.
//
// Replaces the TPU kernel tpu_mot/kernels/roi.py:extract_patches_pallas
// (body _roi_kernel), which DMAs an (8,128)-aligned 144 x 256 block of the
// chosen pyramid level into VMEM and resamples it with two one-hot
// hat-weight matmuls, W_y . block . W_x^T, on the matrix unit.
//
// What bounds it on the H100: memory latency.  At the bench shape (128
// tracks, S = 64) a call reads at most 4 taps x 4096 outputs x 128 tracks,
// ~2 M pixels, mostly from L2 (one u8 1080p level is 2 MB), and computes
// ~10 flops per output; the matmul form would spend 2 x 144 x 256 x 64
// MACs per track on weights that are zero at all but two taps per axis.
//
// Design: one CTA of 256 threads per track.  The level, block origin and
// sample coordinates come from the torch-side coordinate math (outside the
// kernel in JAX too).  The CTA first turns its S row and S column
// coordinates into two taps each (row/column index and hat weight) in
// shared memory, then every thread computes 16 outputs with the 4-tap
// bilinear form, which equals the one-hot matmul form because the hat
// weights are nonzero at two pixels per axis.  The level is read directly
// through its pointer and true extent; a tap outside the TPU kernel's block
// [r0, r0+144) x [c0, c0+256) or past the level's true extent gets zero
// weight, so windows over 1024 px (clamped to level 3) reproduce the TPU
// kernel's block truncation and the port's levels need no padding.  The u8
// instantiation folds the 1/255 dequantization into the row weights, as the
// TPU kernel does.
//
// K3, roi_scales_kernel, replaces tpu_mot/kernels/roi.py:
// extract_patches_scales_pallas (body _scales_kernel): one window DMA per
// track feeds K = 3 resamples (scales 1/1.05, 1, 1.05), with the level
// chosen from the largest scale's window and the block origin at the
// smallest first row/column over the scales (that math is torch-side,
// kernels/roi.sample_coords_scales).  What bounds it on the H100: the bytes
// it writes, K x T x S x S float32 = 6.3 MB at the heavy bench shape
// (~1.9 us at 3.35 TB/s); the pixels it reads are the same ~2 M per scale
// as K1's, three overlapping windows of one block.  Design: one CTA per
// track loops over the scales, reusing K1's tap setup and 4-tap resample,
// so the three windows' reads hit the same lines in L1/L2 rather than
// device memory: the card's caches do what the TPU kernel's shared DMA did.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Levels {
  const T* p[4];
  int h[4];  // true extent (rows) of each level
  int w[4];  // true extent (cols) = row stride of each level
};

// Hat weight of integer tap r for coordinate y, exactly as the TPU kernel
// forms it: max(0, 1 - |y - r|).
__device__ inline float hat(float y, float r) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(y, r))));
}

// Shared-memory taps of one resample: per output row i the two level rows
// and their weights, per output column j the two level columns and theirs.
struct Taps {
  int* ri0;
  int* ri1;
  float* rw0;
  float* rw1;
  int* ci0;
  int* ci1;
  float* cw0;
  float* cw1;
};

__device__ inline Taps taps_in(float* smem, int S) {
  Taps tp;
  tp.ri0 = reinterpret_cast<int*>(smem);
  tp.ri1 = tp.ri0 + S;
  tp.rw0 = reinterpret_cast<float*>(tp.ri1 + S);
  tp.rw1 = tp.rw0 + S;
  tp.ci0 = reinterpret_cast<int*>(tp.rw1 + S);
  tp.ci1 = tp.ci0 + S;
  tp.cw0 = reinterpret_cast<float*>(tp.ci1 + S);
  tp.cw1 = tp.cw0 + S;
  return tp;
}

// The CTA turns S row and S column level coordinates (ys, xs) into two
// taps each; `scale` (the u8 dequantization) is folded into the row
// weights.  The caller synchronises before reading the taps.
__device__ inline void make_taps(Taps tp, const float* __restrict__ ys,
                                 const float* __restrict__ xs, int r0, int c0,
                                 int lh, int lw, int S, int blk_rows,
                                 int blk_cols, float scale) {
  for (int k = threadIdx.x; k < 2 * S; k += blockDim.x) {
    const bool is_row = k < S;
    const int i = is_row ? k : k - S;
    const int origin = is_row ? r0 : c0;
    const int blk = is_row ? blk_rows : blk_cols;
    const int extent = is_row ? lh : lw;
    // Block-local coordinate, as the TPU kernel computes it.
    const float y = __fsub_rn(is_row ? ys[i] : xs[i], (float)origin);
    const float f = floorf(y);
    const int a = (int)f;          // block-local taps a, a + 1
    float w0 = hat(y, f);
    float w1 = hat(y, __fadd_rn(f, 1.0f));
    const bool v0 = a >= 0 && a < blk && origin + a < extent;
    const bool v1 = a + 1 >= 0 && a + 1 < blk && origin + a + 1 < extent;
    w0 = v0 ? w0 : 0.0f;
    w1 = v1 ? w1 : 0.0f;
    // Reads of zero-weight taps are clamped into the level.
    const int g0 = min(max(origin + a, 0), extent - 1);
    const int g1 = min(max(origin + a + 1, 0), extent - 1);
    if (is_row) {
      tp.ri0[i] = g0;
      tp.ri1[i] = g1;
      tp.rw0[i] = __fmul_rn(w0, scale);
      tp.rw1[i] = __fmul_rn(w1, scale);
    } else {
      tp.ci0[i] = g0;
      tp.ci1[i] = g1;
      tp.cw0[i] = w0;
      tp.cw1[i] = w1;
    }
  }
}

// The 4-tap bilinear form of the hat-weight matmuls for all S x S outputs.
template <typename T>
__device__ inline void resample(Taps tp, const T* __restrict__ img, int lw,
                                int S, float* __restrict__ o) {
  for (int idx = threadIdx.x; idx < S * S; idx += blockDim.x) {
    const int i = idx / S;
    const int j = idx - i * S;
    const T* row0 = img + (size_t)tp.ri0[i] * lw;
    const T* row1 = img + (size_t)tp.ri1[i] * lw;
    const int x0 = tp.ci0[j];
    const int x1 = tp.ci1[j];
    // Row pass (W_y . block) at the two column taps, then the column pass.
    const float t0 = __fadd_rn(__fmul_rn(tp.rw0[i], (float)row0[x0]),
                               __fmul_rn(tp.rw1[i], (float)row1[x0]));
    const float t1 = __fadd_rn(__fmul_rn(tp.rw0[i], (float)row0[x1]),
                               __fmul_rn(tp.rw1[i], (float)row1[x1]));
    o[idx] = __fadd_rn(__fmul_rn(t0, tp.cw0[j]), __fmul_rn(t1, tp.cw1[j]));
  }
}

// K1: one CTA per track, one resample.
template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_kernel(Levels<T> lv, const int* __restrict__ lvl,
           const int* __restrict__ r0g, const int* __restrict__ c0g,
           const float* __restrict__ ys, const float* __restrict__ xs,
           float* __restrict__ out, int S, int blk_rows, int blk_cols,
           float scale) {
  extern __shared__ float smem[];
  const Taps tp = taps_in(smem, S);
  const int t = blockIdx.x;
  const int L = lvl[t];
  make_taps(tp, ys + (size_t)t * S, xs + (size_t)t * S, r0g[t], c0g[t],
            lv.h[L], lv.w[L], S, blk_rows, blk_cols, scale);
  __syncthreads();
  resample(tp, lv.p[L], lv.w[L], S, out + (size_t)t * S * S);
}

// K3: one CTA per track, K resamples from the track's one block (level and
// origin shared by the scales); ys, xs [K, T, S], out [K, T, S, S].
template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_scales_kernel(Levels<T> lv, const int* __restrict__ lvl,
                  const int* __restrict__ r0g, const int* __restrict__ c0g,
                  const float* __restrict__ ys, const float* __restrict__ xs,
                  float* __restrict__ out, int T_, int K, int S,
                  int blk_rows, int blk_cols, float scale) {
  extern __shared__ float smem[];
  const Taps tp = taps_in(smem, S);
  const int t = blockIdx.x;
  const int L = lvl[t];
  for (int k = 0; k < K; ++k) {
    const size_t row = (size_t)k * T_ + t;
    make_taps(tp, ys + row * S, xs + row * S, r0g[t], c0g[t], lv.h[L],
              lv.w[L], S, blk_rows, blk_cols, scale);
    __syncthreads();
    resample(tp, lv.p[L], lv.w[L], S, out + row * S * S);
    __syncthreads();               // the taps are rewritten for scale k + 1
  }
}

template <typename T>
Levels<T> levels_of(const void* const* p, const int* h, const int* w) {
  Levels<T> lv;
  for (int k = 0; k < 4; ++k) {
    lv.p[k] = static_cast<const T*>(p[k]);
    lv.h[k] = h[k];
    lv.w[k] = w[k];
  }
  return lv;
}

template <typename T>
int launch(const void* const* p, const int* h, const int* w, const void* lvl,
           const void* r0, const void* c0, const void* ys, const void* xs,
           void* out, int T_, int K, int S, int blk_rows, int blk_cols,
           float scale, cudaStream_t stream) {
  const Levels<T> lv = levels_of<T>(p, h, w);
  const size_t smem = (size_t)8 * S * 4;
  const int* il = static_cast<const int*>(lvl);
  const int* ir = static_cast<const int*>(r0);
  const int* ic = static_cast<const int*>(c0);
  const float* fy = static_cast<const float*>(ys);
  const float* fx = static_cast<const float*>(xs);
  float* o = static_cast<float*>(out);
  if (K == 0) {
    roi_kernel<T><<<T_, kThreads, smem, stream>>>(
        lv, il, ir, ic, fy, fx, o, S, blk_rows, blk_cols, scale);
  } else {
    roi_scales_kernel<T><<<T_, kThreads, smem, stream>>>(
        lv, il, ir, ic, fy, fx, o, T_, K, S, blk_rows, blk_cols, scale);
  }
  return (int)cudaGetLastError();
}

int dispatch(int is_u8, const void* const* p, const int* h, const int* w,
             const void* lvl, const void* r0, const void* c0, const void* ys,
             const void* xs, void* out, int T, int K, int S, int blk_rows,
             int blk_cols, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_u8) {
    return launch<uint8_t>(p, h, w, lvl, r0, c0, ys, xs, out, T, K, S,
                           blk_rows, blk_cols, scale, s);
  }
  return launch<float>(p, h, w, lvl, r0, c0, ys, xs, out, T, K, S, blk_rows,
                       blk_cols, scale, s);
}

}  // namespace

// K1.  levels l0..l3: contiguous [h_k, w_k] uint8 (is_u8) or float32
// images; lvl, r0, c0: [T] int32; ys, xs: [T, S] float32 level coordinates;
// out: [T, S, S] float32.  Launches on `stream`, returns cudaGetLastError().
extern "C" int tpu_mot_roi_extract(int is_u8, const void* l0, const void* l1,
                                   const void* l2, const void* l3, int h0,
                                   int h1, int h2, int h3, int w0, int w1,
                                   int w2, int w3, const void* lvl,
                                   const void* r0, const void* c0,
                                   const void* ys, const void* xs, void* out,
                                   int T, int S, int blk_rows, int blk_cols,
                                   float scale, void* stream) {
  const void* p[4] = {l0, l1, l2, l3};
  const int h[4] = {h0, h1, h2, h3};
  const int w[4] = {w0, w1, w2, w3};
  return dispatch(is_u8, p, h, w, lvl, r0, c0, ys, xs, out, T, 0, S,
                  blk_rows, blk_cols, scale, stream);
}

// K3.  As K1 with K >= 1 scales: ys, xs [K, T, S]; out [K, T, S, S].
extern "C" int tpu_mot_roi_extract_scales(
    int is_u8, const void* l0, const void* l1, const void* l2, const void* l3,
    int h0, int h1, int h2, int h3, int w0, int w1, int w2, int w3,
    const void* lvl, const void* r0, const void* c0, const void* ys,
    const void* xs, void* out, int T, int K, int S, int blk_rows,
    int blk_cols, float scale, void* stream) {
  const void* p[4] = {l0, l1, l2, l3};
  const int h[4] = {h0, h1, h2, h3};
  const int w[4] = {w0, w1, w2, w3};
  return dispatch(is_u8, p, h, w, lvl, r0, c0, ys, xs, out, T, K, S,
                  blk_rows, blk_cols, scale, stream);
}
