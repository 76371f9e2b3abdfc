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
// as K1's, three overlapping windows of one block.  What it in fact waits
// for is neither: the first tiled design formed every tap in the thread
// that used it, ~70 operations issued per output, and was bound by the
// SMs' issue rate (replacing its gathers by constants took away under a
// third of its time).  Design:
// the grid runs over (track, scale, row tile), so that the card and not
// 128 CTAs holds the outputs in flight, and a CTA of 256 threads does as
// little arithmetic per output as it can:
//   - the tile's taps are formed once, by `tap_of` (K1's expressions), into
//     a shared-memory table of 16-byte entries: one per output row of the
//     tile (1/255 folded in) and one per output column, the columns laid
//     out [j][quad] so that neighbouring threads read neighbouring entries;
//     one barrier;
//   - a thread owns four adjacent columns of kRowsPerThread = 4 output rows,
//     a CTA's pass (16 rows at S = 64) apart: it reads its four column taps
//     once, issues the sixteen gathers of each row together before any is
//     used, and writes one float4 per row, so every pass of the CTA writes
//     whole 256-byte rows from 16 neighbouring threads;
//   - S = 64 is compiled in (no division; one CTA per track and scale, 384
//     CTAs at the heavy bench shape, one wave at 3 CTAs per SM); any other
//     S up to 1024 runs the same function with S read at run time, and
//     where S is no multiple of 4 or `out` is not 16-byte aligned the
//     outputs are written one by one.
// The scales of a track are neighbours in the grid: their windows overlap
// in one level and meet in L1/L2 (one u8 1080p level is 2 MB), which does
// what the TPU kernel's shared DMA did.
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

// The two taps of one level coordinate: level row/column indices g0, g1
// and their hat weights w0, w1.
struct __align__(16) Tap {
  int g0, g1;
  float w0, w1;
};

// Taps of coordinate `coord` in a block of `blk` rows (columns) at `origin`
// of a level of true extent `extent`.
__device__ inline Tap tap_of(float coord, int origin, int blk, int extent) {
  // Block-local coordinate, as the TPU kernel computes it.
  const float y = __fsub_rn(coord, (float)origin);
  const float f = floorf(y);
  const int a = (int)f;          // block-local taps a, a + 1
  const bool v0 = a >= 0 && a < blk && origin + a < extent;
  const bool v1 = a + 1 >= 0 && a + 1 < blk && origin + a + 1 < extent;
  Tap tp;
  tp.w0 = v0 ? hat(y, f) : 0.0f;
  tp.w1 = v1 ? hat(y, __fadd_rn(f, 1.0f)) : 0.0f;
  // Reads of zero-weight taps are clamped into the level.
  tp.g0 = min(max(origin + a, 0), extent - 1);
  tp.g1 = min(max(origin + a + 1, 0), extent - 1);
  return tp;
}

// K1's shared-memory taps of one resample: per output row i the two level
// rows and their weights, per output column j the two level columns and
// theirs.
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
    const Tap t = tap_of(is_row ? ys[i] : xs[i], is_row ? r0 : c0,
                         is_row ? blk_rows : blk_cols, is_row ? lh : lw);
    if (is_row) {
      tp.ri0[i] = t.g0;
      tp.ri1[i] = t.g1;
      tp.rw0[i] = __fmul_rn(t.w0, scale);
      tp.rw1[i] = __fmul_rn(t.w1, scale);
    } else {
      tp.ci0[i] = t.g0;
      tp.ci1[i] = t.g1;
      tp.cw0[i] = t.w0;
      tp.cw1[i] = t.w1;
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

// Entry L of a kernel parameter's array by selects: indexing it with a
// register would copy the array to local memory first.
template <typename A>
__device__ __forceinline__ A pick(const A (&a)[4], int L) {
  return L == 0 ? a[0] : L == 1 ? a[1] : L == 2 ? a[2] : a[3];
}

// K3: grid = T tracks x K scales x row tiles, scale and tile fastest; the K
// resamples of a track share its level and block origin.  ys, xs [K, T, S],
// out [K, T, S, S].  A thread owns columns 4 cq .. 4 cq + 3 of kRowsPerThread
// output rows, a CTA's pass apart, so that each pass of the CTA writes whole
// rows.  kS is S where it is compiled in (64), 0 where S is read at run
// time; `vec` says that S is a multiple of 4 and out is 16-byte aligned.
constexpr int kCompiledS = 64;
constexpr int kRowsPerThread = 4;

__host__ __device__ constexpr int quads_per_row(int S) { return (S + 3) / 4; }

// Output rows one pass of a CTA covers; S <= kMaxScalesS keeps it at least 1.
__host__ __device__ constexpr int rows_per_pass(int S) {
  return kThreads / quads_per_row(S);
}

// Row tiles of one (track, scale).
__host__ __device__ constexpr int row_tiles(int S) {
  return (S + rows_per_pass(S) * kRowsPerThread - 1) /
         (rows_per_pass(S) * kRowsPerThread);
}

constexpr int kMaxScalesS = 4 * kThreads;

// Shared memory of one CTA's tap tables.
size_t scales_smem_bytes(int S) {
  return sizeof(Tap) *
         (rows_per_pass(S) * kRowsPerThread + 4 * quads_per_row(S));
}

template <typename T, int kS>
__global__ void __launch_bounds__(kThreads)
roi_scales_kernel(Levels<T> lv, const int* __restrict__ lvl,
                  const int* __restrict__ r0g, const int* __restrict__ c0g,
                  const float* __restrict__ ys, const float* __restrict__ xs,
                  float* __restrict__ out, int T_, int K, int S_rt,
                  int blk_rows, int blk_cols, float scale, bool vec) {
  const int S = kS ? kS : S_rt;
  const int qpr = quads_per_row(S);
  const int rows = rows_per_pass(S);
  const int tiles = row_tiles(S);
  const int tile = blockIdx.x % tiles;
  const int tk = blockIdx.x / tiles;   // t * K + k
  const int t = tk / K;
  const int k = tk - t * K;
  const size_t row = (size_t)k * T_ + t;
  const int L = lvl[t];
  const T* img = pick(lv.p, L);
  const int lw = pick(lv.w, L);
  // The tile's taps, each formed once: n_row row taps (1/255 folded in),
  // then the column taps as [j][cq].
  extern __shared__ float4 tap_smem[];
  Tap* rowtap = reinterpret_cast<Tap*>(tap_smem);
  const int n_row = rows * kRowsPerThread;
  Tap* coltap = rowtap + n_row;
  for (int e = threadIdx.x; e < n_row + 4 * qpr; e += kThreads) {
    if (e < n_row) {
      const int i = min(tile * n_row + e, S - 1);
      Tap tp = tap_of(ys[row * S + i], r0g[t], blk_rows, pick(lv.h, L));
      tp.w0 = __fmul_rn(tp.w0, scale);
      tp.w1 = __fmul_rn(tp.w1, scale);
      rowtap[e] = tp;
    } else {
      const int c = e - n_row;
      const int j = c / qpr;
      const int col = min(4 * (c - j * qpr) + j, S - 1);
      coltap[c] = tap_of(xs[row * S + col], c0g[t], blk_cols, lw);
    }
  }
  __syncthreads();
  const int il = threadIdx.x / qpr;
  const int cq = threadIdx.x - il * qpr;
  const int i0 = tile * n_row + il;
  if (il >= rows || i0 >= S) return;
  const int j0 = 4 * cq;
  const int nj = min(4, S - j0);
  Tap tx[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) tx[j] = coltap[j * qpr + cq];
  // All the gathers first (sixteen per row), then the arithmetic.  A row
  // past the last one repeats it (and is not written).
  float rw0[kRowsPerThread], rw1[kRowsPerThread];
  T p[kRowsPerThread][4][4];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const Tap ty = rowtap[r * rows + il];
    rw0[r] = ty.w0;
    rw1[r] = ty.w1;
    const T* row0 = img + (size_t)ty.g0 * lw;
    const T* row1 = img + (size_t)ty.g1 * lw;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      p[r][j][0] = row0[tx[j].g0];
      p[r][j][1] = row1[tx[j].g0];
      p[r][j][2] = row0[tx[j].g1];
      p[r][j][3] = row1[tx[j].g1];
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int i = i0 + r * rows;
    if (i >= S) break;
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // Row pass (W_y . block) at the two column taps, then the column
      // pass.
      const float t0 = __fadd_rn(__fmul_rn(rw0[r], (float)p[r][j][0]),
                                 __fmul_rn(rw1[r], (float)p[r][j][1]));
      const float t1 = __fadd_rn(__fmul_rn(rw0[r], (float)p[r][j][2]),
                                 __fmul_rn(rw1[r], (float)p[r][j][3]));
      o[j] = __fadd_rn(__fmul_rn(t0, tx[j].w0), __fmul_rn(t1, tx[j].w1));
    }
    float* dst = out + (row * S + i) * S + j0;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < nj) dst[j] = o[j];
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
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
    return (int)cudaGetLastError();
  }
  if (S < 1 || S > kMaxScalesS) return (int)cudaErrorInvalidValue;
  const bool vec = S % 4 == 0 && aligned16(out);
  const int grid = T_ * K * row_tiles(S);
  const size_t taps = scales_smem_bytes(S);
  if (S == kCompiledS) {
    roi_scales_kernel<T, kCompiledS><<<grid, kThreads, taps, stream>>>(
        lv, il, ir, ic, fy, fx, o, T_, K, S, blk_rows, blk_cols, scale, vec);
  } else {
    roi_scales_kernel<T, 0><<<grid, kThreads, taps, stream>>>(
        lv, il, ir, ic, fy, fx, o, T_, K, S, blk_rows, blk_cols, scale, vec);
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

// The largest S that K3 takes.
extern "C" int tpu_mot_roi_scales_max_s() { return kMaxScalesS; }

// What K3 launches for S x S outputs from a u8 or float32 pyramid: info[0]
// the code path (1 = S compiled in, 0 = S read at run time), info[1]
// threads per CTA, info[2] registers per thread, info[3] dynamic shared
// memory per CTA (none), info[4] CTAs that fit on one SM at once.  Returns
// a CUDA error code.
extern "C" int tpu_mot_roi_scales_info(int is_u8, int S, int* info) {
  const bool fast = S == kCompiledS;
  const void* kernel =
      is_u8 ? (fast ? (const void*)roi_scales_kernel<uint8_t, kCompiledS>
                    : (const void*)roi_scales_kernel<uint8_t, 0>)
            : (fast ? (const void*)roi_scales_kernel<float, kCompiledS>
                    : (const void*)roi_scales_kernel<float, 0>);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, kernel, kThreads, scales_smem_bytes(S));
  info[0] = fast;
  info[1] = kThreads;
  info[2] = attr.numRegs;
  info[3] = (int)scales_smem_bytes(S);
  info[4] = ctas;
  return (int)err;
}
