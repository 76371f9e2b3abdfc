// Per-track ROI extraction from a mip pyramid: bilinear resample of each
// track's context window to an S x S template.
//
// Replaces the TPU kernel tpu_mot/kernels/roi.py:extract_patches_pallas
// (body _roi_kernel), which DMAs an (8,128)-aligned 144 x 256 block of the
// chosen pyramid level into VMEM and resamples it with two one-hot
// hat-weight matmuls, W_y . block . W_x^T, on the matrix unit.
//
// What bounds it on the H100: at the bench shape (128 tracks, S = 64) a
// call writes 128 x 64 x 64 float32 = 2.1 MB (0.6 us at 3.35 TB/s) and reads
// at most 4 taps x 4096 outputs x 128 tracks, ~2 M pixels, mostly from L2
// (one u8 1080p level is 2 MB), at ~10 flops per output; the matmul form
// would spend 2 x 144 x 256 x 64 MACs per track on weights that are zero at
// all but two taps per axis.  Neither bytes nor flops set its time: a launch
// and the chain of one CTA (taps, a barrier, one round of gathers, the
// stores) do, and the SMs' issue rate once CTAs queue.
//
// K3, roi_scales_kernel, replaces tpu_mot/kernels/roi.py:
// extract_patches_scales_pallas (body _scales_kernel): one window DMA per
// track feeds K = 3 resamples (scales 1/1.05, 1, 1.05), with the level
// chosen from the largest scale's window and the block origin at the
// smallest first row/column over the scales (that math is torch-side,
// kernels/roi.sample_coords_scales).  What bounds it on the H100: the bytes
// it writes, K x T x S x S float32 = 6.3 MB at the heavy bench shape
// (~1.9 us at 3.35 TB/s); the pixels it reads are the same ~2 M per scale
// as K1's, three overlapping windows of one block.
//
// Serving: the levels of S frames are stacked [S, h_L, w_L] and the rows of
// the track axis are stream-major, so a row's frame is t / rows_per_frame
// and its level pointer moves by frame * h_L * w_L; S = 1 passes the rows
// themselves and is the single-frame launch.
//
// Both kernels are one function, `resample_tile`: K1 is its K = 1 case with
// its own rows per thread, under its own kernel name so that a profile
// tells the two apart.  The level, block origin and sample coordinates come
// from the torch-side coordinate math (outside the kernel in JAX too).  A
// first tiled design formed every tap in the thread that used it, ~70
// operations issued per output, and was bound by the SMs' issue rate
// (replacing its gathers by constants took away under a third of its time);
// the first K1 gave a thread 16 outputs one after another, each with four
// dependent scalar gathers, and was held by the latency of 16 serial gather
// rounds.  Design:
// the grid runs over (track, scale, row tile), so that the card and not
// 128 CTAs holds the outputs in flight, and a CTA of 256 threads does as
// little arithmetic per output as it can:
//   - the tile's taps are formed once, by `tap_of`, into a shared-memory
//     table of 16-byte entries: one per output row of the tile (1/255 folded
//     in for u8 pyramids, as the TPU kernel does) and one per output column,
//     the columns laid out [j][quad] so that neighbouring threads read
//     neighbouring entries; one barrier;
//   - a thread owns four adjacent columns of kRows output rows, a CTA's
//     pass (16 rows at S = 64) apart: it reads its four column taps once,
//     issues the sixteen gathers of each row together before any is used,
//     and writes one float4 per row, so every pass of the CTA writes whole
//     256-byte rows from 16 neighbouring threads;
//   - S = 64 is compiled in (no division); any other S up to 1024 runs the
//     same function with S read at run time, and where S is no multiple of
//     4 or `out` is not 16-byte aligned the outputs are written one by one.
// The 4-tap bilinear form equals the TPU kernel's one-hot matmul form
// because the hat weights are nonzero at two pixels per axis.  A level is
// read directly through its pointer and true extent; a tap outside the TPU
// kernel's block [r0, r0+144) x [c0, c0+256) or past the level's true
// extent gets zero weight, so windows over 1024 px (clamped to level 3)
// reproduce the TPU kernel's block truncation and the port's levels need no
// padding.  The scales of a track are neighbours in the grid: their windows
// overlap in one level and meet in L1/L2, which does what the TPU kernel's
// shared DMA did.
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

// Entry L of a kernel parameter's array by selects: indexing it with a
// register would copy the array to local memory first.
template <typename A>
__device__ __forceinline__ A pick(const A (&a)[4], int L) {
  return L == 0 ? a[0] : L == 1 ? a[1] : L == 2 ? a[2] : a[3];
}

// The resample of one tile, shared by K1 and K3.  The grid runs over T
// tracks x K scales x row tiles, scale and tile fastest; the K resamples of
// a track share its level and block origin, and track t reads frame
// t / rows_per_frame of the stacked levels.  ys, xs [K, T, S], out
// [K, T, S, S]; K1 is the K = 1 case.  A thread owns columns 4 cq ..
// 4 cq + 3 of kRows output rows, a CTA's pass apart, so that each pass of
// the CTA writes whole rows.  kS is S where it is compiled in (64), 0 where
// S is read at run time; `vec` says that S is a multiple of 4 and out is
// 16-byte aligned.
constexpr int kCompiledS = 64;
// Rows a thread owns.  K3 at the bench shape (128 tracks x 3 scales, S = 64)
// is 384 CTAs with 4, one wave at 3 CTAs per SM.  K1 has a third of the
// CTAs, so its count was measured (an H100 at 700 W, 128 tracks, S = 64, u8
// 1080p, `python -m tpu_mot_torch.tools.kernel_cost`): see kRoiRows below.
constexpr int kScalesRows = 4;

__host__ __device__ constexpr int quads_per_row(int S) { return (S + 3) / 4; }

// Output rows one pass of a CTA covers; S <= kMaxS keeps it at least 1.
__host__ __device__ constexpr int rows_per_pass(int S) {
  return kThreads / quads_per_row(S);
}

// Row tiles of one (track, scale) where a thread owns `rows` output rows.
__host__ __device__ constexpr int row_tiles(int S, int rows) {
  return (S + rows_per_pass(S) * rows - 1) / (rows_per_pass(S) * rows);
}

constexpr int kMaxS = 4 * kThreads;

// Shared memory of one CTA's tap tables.
size_t tap_smem_bytes(int S, int rows) {
  return sizeof(Tap) * (rows_per_pass(S) * rows + 4 * quads_per_row(S));
}

template <typename T, int kS, int kRows>
__device__ __forceinline__ void resample_tile(
    const Levels<T>& lv, const int* __restrict__ lvl,
    const int* __restrict__ r0g, const int* __restrict__ c0g,
    const float* __restrict__ ys, const float* __restrict__ xs,
    float* __restrict__ out, int T_, int rows_per_frame, int K, int S_rt,
    int blk_rows, int blk_cols, float scale, bool vec) {
  const int S = kS ? kS : S_rt;
  const int qpr = quads_per_row(S);
  const int rows = rows_per_pass(S);
  const int tiles = row_tiles(S, kRows);
  const int tile = blockIdx.x % tiles;
  const int tk = blockIdx.x / tiles;   // t * K + k
  const int t = tk / K;
  const int k = tk - t * K;
  const size_t row = (size_t)k * T_ + t;
  const int L = lvl[t];
  const int lw = pick(lv.w, L);
  const T* img = pick(lv.p, L) +
                 (size_t)(t / rows_per_frame) * pick(lv.h, L) * lw;
  // The tile's taps, each formed once: n_row row taps (1/255 folded in),
  // then the column taps as [j][cq].
  extern __shared__ float4 tap_smem[];
  Tap* rowtap = reinterpret_cast<Tap*>(tap_smem);
  const int n_row = rows * kRows;
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
  float rw0[kRows], rw1[kRows];
  T p[kRows][4][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
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
  for (int r = 0; r < kRows; ++r) {
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

// Three CTAs per SM: K3 at the bench shape (384 CTAs) is one wave at 3.
// With the frame offset of a stacked pyramid ptxas chose 100 registers
// and 2 CTAs per SM unbounded (K3 at 128 x 3 6.5 us, K1 at 384 rows 6.8 us,
// against 5.4 and 5.4 before it); bounded, it takes 80 registers with a
// few spilled bytes (20 in K1 u8 S = 64): K3 5.4-5.5 us, K1 at 384 rows
// 5.8 us (an H100 at 700 W, `python -m tpu_mot_torch.tools.kernel_cost`,
// parent and change in turns).
constexpr int kMinCtas = 3;

// K1: one resample per track; ys, xs [T, S] read as [1, T, S].
template <typename T, int kS, int kRows>
__global__ void __launch_bounds__(kThreads, kMinCtas)
roi_kernel(Levels<T> lv, const int* __restrict__ lvl,
           const int* __restrict__ r0g, const int* __restrict__ c0g,
           const float* __restrict__ ys, const float* __restrict__ xs,
           float* __restrict__ out, int T_, int rows_per_frame, int S_rt,
           int blk_rows, int blk_cols, float scale, bool vec) {
  resample_tile<T, kS, kRows>(lv, lvl, r0g, c0g, ys, xs, out, T_,
                              rows_per_frame, 1, S_rt, blk_rows, blk_cols,
                              scale, vec);
}

// K3: K resamples per track.
template <typename T, int kS>
__global__ void __launch_bounds__(kThreads, kMinCtas)
roi_scales_kernel(Levels<T> lv, const int* __restrict__ lvl,
                  const int* __restrict__ r0g, const int* __restrict__ c0g,
                  const float* __restrict__ ys, const float* __restrict__ xs,
                  float* __restrict__ out, int T_, int rows_per_frame,
                  int K, int S_rt, int blk_rows, int blk_cols, float scale,
                  bool vec) {
  resample_tile<T, kS, kScalesRows>(lv, lvl, r0g, c0g, ys, xs, out, T_,
                                    rows_per_frame, K, S_rt, blk_rows,
                                    blk_cols, scale, vec);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The arguments of one launch, as the C entry points take them.
struct Call {
  int is_u8;
  const void* p[4];
  int h[4];
  int w[4];
  const int* lvl;
  const int* r0;
  const int* c0;
  const float* ys;
  const float* xs;
  float* out;
  int T, rows_per_frame, K, S, blk_rows, blk_cols;
  float scale;
  cudaStream_t stream;
};

template <typename T>
Levels<T> levels_of(const Call& c) {
  Levels<T> lv;
  for (int k = 0; k < 4; ++k) {
    lv.p[k] = static_cast<const T*>(c.p[k]);
    lv.h[k] = c.h[k];
    lv.w[k] = c.w[k];
  }
  return lv;
}

// K1's kernel for a thread that owns kRows rows.
template <typename T, int kRows>
const void* roi_kernel_rows(int S) {
  return S == kCompiledS ? (const void*)roi_kernel<T, kCompiledS, kRows>
                         : (const void*)roi_kernel<T, 0, kRows>;
}

template <typename T>
const void* roi_kernel_of(int S, int rows) {
  return rows == 4   ? roi_kernel_rows<T, 4>(S)
         : rows == 2 ? roi_kernel_rows<T, 2>(S)
         : rows == 1 ? roi_kernel_rows<T, 1>(S)
                     : nullptr;
}

template <typename T>
const void* roi_scales_kernel_of(int S) {
  return S == kCompiledS ? (const void*)roi_scales_kernel<T, kCompiledS>
                         : (const void*)roi_scales_kernel<T, 0>;
}

// K1 where rows > 0 (a thread owns that many rows: 4, 2 or 1), else K3.
template <typename T>
int launch(const Call& c, int rows) {
  if (c.S < 1 || c.S > kMaxS || c.rows_per_frame < 1 ||
      c.T % c.rows_per_frame != 0)
    return (int)cudaErrorInvalidValue;
  const void* kernel =
      rows ? roi_kernel_of<T>(c.S, rows) : roi_scales_kernel_of<T>(c.S);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const int per_thread = rows ? rows : kScalesRows;
  Levels<T> lv = levels_of<T>(c);
  Call a = c;
  bool vec = c.S % 4 == 0 && aligned16(c.out);
  const int grid = c.T * c.K * row_tiles(c.S, per_thread);
  const size_t smem = tap_smem_bytes(c.S, per_thread);
  // The two kernels' parameters differ in K alone.
  void* k1_args[] = {&lv,   &a.lvl, &a.r0,  &a.c0,          &a.ys,
                     &a.xs, &a.out, &a.T,   &a.rows_per_frame, &a.S,
                     &a.blk_rows,   &a.blk_cols, &a.scale,    &vec};
  void* k3_args[] = {&lv,   &a.lvl, &a.r0,  &a.c0,          &a.ys,
                     &a.xs, &a.out, &a.T,   &a.rows_per_frame, &a.K,
                     &a.S,  &a.blk_rows,    &a.blk_cols,      &a.scale,
                     &vec};
  cudaLaunchKernel(kernel, dim3(grid), dim3(kThreads),
                   rows ? k1_args : k3_args, smem, c.stream);
  return (int)cudaGetLastError();
}

int dispatch(const Call& c, int rows) {
  return c.is_u8 ? launch<uint8_t>(c, rows) : launch<float>(c, rows);
}

// K1's rows per thread.  Measured at S = 64, u8 1080p on an H100 at 700 W,
// each variant in two turns: at 128 tracks 4 rows (128 CTAs) took 3.40-3.41
// us, 2 rows (256 CTAs) 3.43-3.48, 1 row (512 CTAs) 3.48-3.60; at 384 rows
// (the single-object bank's 3-scale call) 4 rows took 5.31-5.40 us, 2 rows
// 6.63-6.67, 1 row 7.11-7.14.  Under one CTA per SM the time is one CTA's
// chain, which 12 more gathers in flight do not lengthen; past one wave a
// CTA that forms its taps for fewer outputs pays for them again.  4 stays.
constexpr int kRoiRows = 4;

// What a kernel launches: info[0] the code path (1 = S compiled in, 0 = S
// read at run time), info[1] threads per CTA, info[2] registers per thread,
// info[3] dynamic shared memory per CTA, info[4] CTAs that fit on one SM at
// once.  Returns a CUDA error code.
int kernel_info(const void* kernel, int S, int rows, int* info) {
  if (S < 1 || S > kMaxS) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, kernel, kThreads, tap_smem_bytes(S, rows));
  info[0] = S == kCompiledS;
  info[1] = kThreads;
  info[2] = attr.numRegs;
  info[3] = (int)tap_smem_bytes(S, rows);
  info[4] = ctas;
  return (int)err;
}

}  // namespace

#define ROI_LEVEL_PARAMS                                                    \
  int is_u8, const void *l0, const void *l1, const void *l2, const void *l3, \
      int h0, int h1, int h2, int h3, int w0, int w1, int w2, int w3,        \
      const void *lvl, const void *r0, const void *c0, const void *ys,       \
      const void *xs, void *out

#define ROI_CALL(T_, K_, S_)                                               \
  Call {                                                                   \
    is_u8, {l0, l1, l2, l3}, {h0, h1, h2, h3}, {w0, w1, w2, w3},           \
        static_cast<const int*>(lvl), static_cast<const int*>(r0),         \
        static_cast<const int*>(c0), static_cast<const float*>(ys),        \
        static_cast<const float*>(xs), static_cast<float*>(out), T_,       \
        rows_per_frame, K_, S_, blk_rows, blk_cols, scale,                 \
        static_cast<cudaStream_t>(stream)                                  \
  }

// K1.  levels l0..l3: contiguous [T / rows_per_frame, h_k, w_k] uint8
// (is_u8) or float32 images; lvl, r0, c0: [T] int32; ys, xs: [T, S] float32
// level coordinates, row t in frame t / rows_per_frame; out: [T, S, S]
// float32.  Launches on `stream`, returns cudaGetLastError().
extern "C" int tpu_mot_roi_extract(ROI_LEVEL_PARAMS, int T,
                                   int rows_per_frame, int S, int blk_rows,
                                   int blk_cols, float scale, void* stream) {
  return dispatch(ROI_CALL(T, 1, S), kRoiRows);
}

// K1 with a thread owning `rows` output rows (4, 2 or 1), for measuring
// the choice of kRoiRows.
extern "C" int tpu_mot_roi_extract_rows(ROI_LEVEL_PARAMS, int T,
                                        int rows_per_frame, int S, int rows,
                                        int blk_rows, int blk_cols,
                                        float scale, void* stream) {
  if (rows != 4 && rows != 2 && rows != 1) return (int)cudaErrorInvalidValue;
  return dispatch(ROI_CALL(T, 1, S), rows);
}

// K3.  As K1 with K >= 1 scales: ys, xs [K, T, S]; out [K, T, S, S].
extern "C" int tpu_mot_roi_extract_scales(ROI_LEVEL_PARAMS, int T,
                                          int rows_per_frame, int K, int S,
                                          int blk_rows, int blk_cols,
                                          float scale, void* stream) {
  return dispatch(ROI_CALL(T, K, S), 0);
}

// The largest S that K1 and K3 take.
extern "C" int tpu_mot_roi_max_s() { return kMaxS; }

// What K1 (`kernel_info`) launches for S x S outputs from a u8 or float32
// pyramid.
extern "C" int tpu_mot_roi_info(int is_u8, int S, int* info) {
  return kernel_info(is_u8 ? roi_kernel_rows<uint8_t, kRoiRows>(S)
                           : roi_kernel_rows<float, kRoiRows>(S),
                     S, kRoiRows, info);
}

// The same for K3.
extern "C" int tpu_mot_roi_scales_info(int is_u8, int S, int* info) {
  return kernel_info(is_u8 ? roi_scales_kernel_of<uint8_t>(S)
                           : roi_scales_kernel_of<float>(S),
                     S, kScalesRows, info);
}
