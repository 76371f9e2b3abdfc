// Fused KCF detect (K4), train + blend (K5), detect-site train + blend from
// a spectrum (K6) and stage 2's gray search (K8; K6 and K8 at the end of the
// file): the whole FFT-domain chain of one item in one CTA, with only the
// inputs read from and the results written to device memory.
//
// Replaces the TPU kernels tpu_mot/kernels/kcf.py:detect_fused (body
// _detect_kernel) and tpu_mot/kernels/kcf.py:train_fused (body
// _train_kernel), which run the chain for a block of 16 tracks in VMEM with
// the DFTs as stacked matmuls on the matrix unit.
//
//   K4: feat -> z^ = rfft2 -> sum_c z^ conj(x^) and the Parseval energies
//       -> irfft2 -> k = exp(-max(xx + zz - 2 cross, 0) / (sigma^2 S^2 C))
//       -> k^ = rfft2(k) -> k^ alpha^ -> irfft2 -> response    (eqs. 31, 22)
//   K5: feat -> x^ -> k^xx as above -> alpha^ = y^ / (k^ + lambda), the
//       denominator floored at 1e-20 (eq. 17) -> per-track EMA blend
//       old (1 - lr) + new lr of x^ and alpha^.
//
// What bounds them on the H100.  By the byte rule the bound is the bytes:
// at the heavy bench shape (HF: 384 detect items and 128 tracks, C = 31,
// S = 16) K4 reads 12.2 MB of features and 4.6 MB of model and writes
// 0.4 MB of response, ~5 us at 3.35 TB/s; K5 reads 4.1 MB of features and
// reads and writes 4.6 MB of model, ~4 us.  What the kernels in fact wait
// for depends on the transforms.  With direct row/column sums (the generic
// path, and K5) an item costs ~0.47 M multiply-adds, each with a twiddle
// and a data load from shared memory: the arithmetic alone is as long as
// the byte bound and the shared-memory traffic several times it, so the
// direct kernels are bound by their own DFT work, not by bytes.  With
// O(S log S) transforms in registers (the S = 16 paths) the DFT work falls
// under the byte time and the rest is latency: one wave of CTAs, each a
// chain of load -> row FFTs -> column FFTs -> three or four small stages.
//
// Two designs share this file.
//
// K4 at S = 16 and C <= 32 (`kcf_detect_fft16_kernel`, the heavy bench
// shape): one CTA of 288 threads (nine warps) per item, three CTAs per SM
// so that 384 items are one wave on 132 SMs (75 KB of shared memory and at
// most 72 registers per thread).
//   - Every transform is a 16-point FFT held in one thread's registers: a
//     4 x 4 Cooley-Tukey schedule (four 4-point DFTs, nine twiddles that
//     are the float64-derived constants cos(pi/8), sin(pi/8), sqrt(1/2),
//     four more 4-point DFTs), ~170 operations, result in base-4
//     digit-reversed order (`rev16`).  Real rows go two at a time through
//     one complex FFT (z = a + i b, then A = (Z[k] + conj Z[-k]) / 2,
//     B = (Z[k] - conj Z[-k]) / 2i), and Hermitian rows come back two at a
//     time the same way.
//   - Every input element is loaded once per CTA.  The model row (x^ and
//     alpha^) goes straight to shared memory by asynchronous 8-byte copies
//     started first, transposed to [ky, kx, c] at an odd channel stride so
//     that neither the copies nor the column stage's reads conflict; it
//     lands while the rows are transformed.  A row-stage thread reads its
//     two feature rows, 128 contiguous bytes, as eight float4.
//   - Row stage: thread (y pair, c), 8 C <= 256 threads, one pass; spectra
//     to shared memory as [y, kx, c] (lanes on consecutive channels).
//     Column stage: warp = kx, lane = c, one pass: the column FFT, the
//     product with conj(x^) and |x^|^2.  The products are summed over the
//     channels by a reduce-scatter over the warp's lanes, 31 shuffles for
//     32 floats: at step h = 16, 8, 4, 2, 1 a lane keeps the half of its
//     values that its bit h selects and adds the partner's copy of them
//     (keep + received, a fixed tree over lanes, the same in every run; no
//     atomics), so lane l ends with component l of column kx.
//   - The Gaussian kernel and the response are four small stages in warp 0
//     with __syncwarp between them: inverse columns; per row pair inverse
//     rows -> exp -> forward rows, in registers; per column forward ->
//     times alpha^ -> inverse, in registers; inverse rows -> float4 stores.
//   - z's energy is summed from the features (Parseval's other side); x's
//     from the spectrum as before.  Both go through one block reduction of
//     fixed order.
//
// K5 at S = 16 and C <= 32 (`kcf_train_fft16_kernel`): one CTA of the same
// 288 threads per track, the same row and column stages, and K4's chain
// without its last inverse.  At T = 128 tracks one CTA runs on an SM, so
// what counts is the length of the one chain and the bytes in flight:
//   - the old alpha^ row and y^ (1152 bytes each) are fetched by
//     asynchronous 8-byte copies at entry and are used last;
//   - the row stage writes [y, kx, c] at the odd channel stride C | 1 and the
//     column stage, whose thread reads exactly the sixteen slots it then
//     writes, leaves the raw x^ in place as [ky, kx, c]: one buffer;
//   - |x^|^2 is real, so the channel sum is a reduce-scatter of 16 floats
//     (steps 8, 4, 2, 1) and one exchange across the half-warps: a fixed
//     tree, no atomics, two runs bit-equal.  x's energy is summed from the
//     features in the row stage (Parseval's other side);
//   - after the column stage the CTA splits.  Warps 1-8 stream the model
//     row: 16-byte loads of the old x^ (several in flight per thread), the
//     new x^ read back from shared memory transposed (the odd stride keeps
//     both directions off each other's banks), the blend, 16-byte stores of
//     the [c, ky, kx] layout, all coalesced.  Warp 0 meanwhile runs the
//     three one-warp stages: inverse columns; per row pair inverse rows ->
//     exp -> forward rows; per column forward -> y^ / (k^ + lambda) ->
//     blend with the old alpha^ -> store.
//
// Generic K4 and K5 (every other S in 2..64, C > 32, or a feature, model or
// result base that is not 16-byte aligned): one CTA of 256 threads per item,
// spectra in shared memory, native float2 complex math in float32.  The
// DFTs are direct row/column sums (S <= 64) over a twiddle table
// e^{-2 pi i j / S} that the wrapper builds once per S in float64 and
// rounds to float32, as the TPU kernel's constant operators are built.
// Stage 1 takes the row DFT of every channel at once; stage 2 gives each
// thread one frequency (ky, kx) and loops over the channels, so the cross
// spectrum and the energies sum in registers in channel order with no
// atomics; the Gaussian kernel, its spectrum and the final inverse are
// four more S x Sf / S x S stages.
//
// Both K4 paths read model row `item % T` instead of a model tiled over
// the 3 scales: the same function with 2/3 less model traffic.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Smem {
  float2* tw;    // [S] twiddles e^{-2 pi i j / S}
  float2* rowt;  // [C, S, Sf] row DFTs of every channel
  float2* spec;  // [S, Sf] cross spectrum, then k^ alpha^
  float2* tmp;   // [S, Sf] half-transformed stage data
  float* real;   // [S, S] the Gaussian kernel k
  float* red;    // [2 * kWarps] block-reduction partials
};

size_t smem_bytes(int C, int S) {
  const size_t sf = S / 2 + 1;
  return sizeof(float2) * (S + (size_t)C * S * sf + 2 * S * sf) +
         sizeof(float) * ((size_t)S * S + 2 * kWarps);
}

__device__ inline Smem carve(unsigned char* base, int C, int S, int Sf) {
  Smem m;
  float2* p = reinterpret_cast<float2*>(base);
  m.tw = p;
  p += S;
  m.rowt = p;
  p += (size_t)C * S * Sf;
  m.spec = p;
  p += S * Sf;
  m.tmp = p;
  p += S * Sf;
  float* q = reinterpret_cast<float*>(p);
  m.real = q;
  q += S * S;
  m.red = q;
  return m;
}

// Hermitian fold weight of half-spectrum column kx: 1 for DC and (even S)
// Nyquist, 2 otherwise.
__device__ inline float fold(int kx, int S) {
  return (kx == 0 || 2 * kx == S) ? 1.0f : 2.0f;
}

// Both sums over the CTA, returned to every thread; includes a barrier
// that also publishes the caller's earlier shared-memory writes.
__device__ inline float2 block_sum2(float a, float b, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[w] = a;
    red[kWarps + w] = b;
  }
  __syncthreads();
  float sa = 0.0f, sb = 0.0f;
  for (int i = 0; i < kWarps; ++i) {
    sa += red[i];
    sb += red[kWarps + i];
  }
  return make_float2(sa, sb);
}

// Stage 1: row DFT of every channel of one item, feat [C, S, S] (device
// memory) -> rowt [C, S, Sf].
__device__ inline void rows_rfft(const float* __restrict__ feat, Smem m,
                                 int C, int S, int Sf) {
  const int n = C * S * Sf;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int cy = idx / Sf;           // c * S + y
    const int kx = idx - cy * Sf;
    const float* row = feat + (size_t)cy * S;
    float re = 0.0f, im = 0.0f;
    int j = 0;
    for (int x = 0; x < S; ++x) {
      const float v = __ldg(row + x);
      const float2 w = m.tw[j];
      re += v * w.x;
      im += v * w.y;
      j += kx;
      if (j >= S) j -= S;
    }
    m.rowt[idx] = make_float2(re, im);
  }
}

// Column DFT of channel c of rowt at (ky, kx).
__device__ inline float2 col_dft(const float2* rowt, const float2* tw, int c,
                                 int ky, int kx, int S, int Sf) {
  const float2* col = rowt + (size_t)c * S * Sf + kx;
  float re = 0.0f, im = 0.0f;
  int j = 0;
  for (int y = 0; y < S; ++y) {
    const float2 a = col[y * Sf];
    const float2 w = tw[j];
    re += a.x * w.x - a.y * w.y;
    im += a.x * w.y + a.y * w.x;
    j += ky;
    if (j >= S) j -= S;
  }
  return make_float2(re, im);
}

// Inverse DFT along rows (ky) of a half spectrum: in [S, Sf] -> out [S, Sf]
// with out[y][kx] = sum_ky in[ky][kx] e^{+2 pi i ky y / S}.
__device__ inline void inv_cols(const float2* in, float2* out,
                                const float2* tw, int S, int Sf) {
  for (int idx = threadIdx.x; idx < S * Sf; idx += blockDim.x) {
    const int y = idx / Sf;
    const int kx = idx - y * Sf;
    float re = 0.0f, im = 0.0f;
    int j = 0;
    for (int ky = 0; ky < S; ++ky) {
      const float2 a = in[ky * Sf + kx];
      const float2 w = tw[j];                    // conj(w) = e^{+i theta}
      re += a.x * w.x + a.y * w.y;
      im += a.y * w.x - a.x * w.y;
      j += y;
      if (j >= S) j -= S;
    }
    out[idx] = make_float2(re, im);
  }
}

// Real inverse along columns: sum_kx fold(kx) Re(t[y][kx] e^{+2 pi i kx x
// / S}) / (S S) at (y, x).
__device__ inline float inv_row(const float2* t, const float2* tw, int y,
                                int x, int S, int Sf, float inv_n) {
  float v = 0.0f;
  int j = 0;
  for (int kx = 0; kx < Sf; ++kx) {
    const float2 a = t[y * Sf + kx];
    const float2 w = tw[j];
    v += fold(kx, S) * (a.x * w.x + a.y * w.y);
    j += x;
    if (j >= S) j -= S;
  }
  return v * inv_n;
}

// rfft2 of the real S x S kernel in m.real, first stage: m.tmp[y][kx].
__device__ inline void rows_rfft_smem(Smem m, int S, int Sf) {
  for (int idx = threadIdx.x; idx < S * Sf; idx += blockDim.x) {
    const int y = idx / Sf;
    const int kx = idx - y * Sf;
    const float* row = m.real + y * S;
    float re = 0.0f, im = 0.0f;
    int j = 0;
    for (int x = 0; x < S; ++x) {
      const float v = row[x];
      const float2 w = m.tw[j];
      re += v * w.x;
      im += v * w.y;
      j += kx;
      if (j >= S) j -= S;
    }
    m.tmp[idx] = make_float2(re, im);
  }
}

// cross (m.spec, summed over channels) -> Gaussian kernel k in m.real.
__device__ inline void gaussian_kernel(Smem m, int S, int Sf, float energies,
                                       float denom) {
  const float inv_n = 1.0f / (float)(S * S);
  inv_cols(m.spec, m.tmp, m.tw, S, Sf);
  __syncthreads();
  for (int idx = threadIdx.x; idx < S * S; idx += blockDim.x) {
    const int y = idx / S;
    const int x = idx - y * S;
    const float cross = inv_row(m.tmp, m.tw, y, x, S, Sf, inv_n);
    const float d = energies - 2.0f * cross;
    m.real[idx] = expf(-fmaxf(d, 0.0f) / denom);
  }
  __syncthreads();
  rows_rfft_smem(m, S, Sf);
  __syncthreads();
}

__device__ inline void load_twiddles(Smem m, const float2* __restrict__ tw,
                                     int S) {
  for (int i = threadIdx.x; i < S; i += blockDim.x) m.tw[i] = tw[i];
  __syncthreads();
}

// K4: grid = N items; item i correlates feat[i] with model row i % T.
__global__ void __launch_bounds__(kThreads)
kcf_detect_kernel(const float* __restrict__ feat,
                  const float2* __restrict__ xf,
                  const float2* __restrict__ alphaf,
                  const float2* __restrict__ twg, float* __restrict__ out,
                  int T, int C, int S, float denom) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Sf = S / 2 + 1;
  const Smem m = carve(smem_raw, C, S, Sf);
  const int item = blockIdx.x;
  const int mrow = item % T;
  load_twiddles(m, twg, S);
  rows_rfft(feat + (size_t)item * C * S * S, m, C, S, Sf);
  __syncthreads();

  // Stage 2: per frequency, column DFT of each channel, cross spectrum
  // z^ conj(x^) and the two Parseval energies, summed over channels.
  const float2* xm = xf + (size_t)mrow * C * S * Sf;
  float ez = 0.0f, ex = 0.0f;
  for (int idx = threadIdx.x; idx < S * Sf; idx += blockDim.x) {
    const int ky = idx / Sf;
    const int kx = idx - ky * Sf;
    const float wk = fold(kx, S);
    float cr = 0.0f, ci = 0.0f;
    for (int c = 0; c < C; ++c) {
      const float2 z = col_dft(m.rowt, m.tw, c, ky, kx, S, Sf);
      const float2 x = xm[(size_t)c * S * Sf + idx];
      cr += z.x * x.x + z.y * x.y;
      ci += z.y * x.x - z.x * x.y;
      ez += wk * (z.x * z.x + z.y * z.y);
      ex += wk * (x.x * x.x + x.y * x.y);
    }
    m.spec[idx] = make_float2(cr, ci);
  }
  const float2 e = block_sum2(ez, ex, m.red);
  const float inv_n = 1.0f / (float)(S * S);
  gaussian_kernel(m, S, Sf, e.x * inv_n + e.y * inv_n, denom);

  // Stage 4b: k^ = column DFT, times alpha^ of the model row.
  const float2* am = alphaf + (size_t)mrow * S * Sf;
  for (int idx = threadIdx.x; idx < S * Sf; idx += blockDim.x) {
    const int ky = idx / Sf;
    const int kx = idx - ky * Sf;
    const float2 k = col_dft(m.tmp, m.tw, 0, ky, kx, S, Sf);
    const float2 a = am[idx];
    m.spec[idx] = make_float2(k.x * a.x - k.y * a.y, k.x * a.y + k.y * a.x);
  }
  __syncthreads();

  // Stage 5: response = irfft2(k^ alpha^).
  inv_cols(m.spec, m.tmp, m.tw, S, Sf);
  __syncthreads();
  float* o = out + (size_t)item * S * S;
  for (int idx = threadIdx.x; idx < S * S; idx += blockDim.x) {
    const int y = idx / S;
    const int x = idx - y * S;
    o[idx] = inv_row(m.tmp, m.tw, y, x, S, Sf, inv_n);
  }
}

// ---- K4 at S = 16: FFTs in registers -----------------------------------

constexpr int kFS = 16;             // the specialised feature size
constexpr int kFSf = kFS / 2 + 1;   // 9
constexpr int kFN = kFS * kFSf;     // 144 half-spectrum points
constexpr int kFWarps = kFSf;       // a warp per kx in the column stage
constexpr int kFThreads = 32 * kFWarps;
constexpr int kFMaxC = 32;          // a lane per channel
constexpr int kFCtasPerSm = 3;      // 384 items on 132 SMs in one wave

// cos(pi/8), sin(pi/8), sqrt(1/2), rounded from float64.
constexpr float kC1 = 0.92387953251128674f;
constexpr float kS1 = 0.38268343236508977f;
constexpr float kR2 = 0.70710678118654752f;

// Where fft16 leaves output k (and where it is again applied: its own
// inverse): the base-4 digits of k swapped.
__host__ __device__ constexpr int rev16(int k) {
  return 4 * (k & 3) + (k >> 2);
}

// v (c - i s) forward, v (c + i s) inverse.
template <bool kInv>
__device__ __forceinline__ float2 twiddle(float2 v, float c, float s) {
  return kInv ? make_float2(v.x * c - v.y * s, v.y * c + v.x * s)
              : make_float2(v.x * c + v.y * s, v.y * c - v.x * s);
}

// 4-point DFT in place: (a, b, c, d) -> outputs 0, 1, 2, 3.
template <bool kInv>
__device__ __forceinline__ void dft4(float2& a, float2& b, float2& c,
                                     float2& d) {
  const float2 t0 = make_float2(a.x + c.x, a.y + c.y);
  const float2 t1 = make_float2(a.x - c.x, a.y - c.y);
  const float2 t2 = make_float2(b.x + d.x, b.y + d.y);
  const float2 t3 = make_float2(b.x - d.x, b.y - d.y);
  a = make_float2(t0.x + t2.x, t0.y + t2.y);
  c = make_float2(t0.x - t2.x, t0.y - t2.y);
  // forward: t1 -/+ i t3; inverse: t1 +/- i t3
  const float2 lo = make_float2(t1.x + t3.y, t1.y - t3.x);
  const float2 hi = make_float2(t1.x - t3.y, t1.y + t3.x);
  b = kInv ? hi : lo;
  d = kInv ? lo : hi;
}

// Unnormalised 16-point DFT of v (natural order) in place; output k is
// left in v[rev16(k)].  n = 4 a + b, k = k1 + 4 k2: 4-point DFTs over a,
// twiddles w16^(b k1), 4-point DFTs over b.
template <bool kInv>
__device__ __forceinline__ void fft16(float2 (&v)[16]) {
#pragma unroll
  for (int b = 0; b < 4; ++b) dft4<kInv>(v[b], v[b + 4], v[b + 8], v[b + 12]);
  // Y[b][k1] sits in v[b + 4 k1]; its twiddle is w16^(b k1).
  v[5] = twiddle<kInv>(v[5], kC1, kS1);      // 1
  v[9] = twiddle<kInv>(v[9], kR2, kR2);      // 2
  v[13] = twiddle<kInv>(v[13], kS1, kC1);    // 3
  v[6] = twiddle<kInv>(v[6], kR2, kR2);      // 2
  v[10] = kInv ? make_float2(-v[10].y, v[10].x)
               : make_float2(v[10].y, -v[10].x);  // 4: -/+ i
  v[14] = twiddle<kInv>(v[14], -kR2, kR2);   // 6
  v[7] = twiddle<kInv>(v[7], kS1, kC1);      // 3
  v[11] = twiddle<kInv>(v[11], -kR2, kR2);   // 6
  v[15] = twiddle<kInv>(v[15], -kC1, -kS1);  // 9
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1) {
    dft4<kInv>(v[4 * k1], v[4 * k1 + 1], v[4 * k1 + 2], v[4 * k1 + 3]);
  }
}

// Half spectra A, B (k = 0..8) of the two real rows packed as z = a + i b,
// from Z = fft16(z) (digit-reversed, as fft16 leaves it).
__device__ __forceinline__ void split_pair(const float2 (&z)[16], int k,
                                           float2& a, float2& b) {
  const float2 p = z[rev16(k)];
  const float2 m = z[rev16((16 - k) & 15)];
  a = make_float2(0.5f * (p.x + m.x), 0.5f * (p.y - m.y));
  b = make_float2(0.5f * (p.y + m.y), 0.5f * (m.x - p.x));
}

// The inverse packing: v = A + i B over all 16 frequencies from the half
// spectra of two real rows, rows `ra` and `rb` of t [S, Sf]; as a
// real-output inverse does, the imaginary parts of DC and Nyquist are
// not read.
__device__ __forceinline__ void join_pair(const float2* t, int ra, int rb,
                                          float2 (&v)[16]) {
  const float2* a = t + ra * kFSf;
  const float2* b = t + rb * kFSf;
  v[0] = make_float2(a[0].x, b[0].x);
  v[8] = make_float2(a[8].x, b[8].x);
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    const float2 p = a[k];
    const float2 q = b[k];
    v[k] = make_float2(p.x - q.y, p.y + q.x);
    v[16 - k] = make_float2(p.x + q.y, q.x - p.y);
  }
}

// One step of the reduce-scatter over a warp's lanes: a lane keeps the
// half of q[0 .. 2 kH) that its bit kH selects and adds the partner's copy
// of it (keep + received: the same sum on both sides of a pair).
template <int kH, int kN>
__device__ __forceinline__ void scatter_step(float (&q)[kN], int lane) {
  const bool up = (lane & kH) != 0;
#pragma unroll
  for (int i = 0; i < kH; ++i) {
    const float send = up ? q[i] : q[i + kH];
    const float keep = up ? q[i + kH] : q[i];
    q[i] = keep + __shfl_xor_sync(0xffffffffu, send, kH);
  }
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

size_t fft16_smem_bytes(int C) {
  // rowt [S, Sf, C] + xfs [S, Sf, C | 1] + alpha, spec, tmp [S, Sf]
  // complex; red [2 * warps] floats.
  return sizeof(float2) * ((size_t)kFN * (C + (C | 1)) + 3 * kFN) +
         sizeof(float) * 2 * kFWarps;
}

// K4, S = 16, C <= 32: grid = N items; item i against model row i % T.
__global__ void __launch_bounds__(kFThreads, kFCtasPerSm)
kcf_detect_fft16_kernel(const float* __restrict__ feat,
                        const float2* __restrict__ xf,
                        const float2* __restrict__ alphaf,
                        float* __restrict__ out, int T, int C, float denom) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Cp = C | 1;  // odd: the transposing copies hit distinct banks
  float2* rowt = reinterpret_cast<float2*>(smem_raw);  // [y, kx, c]
  float2* xfs = rowt + kFN * C;                        // [ky, kx, c]
  float2* alpha = xfs + kFN * Cp;                      // [ky, kx]
  float2* spec = alpha + kFN;
  float2* tmp = spec + kFN;
  float* red = reinterpret_cast<float*>(tmp + kFN);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int item = blockIdx.x;
  const int mrow = item % T;

  // 1. The model row, asynchronously: x^ transposed, alpha^ as it is.
  const float2* xm = xf + (size_t)mrow * C * kFN;
  for (int e = tid; e < C * kFN; e += kFThreads) {
    const int c = e / kFN;
    cp_async8(xfs + (e - c * kFN) * Cp + c, xm + e);
  }
  if (tid < kFN) cp_async8(alpha + tid, alphaf + (size_t)mrow * kFN + tid);
  asm volatile("cp.async.commit_group;" ::: "memory");

  // 2. Row stage: rows 2 yp and 2 yp + 1 of channel c in one complex FFT.
  float zz = 0.0f;
  if (tid < (kFS / 2) * C) {
    const int yp = tid / C;
    const int c = tid - yp * C;
    const float4* src = reinterpret_cast<const float4*>(
        feat + ((size_t)item * C + c) * (kFS * kFS) + 2 * yp * kFS);
    float2 v[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 a = __ldg(src + i);
      const float4 b = __ldg(src + 4 + i);
      v[4 * i] = make_float2(a.x, b.x);
      v[4 * i + 1] = make_float2(a.y, b.y);
      v[4 * i + 2] = make_float2(a.z, b.z);
      v[4 * i + 3] = make_float2(a.w, b.w);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) zz += v[i].x * v[i].x + v[i].y * v[i].y;
    fft16<false>(v);
    float2* ra = rowt + (size_t)(2 * yp) * kFSf * C + c;
#pragma unroll
    for (int k = 0; k < kFSf; ++k) {
      float2 a, b;
      split_pair(v, k, a, b);
      ra[k * C] = a;
      ra[(kFSf + k) * C] = b;
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  // 3. Column stage: warp = kx, lane = c.  Column FFT, z^ conj(x^) into
  // v[rev16(ky)], |x^|^2.
  const int kx = warp;
  float2 v[16];
  float ex = 0.0f;
  if (lane < C) {
#pragma unroll
    for (int y = 0; y < 16; ++y) v[y] = rowt[(y * kFSf + kx) * C + lane];
    fft16<false>(v);
#pragma unroll
    for (int ky = 0; ky < 16; ++ky) {
      const float2 x = xfs[(ky * kFSf + kx) * Cp + lane];
      const float2 z = v[rev16(ky)];
      v[rev16(ky)] = make_float2(z.x * x.x + z.y * x.y,
                                 z.y * x.x - z.x * x.y);
      ex += x.x * x.x + x.y * x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = make_float2(0.0f, 0.0f);
  }
  // Sum over the channels: reduce-scatter over the lanes.  Lane l ends
  // with the total of float l of the 32 (position l / 2, re or im).
  float q[32];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    q[2 * i] = v[i].x;
    q[2 * i + 1] = v[i].y;
  }
  scatter_step<16>(q, lane);
  scatter_step<8>(q, lane);
  scatter_step<4>(q, lane);
  scatter_step<2>(q, lane);
  scatter_step<1>(q, lane);
  reinterpret_cast<float*>(spec)[2 * (rev16(lane >> 1) * kFSf + kx) +
                                 (lane & 1)] = q[0];
  // Both energies (the barrier inside also publishes spec).
  for (int o = 16; o > 0; o >>= 1) {
    zz += __shfl_xor_sync(0xffffffffu, zz, o);
    ex += __shfl_xor_sync(0xffffffffu, ex, o);
  }
  if (lane == 0) {
    red[warp] = zz;
    red[kFWarps + warp] = ex * fold(kx, kFS);
  }
  __syncthreads();
  if (warp != 0) return;
  float ezz = 0.0f, exx = 0.0f;
  for (int i = 0; i < kFWarps; ++i) {
    ezz += red[i];
    exx += red[kFWarps + i];
  }
  const float inv_n = 1.0f / (float)(kFS * kFS);
  const float energies = ezz + exx * inv_n;

  // 4. The small stages, all in warp 0.
  // a. cross spectrum: inverse over ky, a thread per kx.
  if (lane < kFSf) {
#pragma unroll
    for (int ky = 0; ky < 16; ++ky) v[ky] = spec[ky * kFSf + lane];
    fft16<true>(v);
#pragma unroll
    for (int y = 0; y < 16; ++y) tmp[y * kFSf + lane] = v[rev16(y)];
  }
  __syncwarp();
  // b. per row pair: inverse rows -> Gaussian kernel -> forward rows.
  if (lane < kFS / 2) {
    join_pair(tmp, 2 * lane, 2 * lane + 1, v);
    fft16<true>(v);
    float2 k[16];
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      const float2 cross = v[rev16(x)];
      k[x] = make_float2(
          expf(-fmaxf(energies - 2.0f * (cross.x * inv_n), 0.0f) / denom),
          expf(-fmaxf(energies - 2.0f * (cross.y * inv_n), 0.0f) / denom));
    }
    fft16<false>(k);
#pragma unroll
    for (int kk = 0; kk < kFSf; ++kk) {
      float2 a, b;
      split_pair(k, kk, a, b);
      spec[2 * lane * kFSf + kk] = a;
      spec[(2 * lane + 1) * kFSf + kk] = b;
    }
  }
  __syncwarp();
  // c. per kx: forward over y -> times alpha^ -> inverse over ky.
  if (lane < kFSf) {
#pragma unroll
    for (int y = 0; y < 16; ++y) v[y] = spec[y * kFSf + lane];
    fft16<false>(v);
    float2 w[16];
#pragma unroll
    for (int ky = 0; ky < 16; ++ky) {
      const float2 kf = v[rev16(ky)];
      const float2 a = alpha[ky * kFSf + lane];
      w[ky] = make_float2(kf.x * a.x - kf.y * a.y, kf.x * a.y + kf.y * a.x);
    }
    fft16<true>(w);
#pragma unroll
    for (int y = 0; y < 16; ++y) tmp[y * kFSf + lane] = w[rev16(y)];
  }
  __syncwarp();
  // d. response rows, two per thread.
  if (lane < kFS / 2) {
    join_pair(tmp, 2 * lane, 2 * lane + 1, v);
    fft16<true>(v);
    float4* o = reinterpret_cast<float4*>(out + (size_t)item * (kFS * kFS) +
                                          2 * lane * kFS);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[i] = make_float4(
          v[rev16(4 * i)].x * inv_n, v[rev16(4 * i + 1)].x * inv_n,
          v[rev16(4 * i + 2)].x * inv_n, v[rev16(4 * i + 3)].x * inv_n);
      o[4 + i] = make_float4(
          v[rev16(4 * i)].y * inv_n, v[rev16(4 * i + 1)].y * inv_n,
          v[rev16(4 * i + 2)].y * inv_n, v[rev16(4 * i + 3)].y * inv_n);
    }
  }
}

// Generic K5: grid = T tracks.
__global__ void __launch_bounds__(kThreads)
kcf_train_kernel(const float* __restrict__ feat,
                 const float2* __restrict__ xf,
                 const float2* __restrict__ alphaf,
                 const float2* __restrict__ yf,
                 const float* __restrict__ lr_g,
                 const float2* __restrict__ twg, float2* __restrict__ out_xf,
                 float2* __restrict__ out_alphaf, int C, int S, float denom,
                 float lambda) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Sf = S / 2 + 1;
  const Smem m = carve(smem_raw, C, S, Sf);
  const int t = blockIdx.x;
  const float lr = lr_g[t];
  const float keep = 1.0f - lr;
  load_twiddles(m, twg, S);
  rows_rfft(feat + (size_t)t * C * S * S, m, C, S, Sf);
  __syncthreads();

  // Stage 2: x^ per channel, blended into the model as it is formed;
  // x^ conj(x^) = |x^|^2 is real, summed over channels, and its energy.
  const size_t base = (size_t)t * C * S * Sf;
  float ex = 0.0f;
  for (int idx = threadIdx.x; idx < S * Sf; idx += blockDim.x) {
    const int ky = idx / Sf;
    const int kx = idx - ky * Sf;
    const float wk = fold(kx, S);
    float cr = 0.0f;
    for (int c = 0; c < C; ++c) {
      const float2 x = col_dft(m.rowt, m.tw, c, ky, kx, S, Sf);
      const size_t at = base + (size_t)c * S * Sf + idx;
      const float2 old = xf[at];
      out_xf[at] = make_float2(old.x * keep + x.x * lr,
                               old.y * keep + x.y * lr);
      const float p = x.x * x.x + x.y * x.y;
      cr += p;
      ex += wk * p;
    }
    m.spec[idx] = make_float2(cr, 0.0f);
  }
  const float2 e = block_sum2(ex, 0.0f, m.red);
  const float xx = e.x * (1.0f / (float)(S * S));
  gaussian_kernel(m, S, Sf, xx + xx, denom);

  // Stage 4b: k^ = column DFT; alpha^ = y^ / (k^ + lambda); blend.
  const size_t abase = (size_t)t * S * Sf;
  for (int idx = threadIdx.x; idx < S * Sf; idx += blockDim.x) {
    const int ky = idx / Sf;
    const int kx = idx - ky * Sf;
    const float2 k = col_dft(m.tmp, m.tw, 0, ky, kx, S, Sf);
    const float2 y = yf[idx];
    const float dr = k.x + lambda;
    const float inv = 1.0f / fmaxf(dr * dr + k.y * k.y, 1e-20f);
    const float nr = (y.x * dr + y.y * k.y) * inv;
    const float ni = (y.y * dr - y.x * k.y) * inv;
    const float2 old = alphaf[abase + idx];
    out_alphaf[abase + idx] = make_float2(old.x * keep + nr * lr,
                                          old.y * keep + ni * lr);
  }
}

// ---- K5 at S = 16: FFTs in registers -----------------------------------

constexpr int kStreamThreads = kFThreads - 32;  // warps 1-8 stream x^
constexpr int kStreamLoads = 3;   // 16-byte loads a thread has in flight

size_t train_fft16_smem_bytes(int C) {
  // xs [S, Sf, C | 1] + alpha, yfs, spec, tmp [S, Sf] complex; red [warps]
  // floats.
  return sizeof(float2) * ((size_t)kFN * (C | 1) + 4 * kFN) +
         sizeof(float) * kFWarps;
}

// K5, S = 16, C <= 32: grid = T tracks; feat, xf and out_xf 16-byte aligned.
__global__ void __launch_bounds__(kFThreads, kFCtasPerSm)
kcf_train_fft16_kernel(const float* __restrict__ feat,
                       const float2* __restrict__ xf,
                       const float2* __restrict__ alphaf,
                       const float2* __restrict__ yf,
                       const float* __restrict__ lr_g,
                       float2* __restrict__ out_xf,
                       float2* __restrict__ out_alphaf, int C, float denom,
                       float lambda) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Cp = C | 1;  // odd: the transposed read-back hits distinct banks
  // Row spectra [y, kx, c]; the column stage leaves x^ [ky, kx, c] in place.
  float2* xs = reinterpret_cast<float2*>(smem_raw);
  float2* alpha = xs + kFN * Cp;  // the old alpha^ row [ky, kx]
  float2* yfs = alpha + kFN;      // y^ [ky, kx]
  float2* spec = yfs + kFN;       // sum_c |x^|^2 (as floats), then k's rows
  float2* tmp = spec + kFN;
  float* red = reinterpret_cast<float*>(tmp + kFN);
  float* kxx = reinterpret_cast<float*>(spec);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t = blockIdx.x;
  const float lr = lr_g[t];
  const float keep = 1.0f - lr;

  // 1. What the last stage needs, asynchronously: old alpha^ and y^.
  if (tid < kFN) {
    cp_async8(alpha + tid, alphaf + (size_t)t * kFN + tid);
  } else {
    cp_async8(yfs + (tid - kFN), yf + (tid - kFN));
  }
  asm volatile("cp.async.commit_group;" ::: "memory");

  // 2. Row stage: rows 2 yp and 2 yp + 1 of channel c in one complex FFT;
  // x's energy from the features.
  float xx = 0.0f;
  if (tid < (kFS / 2) * C) {
    const int yp = tid / C;
    const int c = tid - yp * C;
    const float4* src = reinterpret_cast<const float4*>(
        feat + ((size_t)t * C + c) * (kFS * kFS) + 2 * yp * kFS);
    float2 v[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 a = __ldg(src + i);
      const float4 b = __ldg(src + 4 + i);
      v[4 * i] = make_float2(a.x, b.x);
      v[4 * i + 1] = make_float2(a.y, b.y);
      v[4 * i + 2] = make_float2(a.z, b.z);
      v[4 * i + 3] = make_float2(a.w, b.w);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) xx += v[i].x * v[i].x + v[i].y * v[i].y;
    fft16<false>(v);
    float2* ra = xs + (size_t)(2 * yp) * kFSf * Cp + c;
#pragma unroll
    for (int k = 0; k < kFSf; ++k) {
      float2 a, b;
      split_pair(v, k, a, b);
      ra[k * Cp] = a;
      ra[(kFSf + k) * Cp] = b;
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  // 3. Column stage: warp = kx, lane = c.  A thread reads its sixteen slots,
  // transforms them and writes x^ back to the same slots; |x^|^2 of slot i
  // (ky = rev16(i)) goes to the channel sum.
  const int kx = warp;
  float q[16];
  if (lane < C) {
    float2 v[16];
#pragma unroll
    for (int y = 0; y < 16; ++y) v[y] = xs[(y * kFSf + kx) * Cp + lane];
    fft16<false>(v);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      q[i] = v[i].x * v[i].x + v[i].y * v[i].y;
      xs[(rev16(i) * kFSf + kx) * Cp + lane] = v[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) q[i] = 0.0f;
  }
  // Sum over the channels: reduce-scatter within each half-warp (lane l
  // ends with slot l & 15), then one exchange across the halves; both
  // sides of every pair add the same two numbers.
  scatter_step<8>(q, lane);
  scatter_step<4>(q, lane);
  scatter_step<2>(q, lane);
  scatter_step<1>(q, lane);
  const float total = q[0] + __shfl_xor_sync(0xffffffffu, q[0], 16);
  if (lane < 16) kxx[rev16(lane) * kFSf + kx] = total;
  for (int o = 16; o > 0; o >>= 1) xx += __shfl_xor_sync(0xffffffffu, xx, o);
  if (lane == 0) red[warp] = xx;
  __syncthreads();

  // 4. Warps 1-8: the new model row.  Two complex values per 16-byte
  // access, in the [c, ky, kx] order of device memory; 144 is even, so a
  // pair stays inside one channel.
  if (warp != 0) {
    const int n4 = C * (kFN / 2);
    const float4* oldp =
        reinterpret_cast<const float4*>(xf + (size_t)t * C * kFN);
    float4* newp = reinterpret_cast<float4*>(out_xf + (size_t)t * C * kFN);
    for (int base = tid - 32; base < n4;
         base += kStreamLoads * kStreamThreads) {
      float4 o[kStreamLoads];
#pragma unroll
      for (int u = 0; u < kStreamLoads; ++u) {
        const int idx = base + u * kStreamThreads;
        if (idx < n4) o[u] = __ldg(oldp + idx);
      }
#pragma unroll
      for (int u = 0; u < kStreamLoads; ++u) {
        const int idx = base + u * kStreamThreads;
        if (idx < n4) {
          const int c = (2 * idx) / kFN;
          const int r = 2 * idx - c * kFN;       // ky * Sf + kx, even
          const float2 x0 = xs[r * Cp + c];
          const float2 x1 = xs[(r + 1) * Cp + c];
          newp[idx] = make_float4(
              o[u].x * keep + x0.x * lr, o[u].y * keep + x0.y * lr,
              o[u].z * keep + x1.x * lr, o[u].w * keep + x1.y * lr);
        }
      }
    }
    return;
  }

  // 5. Warp 0: the three small stages.
  float exx = 0.0f;
  for (int i = 0; i < kFWarps; ++i) exx += red[i];
  const float inv_n = 1.0f / (float)(kFS * kFS);
  const float energies = exx + exx;
  float2 v[16];
  // a. sum_c |x^|^2: inverse over ky, a thread per kx.
  if (lane < kFSf) {
#pragma unroll
    for (int ky = 0; ky < 16; ++ky) {
      v[ky] = make_float2(kxx[ky * kFSf + lane], 0.0f);
    }
    fft16<true>(v);
#pragma unroll
    for (int y = 0; y < 16; ++y) tmp[y * kFSf + lane] = v[rev16(y)];
  }
  __syncwarp();
  // b. per row pair: inverse rows -> Gaussian kernel -> forward rows.
  if (lane < kFS / 2) {
    join_pair(tmp, 2 * lane, 2 * lane + 1, v);
    fft16<true>(v);
    float2 k[16];
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      const float2 cross = v[rev16(x)];
      k[x] = make_float2(
          expf(-fmaxf(energies - 2.0f * (cross.x * inv_n), 0.0f) / denom),
          expf(-fmaxf(energies - 2.0f * (cross.y * inv_n), 0.0f) / denom));
    }
    fft16<false>(k);
#pragma unroll
    for (int kk = 0; kk < kFSf; ++kk) {
      float2 a, b;
      split_pair(k, kk, a, b);
      spec[2 * lane * kFSf + kk] = a;
      spec[(2 * lane + 1) * kFSf + kk] = b;
    }
  }
  __syncwarp();
  // c. per kx: forward over y -> alpha^ = y^ / (k^ + lambda) -> blend.
  if (lane < kFSf) {
#pragma unroll
    for (int y = 0; y < 16; ++y) v[y] = spec[y * kFSf + lane];
    fft16<false>(v);
    float2* o = out_alphaf + (size_t)t * kFN + lane;
#pragma unroll
    for (int ky = 0; ky < 16; ++ky) {
      const float2 kf = v[rev16(ky)];
      const float2 y = yfs[ky * kFSf + lane];
      const float dr = kf.x + lambda;
      const float inv = 1.0f / fmaxf(dr * dr + kf.y * kf.y, 1e-20f);
      const float nr = (y.x * dr + y.y * kf.y) * inv;
      const float ni = (y.y * dr - y.x * kf.y) * inv;
      const float2 old = alpha[ky * kFSf + lane];
      o[ky * kFSf] = make_float2(old.x * keep + nr * lr,
                                 old.y * keep + ni * lr);
    }
  }
}

// ---- K6: detect-site training at S = 64, C = 1 --------------------------
//
// Stage 8 of the tracker step under train_site="detect" at the default gray
// 64 x 64 template: blend(model, train_from_spectrum(shift_spectrum(zf, dy,
// dx)), lr) on [R, 1, 64, 33] spectra, R = streams x slots.  It replaces no
// TPU kernel (the JAX package leaves this chain to XLA); it was added
// because the chain ran as ~100 elementwise and reduction passes plus two
// cuFFT calls, ~18 ms a step at R = 32,768 on the H100, 4.6% of its bound.
//
// Bound: bytes.  A row reads z^, the old x^ and the old alpha^ and writes the
// new x^ and alpha^, 5 x 16,896 B = 84.5 KB; at R = 32,768 that is 2.77 GB,
// 0.83 ms at 3.35 TB/s.  The arithmetic (four 2-D passes of 64-point FFTs,
// 4,096 exp, 2,112 sincos a row) is ~0.2 ms at the float32 peak.
//
// Design: one CTA of 256 threads per row, four CTAs per SM (64 registers,
// ~37 KB of static shared memory), so the rows in flight cover the
// latency; no intermediate leaves the SM.
//   1. Every thread streams 16-byte words of z^ and the old x^ (five each,
//      all loads issued before use), applies the phase shift, writes the
//      blended x^ straight back out (coalesced, streaming stores) and keeps
//      |x^|^2 in shared memory with its Parseval-weighted sum.  The old
//      alpha^ row is prefetched into L2 at entry and read last.
//   2. The 64-point FFTs run in registers: a group of 8 lanes holds one
//      transform, 8 points a lane, as an 8 x 8 Cooley-Tukey schedule
//      (8-point DFTs as two 4-point ones, twiddles w64^(j k1) from the
//      float64-derived table `tw`, one transpose through the group's own
//      8 x 9 scratch, whose odd stride puts both directions on 32 distinct
//      banks).  Lane j ends with outputs j + 8 k, the order the next
//      transform of the same lane takes as input, so inverse rows -> exp ->
//      forward rows need no exchange.
//   3. Passes: inverse columns (17 transforms: real columns in pairs (g,
//      g + 16), DC with Nyquist, column 16 alone); per row pair inverse
//      rows -> k = exp(-max(2 xx - 2 cross, 0) / (sigma^2 4096)) -> forward
//      rows (32 transforms, one per group); forward columns (17 transforms,
//      columns in pairs).  The planes' row stride 36 keeps every pass's
//      column and row reads on distinct banks.
//   4. alpha^ = y^ / (k^ + lambda), floored at 1e-20, blended with the old
//      alpha^ and written as 16-byte words.
// Identities used (each exact in the mathematics; the kernel stays within
// the card tests' tolerance of the plain chain):
//   - the auto-correlation's cross spectrum sum_c x^ conj(x^) = |x^|^2 is
//     real (its imaginary part is taken as 0);
//   - k is real and even (an auto-correlation), so k^ is real: two columns
//     of the row transforms go through one complex column FFT as
//     A + i B, and k^ = Re, Im of the result (the imaginary part of k^ is
//     taken as 0);
//   - C2R semantics: the imaginary parts of the DC and Nyquist columns are
//     dropped, as cuFFT's and numpy's inverse real transforms drop them.
// The x^ path repeats the plain chain's roundings one by one (__fmul_rn,
// __fadd_rn: no contraction).  Sums run in a fixed order and nothing is
// atomic: a row's result depends on that row alone, bit for bit.

constexpr int kGS = 64;                // template side
constexpr int kGSf = kGS / 2 + 1;      // 33
constexpr int kGN4 = kGS * kGSf / 2;   // 1056 16-byte words a row
constexpr int kGThreads = 256;
constexpr int kGWarps = kGThreads / 32;
constexpr int kGCtasPerSm = 4;
constexpr int kGW = 36;                // plane row stride (floats)
constexpr int kGX = 8 * 9;             // a group's scratch plane (floats)
constexpr int kGWords = (kGN4 + kGThreads - 1) / kGThreads;  // 5 a thread
constexpr int kGColGroups = 17;        // groups of a column pass

// A group's 64-point FFT (kInv: e^{+}).  On entry lane j holds x(8 n1 + j)
// in v[n1]; on exit X(j + 8 k2) in v[k2].  sr, si: the group's scratch.
template <bool kInv>
__device__ __forceinline__ void fft64(float2 (&v)[8], int j, float* sr,
                                      float* si, const float2* tw) {
  dft4<kInv>(v[0], v[2], v[4], v[6]);
  dft4<kInv>(v[1], v[3], v[5], v[7]);
  const float2 o1 = twiddle<kInv>(v[3], kR2, kR2);
  const float2 o2 = kInv ? make_float2(-v[5].y, v[5].x)
                         : make_float2(v[5].y, -v[5].x);
  const float2 o3 = twiddle<kInv>(v[7], -kR2, kR2);
  float2 y[8];
  y[0] = make_float2(v[0].x + v[1].x, v[0].y + v[1].y);
  y[4] = make_float2(v[0].x - v[1].x, v[0].y - v[1].y);
  y[1] = make_float2(v[2].x + o1.x, v[2].y + o1.y);
  y[5] = make_float2(v[2].x - o1.x, v[2].y - o1.y);
  y[2] = make_float2(v[4].x + o2.x, v[4].y + o2.y);
  y[6] = make_float2(v[4].x - o2.x, v[4].y - o2.y);
  y[3] = make_float2(v[6].x + o3.x, v[6].y + o3.y);
  y[7] = make_float2(v[6].x - o3.x, v[6].y - o3.y);
#pragma unroll
  for (int k1 = 1; k1 < 8; ++k1) {
    const float2 w = tw[(j * k1) & 63];
    y[k1] = twiddle<kInv>(y[k1], w.x, -w.y);
  }
  __syncwarp();  // the scratch's last readers are done
#pragma unroll
  for (int k1 = 0; k1 < 8; ++k1) {
    sr[k1 * 9 + j] = y[k1].x;
    si[k1 * 9 + j] = y[k1].y;
  }
  __syncwarp();
#pragma unroll
  for (int n2 = 0; n2 < 8; ++n2) {
    v[n2] = make_float2(sr[j * 9 + n2], si[j * 9 + n2]);
  }
  dft4<kInv>(v[0], v[2], v[4], v[6]);
  dft4<kInv>(v[1], v[3], v[5], v[7]);
  const float2 p1 = twiddle<kInv>(v[3], kR2, kR2);
  const float2 p2 = kInv ? make_float2(-v[5].y, v[5].x)
                         : make_float2(v[5].y, -v[5].x);
  const float2 p3 = twiddle<kInv>(v[7], -kR2, kR2);
  y[0] = make_float2(v[0].x + v[1].x, v[0].y + v[1].y);
  y[4] = make_float2(v[0].x - v[1].x, v[0].y - v[1].y);
  y[1] = make_float2(v[2].x + p1.x, v[2].y + p1.y);
  y[5] = make_float2(v[2].x - p1.x, v[2].y - p1.y);
  y[2] = make_float2(v[4].x + p2.x, v[4].y + p2.y);
  y[6] = make_float2(v[4].x - p2.x, v[4].y - p2.y);
  y[3] = make_float2(v[6].x + p3.x, v[6].y + p3.y);
  y[7] = make_float2(v[6].x - p3.x, v[6].y - p3.y);
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = y[k];
}

// X(-(j + 8 k)) for each k, from the partner lane (8 - j) & 7 of the group.
__device__ __forceinline__ void mirrored(const float2 (&v)[8], int j,
                                         int lane, float2 (&m)[8]) {
  const int src = (lane & ~7) | ((8 - j) & 7);
  float2 r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    r[i] = make_float2(__shfl_sync(0xffffffffu, v[i].x, src),
                       __shfl_sync(0xffffffffu, v[i].y, src));
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) m[k] = j == 0 ? r[(8 - k) & 7] : r[7 - k];
}

// Column pass group g < 17: columns (g, g + 16) for 1 <= g <= 15, DC with
// Nyquist (0, 32) for g = 0, column 16 alone for g = 16 (b = -1).
__device__ __forceinline__ int pair_col_b(int g) {
  return g == 0 ? 32 : (g < 16 ? g + 16 : -1);
}

// K6: grid = R rows; every pointer 16-byte aligned.
__global__ void __launch_bounds__(kGThreads, kGCtasPerSm)
kcf_train_shift_kernel(const float4* __restrict__ zf,
                       const float4* __restrict__ xf,
                       const float4* __restrict__ alphaf,
                       const float4* __restrict__ yf,
                       const float* __restrict__ dy_g,
                       const float* __restrict__ dx_g,
                       const float* __restrict__ lr_g,
                       const float2* __restrict__ twg,
                       float4* __restrict__ out_xf,
                       float4* __restrict__ out_alphaf, float denom,
                       float lambda) {
  __shared__ float wre[kGS * kGW];   // [ky][kx] planes of the row's spectra
  __shared__ float wim[kGS * kGW];
  __shared__ float xre[32 * kGX];    // a group's transpose scratch
  __shared__ float xim[32 * kGX];
  __shared__ float2 tw[kGS];
  __shared__ float red[kGWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int j = tid & 7;
  const int grp = tid >> 3;
  float* sr = xre + grp * kGX;
  float* si = xim + grp * kGX;
  const size_t row = blockIdx.x;
  const size_t base = row * kGN4;

  // The old alpha^ row is read last: bring its 132 lines into L2 now.
  if (tid < kGN4 / 8) {
    asm volatile("prefetch.global.L2 [%0];" ::"l"(alphaf + base + 8 * tid));
  }
  if (tid < kGS) tw[tid] = twg[tid];
  const float lr = lr_g[row];
  const float keep = 1.0f - lr;
  const float sy = dy_g[row] * (1.0f / kGS);
  const float sx = dx_g[row] * (1.0f / kGS);

  // 1. Phase shift, x^ blend and |x^|^2, two spectrum points a word.
  float4 z[kGWords], o[kGWords];
#pragma unroll
  for (int i = 0; i < kGWords; ++i) {
    const int q = tid + i * kGThreads;
    if (q < kGN4) {
      z[i] = __ldcs(zf + base + q);
      o[i] = __ldcs(xf + base + q);
    }
  }
  float energy = 0.0f;
#pragma unroll
  for (int i = 0; i < kGWords; ++i) {
    const int q = tid + i * kGThreads;
    if (q < kGN4) {
      float zr[2] = {z[i].x, z[i].z}, zi[2] = {z[i].y, z[i].w};
      float nr[2], ni[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = 2 * q + h;
        const int ky = e / kGSf;
        const int kx = e - ky * kGSf;
        const float fy = (float)(ky < kGS / 2 ? ky : ky - kGS);
        const float theta = __fmul_rn(
            6.2831855f,
            __fadd_rn(__fmul_rn(fy, sy), __fmul_rn((float)kx, sx)));
        float sn, cs;
        sincosf(theta, &sn, &cs);
        const float ar = __fsub_rn(__fmul_rn(zr[h], cs), __fmul_rn(zi[h], sn));
        const float ai = __fadd_rn(__fmul_rn(zr[h], sn), __fmul_rn(zi[h], cs));
        nr[h] = ar;
        ni[h] = ai;
        const float p = __fadd_rn(__fmul_rn(ar, ar), __fmul_rn(ai, ai));
        wre[ky * kGW + kx] = p;
        energy += (kx == 0 || kx == kGS / 2) ? p : 2.0f * p;
      }
      __stcs(out_xf + base + q,
             make_float4(
                 __fadd_rn(__fmul_rn(o[i].x, keep), __fmul_rn(nr[0], lr)),
                 __fadd_rn(__fmul_rn(o[i].y, keep), __fmul_rn(ni[0], lr)),
                 __fadd_rn(__fmul_rn(o[i].z, keep), __fmul_rn(nr[1], lr)),
                 __fadd_rn(__fmul_rn(o[i].w, keep), __fmul_rn(ni[1], lr))));
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    energy += __shfl_xor_sync(0xffffffffu, energy, s);
  }
  if (lane == 0) red[warp] = energy;
  __syncthreads();
  float xx = 0.0f;
#pragma unroll
  for (int w = 0; w < kGWarps; ++w) xx += red[w];
  xx *= 1.0f / (float)(kGS * kGS);
  const float energies = xx + xx;

  // 2. Inverse columns: Q = sum_ky |x^|^2 e^{+}, real columns in pairs.
  if (warp < (kGColGroups + 3) / 4) {
    const bool act = grp < kGColGroups;
    const int a = act ? grp : 0;
    const int b = act ? pair_col_b(grp) : -1;
    float2 v[8];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int at = (8 * n + j) * kGW;
      v[n] = make_float2(act ? wre[at + a] : 0.0f,
                         b >= 0 ? wre[at + b] : 0.0f);
    }
    fft64<true>(v, j, sr, si, tw);
    float2 m[8];
    mirrored(v, j, lane, m);
    if (act) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int at = (j + 8 * k) * kGW;
        if (grp == 0) {  // DC and Nyquist: real (their imaginary parts drop)
          wre[at] = v[k].x;
          wim[at] = 0.0f;
          wre[at + 32] = v[k].y;
          wim[at + 32] = 0.0f;
        } else if (b < 0) {
          wre[at + a] = v[k].x;
          wim[at + a] = v[k].y;
        } else {  // A = (Z + conj Z-) / 2, B = (Z - conj Z-) / 2i
          wre[at + a] = 0.5f * (v[k].x + m[k].x);
          wim[at + a] = 0.5f * (v[k].y - m[k].y);
          wre[at + b] = 0.5f * (v[k].y + m[k].y);
          wim[at + b] = 0.5f * (m[k].x - v[k].x);
        }
      }
    }
  }
  __syncthreads();

  // 3. Rows 2 p and 2 p + 1 as one complex transform: inverse -> the
  // Gaussian kernel -> forward -> the two half spectra.
  {
    const int r1 = 8 * warp + 2 * (grp & 3);
    const float* a1r = wre + r1 * kGW;
    const float* a1i = wim + r1 * kGW;
    const float* a2r = a1r + kGW;
    const float* a2i = a1i + kGW;
    float2 v[8];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (n < 4) {  // kx = j + 8 n <= 31: Q1 + i Q2
        const int c = j + 8 * n;
        v[n] = make_float2(a1r[c] - a2i[c], a1i[c] + a2r[c]);
      } else {      // kx >= 32: conj Q1(64 - kx) + i conj Q2(64 - kx)
        const int c = kGS - j - 8 * n;
        v[n] = make_float2(a1r[c] + a2i[c], a2r[c] - a1i[c]);
      }
    }
    fft64<true>(v, j, sr, si, tw);
    const float inv_n = 1.0f / (float)(kGS * kGS);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      v[k] = make_float2(
          expf(-fmaxf(energies - 2.0f * (v[k].x * inv_n), 0.0f) / denom),
          expf(-fmaxf(energies - 2.0f * (v[k].y * inv_n), 0.0f) / denom));
    }
    fft64<false>(v, j, sr, si, tw);
    float2 m[8];
    mirrored(v, j, lane, m);
    float* b1r = wre + r1 * kGW;
    float* b1i = wim + r1 * kGW;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const int c = j + 8 * k;
      if (k < 4 || j == 0) {
        b1r[c] = 0.5f * (v[k].x + m[k].x);
        b1i[c] = 0.5f * (v[k].y - m[k].y);
        b1r[c + kGW] = 0.5f * (v[k].y + m[k].y);
        b1i[c + kGW] = 0.5f * (m[k].x - v[k].x);
      }
    }
  }
  __syncthreads();

  // 4. Forward columns: k^ = Re, Im of the transform of K_a + i K_b.
  if (warp < (kGColGroups + 3) / 4) {
    const bool act = grp < kGColGroups;
    const int a = act ? grp : 0;
    const int b = act ? pair_col_b(grp) : -1;
    float2 v[8];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int at = (8 * n + j) * kGW;
      const float ar = act ? wre[at + a] : 0.0f;
      const float ai = act ? wim[at + a] : 0.0f;
      const float br = b >= 0 ? wre[at + b] : 0.0f;
      const float bi = b >= 0 ? wim[at + b] : 0.0f;
      v[n] = make_float2(ar - bi, ai + br);
    }
    fft64<false>(v, j, sr, si, tw);
    if (act) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int at = (j + 8 * k) * kGW;
        wre[at + a] = v[k].x;
        if (b >= 0) wre[at + b] = v[k].y;
      }
    }
  }
  __syncthreads();

  // 5. alpha^ = y^ / (k^ + lambda), blended: two points a word.
  float4 old[kGWords], y[kGWords];
#pragma unroll
  for (int i = 0; i < kGWords; ++i) {
    const int q = tid + i * kGThreads;
    if (q < kGN4) {
      old[i] = __ldcs(alphaf + base + q);
      y[i] = __ldg(yf + q);
    }
  }
#pragma unroll
  for (int i = 0; i < kGWords; ++i) {
    const int q = tid + i * kGThreads;
    if (q < kGN4) {
      const int e = 2 * q;
      const int ky = e / kGSf;
      const int kx = e - ky * kGSf;
      const float k0 = wre[ky * kGW + kx];
      const float k1 =
          kx == kGSf - 1 ? wre[(ky + 1) * kGW] : wre[ky * kGW + kx + 1];
      const float d0 = k0 + lambda;
      const float d1 = k1 + lambda;
      const float i0 = 1.0f / fmaxf(__fmul_rn(d0, d0), 1e-20f);
      const float i1 = 1.0f / fmaxf(__fmul_rn(d1, d1), 1e-20f);
      const float n0r = __fmul_rn(__fmul_rn(y[i].x, d0), i0);
      const float n0i = __fmul_rn(__fmul_rn(y[i].y, d0), i0);
      const float n1r = __fmul_rn(__fmul_rn(y[i].z, d1), i1);
      const float n1i = __fmul_rn(__fmul_rn(y[i].w, d1), i1);
      __stcs(out_alphaf + base + q,
             make_float4(
                 __fadd_rn(__fmul_rn(old[i].x, keep), __fmul_rn(n0r, lr)),
                 __fadd_rn(__fmul_rn(old[i].y, keep), __fmul_rn(n0i, lr)),
                 __fadd_rn(__fmul_rn(old[i].z, keep), __fmul_rn(n1r, lr)),
                 __fadd_rn(__fmul_rn(old[i].w, keep), __fmul_rn(n1i, lr))));
    }
  }
}

// ---- K8: stage 2's search at S = 64, C = 1 -------------------------------
//
// Stage 2 of the tracker step at the default gray 64 x 64 template: the
// correlation of the windowed features of item i = k R + r (scale-major)
// with model row r, and what the tracker reads of the response, i.e.
// ops/kcf.search's chain rfft2 -> detect_from_spectrum (eqs. 31, 22) ->
// peak_displacement -> psr, on [K R, 1, 64, 64] features.  It replaces no
// TPU kernel (the JAX package leaves the unit-scale gray search to XLA); it
// was added because the chain ran as ~190 launches (a dozen full-size
// intermediates, two cuFFT round trips, psr's masks), ~15.4 ms a step at
// R = 32,768 on the H100, about 19 times its bound.
//
// Bound: bytes.  An item reads its features (16,384 B), the model's x^ and
// alpha^ (2 x 16,896 B) and writes z^ (16,896 B, which stage 8's K6 reads)
// and the response (16,384 B, which the appearance term reads) and five
// scalars: 83.5 KB, 2.74 GB at 32,768 items, 0.82 ms at 3.35 TB/s.  The
// arithmetic (eight passes of 32 64-point FFTs, 4,096 exp, the peak and
// two sidelobe sums) is ~0.4 ms at the float32 peak; counted in issued
// instructions (the transposes through shared memory, the shuffles, the
// index arithmetic) it is near 1 ms, so the design keeps every pass in
// registers and shared memory and several items in flight per SM.  On an
// H100 (700 W) it takes 1.53 ms at 32,768 items, 53% of the byte bound,
// against 16.8 ms for the chain.
//
// Design: K6's (one CTA of 256 threads per item, four CTAs per SM, the same
// `fft64` on groups of 8 lanes, the same planes at row stride 36, the same
// transpose scratch); no intermediate leaves the SM.
//   0. The model row's x^ and alpha^ (264 lines) are prefetched into L2 at
//      entry; each is read in the column pass that uses it.
//   1. Rows 2p and 2p + 1 of the features (group p) go through one complex
//      transform; z's energy is summed from the features (Parseval's other
//      side).  The half spectra land in the planes.
//   2. Columns (group g takes column g; group 0 takes the real columns 0
//      and 32 as one complex transform and splits them through the planes'
//      spare columns 33-35): forward -> z^, stored to device memory -> c^ =
//      z^ conj(x^) and x's Parseval energy -> inverse, in registers (a
//      transform leaves lane j with the outputs j + 8 k, the order the next
//      transform of the same lane takes).
//      Columns 0 and 32 of c^ go back through one transform as h0 + i h32,
//      their Hermitian parts, whose inverses are the real parts of theirs
//      (C2R semantics: the imaginary parts of DC and Nyquist are dropped).
//      x^ need not be Hermitian there: K6 trains the bank on a fractionally
//      shifted spectrum.
//   3. Per row pair: inverse -> k = exp(-max(zz + xx - 2 cross, 0) /
//      (sigma^2 4096)) -> forward, as K6's pass 3.
//   4. Columns: forward -> k^ alpha^ -> inverse, as pass 2 (no energy).
//   5. Per row pair: inverse -> the response, to device memory and to the
//      group's own scratch (its last transform is done with it).
//   6. On the response in shared memory: the first maximum in torch.argmax's
//      order (NaN first, then the larger value, then the lower flat index;
//      a total order, so any reduction tree gives the same index), the
//      parabolic sub-pixel fit of peak_displacement (1e-8 guard, +-0.5 clip,
//      interior rule) and psr's ratio over the sidelobe outside the 5-pixel
//      exclusion (its size counted from the window's clipped extent, its
//      mean, then the sum of squared deviations: two passes, as psr).
// Sums run in a fixed order and nothing is atomic: an item's result depends
// on that item alone, bit for bit.  Against the chain (cuFFT) the FFTs round
// otherwise, so the response parts by float32 rounding and a first maximum
// of two values within that rounding may fall on the other one.

constexpr int kSCtasPerSm = 4;
constexpr int kSN = kGS * kGS;         // 4096 response points
constexpr int kSPerThread = kSN / kGThreads;  // 16
constexpr int kSExclude = 5;           // psr's exclusion window

// torch.argmax's order (GreaterOrNan): whether (a, ia) comes first.
__device__ __forceinline__ bool first_max_before(float a, int ia, float b,
                                                 int ib) {
  if (isnan(a)) return isnan(b) ? ia < ib : true;
  return a == b ? ia < ib : a > b;
}

// Response point f (flat index) from the scratch of the row pair's group:
// row 2p in xre, row 2p + 1 in xim.
__device__ __forceinline__ float response_at(const float* xre,
                                             const float* xim, int f) {
  const int y = f >> 6;
  return ((y & 1) ? xim : xre)[(y >> 1) * kGX + (f & 63)];
}

// Fixed-order block sum of one float per thread into red[0..kGWarps); the
// total is returned to every thread.
__device__ __forceinline__ float search_block_sum(float s, float* red,
                                                  int lane, int warp) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int w = 0; w < kGWarps; ++w) t += red[w];
  return t;
}

// peak_displacement's sub-pixel offset along one axis.
__device__ __forceinline__ float subpixel(int p, float peak, float left,
                                          float right) {
  const float den = __fsub_rn(__fsub_rn(__fmul_rn(2.0f, peak), left), right);
  float d = fabsf(den) > 1e-8f
                ? __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(right, left)),
                            fmaxf(den, 1e-8f))
                : 0.0f;
  d = d < -0.5f ? -0.5f : (d > 0.5f ? 0.5f : d);  // NaN stays NaN
  return (p > 0 && p < kGS - 1) ? d : 0.0f;
}

// A group's half spectrum row pair (rows r1, r1 + 1 of the planes) as one
// complex 64-point input: Q1 + i Q2 for kx <= 31, conj Q1 + i conj Q2 at
// 64 - kx above.
__device__ __forceinline__ void load_row_pair(const float* wre,
                                              const float* wim, int r1,
                                              int j, float2 (&v)[8]) {
  const float* a1r = wre + r1 * kGW;
  const float* a1i = wim + r1 * kGW;
  const float* a2r = a1r + kGW;
  const float* a2i = a1i + kGW;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (n < 4) {
      const int c = j + 8 * n;
      v[n] = make_float2(a1r[c] - a2i[c], a1i[c] + a2r[c]);
    } else {
      const int c = kGS - j - 8 * n;
      v[n] = make_float2(a1r[c] + a2i[c], a2r[c] - a1i[c]);
    }
  }
}

// The transform of two real rows (v = a + i b, forward, natural lanes)
// split into their half spectra, written to rows r1 and r1 + 1.
__device__ __forceinline__ void store_row_pair(float* wre, float* wim,
                                               int r1, int j, int lane,
                                               const float2 (&v)[8]) {
  float2 m[8];
  mirrored(v, j, lane, m);
  float* b1r = wre + r1 * kGW;
  float* b1i = wim + r1 * kGW;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int c = j + 8 * k;
    if (k < 4 || j == 0) {
      b1r[c] = 0.5f * (v[k].x + m[k].x);
      b1i[c] = 0.5f * (v[k].y - m[k].y);
      b1r[c + kGW] = 0.5f * (v[k].y + m[k].y);
      b1i[c + kGW] = 0.5f * (m[k].x - v[k].x);
    }
  }
}

// Group g's column of the planes (group 0: the real columns 0 and 32 as
// one complex input), lane j taking rows 8 n + j.
__device__ __forceinline__ void load_column(const float* wre,
                                            const float* wim, int g, int j,
                                            float2 (&v)[8]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int at = (8 * n + j) * kGW;
    v[n] = make_float2(wre[at + g], g == 0 ? wre[at + 32] : wim[at + g]);
  }
}

// The inverse column transform's outputs (lane j: rows j + 8 k) back to the
// planes; group 0's real and imaginary parts are columns 0 and 32, whose
// own imaginary parts are dropped.
__device__ __forceinline__ void store_column(float* wre, float* wim, int g,
                                             int j, const float2 (&v)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int at = (j + 8 * k) * kGW;
    if (g == 0) {
      wre[at] = v[k].x;
      wim[at] = 0.0f;
      wre[at + 32] = v[k].y;
      wim[at + 32] = 0.0f;
    } else {
      wre[at + g] = v[k].x;
      wim[at + g] = v[k].y;
    }
  }
}

// Group 0's real columns 0 and 32 between a forward and an inverse column
// transform, through the planes' spare columns 33-35, which no other group
// touches (the row passes read columns 0-32).  On entry v holds Z = A + i B,
// the forward transform of the two columns (lane j: rows ky = j + 8 k);
// mul(k, ky, A, B, pa, pb) gives the two products at ky.  On return v holds
// h_a + i h_b, the Hermitian parts (c(ky) + conj c(-ky)) / 2 of both
// products, whose one inverse has the real parts of the two columns' own
// inverses as its real and imaginary parts: C2R semantics, which drop the
// imaginary parts of DC and Nyquist after the column transform.  (A bank
// trained on a fractionally shifted spectrum, K6's in stage 8, is not
// Hermitian in these columns.)  Group 0 alone calls it: lanes 0-7 of warp 0.
template <class Mul>
__device__ __forceinline__ void dc_nyquist_columns(float2 (&v)[8], int j,
                                                   float* wre, float* wim,
                                                   Mul mul) {
  constexpr unsigned kGroup0 = 0xffu;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int at = (j + 8 * k) * kGW + 33;
    wre[at] = v[k].x;
    wim[at] = v[k].y;
  }
  __syncwarp(kGroup0);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int ky = j + 8 * k;
    const int neg = ((kGS - ky) & (kGS - 1)) * kGW + 33;
    const float mx = wre[neg], my = wim[neg];
    float2 pa, pb;
    mul(k, ky, make_float2(0.5f * (v[k].x + mx), 0.5f * (v[k].y - my)),
        make_float2(0.5f * (v[k].y + my), 0.5f * (mx - v[k].x)), pa, pb);
    wre[ky * kGW + 34] = pa.x;
    wim[ky * kGW + 34] = pa.y;
    wre[ky * kGW + 35] = pb.x;
    wim[ky * kGW + 35] = pb.y;
  }
  __syncwarp(kGroup0);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int at = (j + 8 * k) * kGW;
    const int neg = ((kGS - j - 8 * k) & (kGS - 1)) * kGW;
    const float ax = 0.5f * (wre[at + 34] + wre[neg + 34]);
    const float ay = 0.5f * (wim[at + 34] - wim[neg + 34]);
    const float bx = 0.5f * (wre[at + 35] + wre[neg + 35]);
    const float by = 0.5f * (wim[at + 35] - wim[neg + 35]);
    v[k] = make_float2(ax - by, ay + bx);
  }
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

// K8: grid = N items; item i against model row i % R.
__global__ void __launch_bounds__(kGThreads, kSCtasPerSm)
kcf_search_kernel(const float* __restrict__ feat,
                  const float2* __restrict__ xf,
                  const float2* __restrict__ alphaf,
                  const float2* __restrict__ twg,
                  float2* __restrict__ out_zf, float* __restrict__ out_resp,
                  float* __restrict__ out_stats,
                  long long* __restrict__ out_idx, int N, int R,
                  float denom) {
  __shared__ float wre[kGS * kGW];   // [ky or y][kx] planes
  __shared__ float wim[kGS * kGW];
  __shared__ float xre[32 * kGX];    // a group's transpose scratch; at the
  __shared__ float xim[32 * kGX];    // end its rows of the response
  __shared__ float2 tw[kGS];
  __shared__ float red[4 * kGWarps];
  __shared__ int red_i[kGWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int j = tid & 7;
  const int grp = tid >> 3;
  float* sr = xre + grp * kGX;
  float* si = xim + grp * kGX;
  const size_t item = blockIdx.x;
  const size_t mrow = item % (size_t)R;
  const float2* xm = xf + mrow * (kGS * kGSf);
  const float2* am = alphaf + mrow * (kGS * kGSf);

  // 0. x^ is read in pass 2, alpha^ in pass 4: their 2 x 132 lines into L2.
  for (int q = tid; q < 2 * (kGN4 / 8); q += kGThreads) {
    const float2* p = q < kGN4 / 8 ? xm + 16 * q : am + 16 * (q - kGN4 / 8);
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
  }
  if (tid < kGS) tw[tid] = twg[tid];

  // 1. Forward rows 2 p, 2 p + 1 (p = grp) as one complex transform.
  float2 v[8];
  float ez = 0.0f;
  {
    const float* fr = feat + item * kSN + (2 * grp) * kGS;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float a = __ldcs(fr + 8 * n + j);
      const float b = __ldcs(fr + kGS + 8 * n + j);
      v[n] = make_float2(a, b);
      ez += a * a + b * b;
    }
  }
  __syncthreads();  // the twiddles
  fft64<false>(v, j, sr, si, tw);
  store_row_pair(wre, wim, 2 * grp, j, lane, v);
  __syncthreads();

  // 2. Columns: forward -> z^ (stored) -> z^ conj(x^) -> inverse.
  float ex = 0.0f;
  {
    const int g = grp;
    float2 xv[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) xv[k] = __ldg(xm + (j + 8 * k) * kGSf + g);
    load_column(wre, wim, g, j, v);
    fft64<false>(v, j, sr, si, tw);
    float2* zo = out_zf + item * (kGS * kGSf);
    if (g == 0) {
      dc_nyquist_columns(v, j, wre, wim,
                         [&](int k, int ky, float2 z0, float2 z32,
                             float2& c0, float2& c32) {
                           const float2 x32 = __ldg(xm + ky * kGSf + 32);
                           zo[ky * kGSf] = z0;
                           zo[ky * kGSf + 32] = z32;
                           ex += (xv[k].x * xv[k].x + xv[k].y * xv[k].y) +
                                 (x32.x * x32.x + x32.y * x32.y);
                           c0 = cmul_conj(z0, xv[k]);
                           c32 = cmul_conj(z32, x32);
                         });
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        zo[(j + 8 * k) * kGSf + g] = v[k];
        ex += 2.0f * (xv[k].x * xv[k].x + xv[k].y * xv[k].y);
        v[k] = cmul_conj(v[k], xv[k]);
      }
    }
    fft64<true>(v, j, sr, si, tw);
    store_column(wre, wim, g, j, v);
  }
  // Both energies, in a fixed order (the barrier publishes pass 2 too).
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    ez += __shfl_xor_sync(0xffffffffu, ez, o);
    ex += __shfl_xor_sync(0xffffffffu, ex, o);
  }
  if (lane == 0) {
    red[warp] = ez;
    red[kGWarps + warp] = ex;
  }
  __syncthreads();
  float zz = 0.0f, xx = 0.0f;
#pragma unroll
  for (int w = 0; w < kGWarps; ++w) {
    zz += red[w];
    xx += red[kGWarps + w];
  }
  const float energies = zz + xx * (1.0f / (float)kSN);
  const float inv_n = 1.0f / (float)kSN;

  // 3. Rows: inverse -> the Gaussian kernel -> forward.
  load_row_pair(wre, wim, 2 * grp, j, v);
  fft64<true>(v, j, sr, si, tw);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    v[k] = make_float2(
        expf(-fmaxf(energies - 2.0f * (v[k].x * inv_n), 0.0f) / denom),
        expf(-fmaxf(energies - 2.0f * (v[k].y * inv_n), 0.0f) / denom));
  }
  fft64<false>(v, j, sr, si, tw);
  store_row_pair(wre, wim, 2 * grp, j, lane, v);
  __syncthreads();

  // 4. Columns: forward -> k^ alpha^ -> inverse.
  {
    const int g = grp;
    float2 av[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) av[k] = __ldg(am + (j + 8 * k) * kGSf + g);
    load_column(wre, wim, g, j, v);
    fft64<false>(v, j, sr, si, tw);
    if (g == 0) {
      dc_nyquist_columns(v, j, wre, wim,
                         [&](int k, int ky, float2 k0, float2 k32,
                             float2& r0, float2& r32) {
                           r0 = cmul(k0, av[k]);
                           r32 = cmul(k32, __ldg(am + ky * kGSf + 32));
                         });
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = cmul(v[k], av[k]);
    }
    fft64<true>(v, j, sr, si, tw);
    store_column(wre, wim, g, j, v);
  }
  __syncthreads();

  // 5. Rows: inverse -> the response, out and into the group's scratch.
  load_row_pair(wre, wim, 2 * grp, j, v);
  fft64<true>(v, j, sr, si, tw);
  {
    float* ro = out_resp + item * kSN + (2 * grp) * kGS;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      v[k] = make_float2(v[k].x * inv_n, v[k].y * inv_n);
      __stcs(ro + j + 8 * k, v[k].x);
      __stcs(ro + kGS + j + 8 * k, v[k].y);
    }
    __syncwarp();  // the transform's last scratch reads are done
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      sr[j + 8 * k] = v[k].x;
      si[j + 8 * k] = v[k].y;
    }
  }
  __syncthreads();

  // 6. First maximum, sub-pixel fit, PSR.
  float best = response_at(xre, xim, tid);
  int bi = tid;
#pragma unroll
  for (int i = 1; i < kSPerThread; ++i) {
    const int f = tid + i * kGThreads;
    const float r = response_at(xre, xim, f);
    if (first_max_before(r, f, best, bi)) {
      best = r;
      bi = f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (first_max_before(ov, oi, best, bi)) {
      best = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    red[2 * kGWarps + warp] = best;
    red_i[warp] = bi;
  }
  __syncthreads();
  best = red[2 * kGWarps];
  bi = red_i[0];
#pragma unroll
  for (int w = 1; w < kGWarps; ++w) {
    if (first_max_before(red[2 * kGWarps + w], red_i[w], best, bi)) {
      best = red[2 * kGWarps + w];
      bi = red_i[w];
    }
  }
  const int py = bi >> 6;
  const int px = bi & 63;
  const int wy = min(py + kSExclude, kGS - 1) - max(py - kSExclude, 0) + 1;
  const int wx = min(px + kSExclude, kGS - 1) - max(px - kSExclude, 0) + 1;
  const float count = fmaxf((float)(kSN - wy * wx), 1.0f);
  float s1 = 0.0f;
#pragma unroll
  for (int i = 0; i < kSPerThread; ++i) {
    const int f = tid + i * kGThreads;
    if (abs((f >> 6) - py) > kSExclude || abs((f & 63) - px) > kSExclude) {
      s1 += response_at(xre, xim, f);
    }
  }
  const float mean =
      search_block_sum(s1, red + 3 * kGWarps, lane, warp) / count;
  float s2 = 0.0f;
#pragma unroll
  for (int i = 0; i < kSPerThread; ++i) {
    const int f = tid + i * kGThreads;
    if (abs((f >> 6) - py) > kSExclude || abs((f & 63) - px) > kSExclude) {
      const float d = response_at(xre, xim, f) - mean;
      s2 += d * d;
    }
  }
  const float var = search_block_sum(s2, red, lane, warp) / count;
  if (tid == 0) {
    const float ly = response_at(xre, xim, max(py - 1, 0) * kGS + px);
    const float ry = response_at(xre, xim, min(py + 1, kGS - 1) * kGS + px);
    const float lx = response_at(xre, xim, py * kGS + max(px - 1, 0));
    const float rx = response_at(xre, xim, py * kGS + min(px + 1, kGS - 1));
    const float half = (float)(kGS / 2);
    out_stats[item] =
        __fsub_rn(__fadd_rn((float)py, subpixel(py, best, ly, ry)), half);
    out_stats[N + item] =
        __fsub_rn(__fadd_rn((float)px, subpixel(px, best, lx, rx)), half);
    out_stats[2 * (size_t)N + item] = best;
    out_stats[3 * (size_t)N + item] =
        __fdiv_rn(__fsub_rn(best, mean), sqrtf(__fadd_rn(var, 1e-8f)));
    out_idx[item] = bi;
  }
}

// Opt `kernel` in to `bytes` of dynamic shared memory (above 48 KB this
// must be asked for).  The attribute is a ceiling: `prepared` holds, per
// device, what was last asked for, and it is raised only when a larger
// size arrives, so a steady caller pays for it once.
constexpr int kMaxDevices = 64;
size_t g_prepared_detect[kMaxDevices] = {};
size_t g_prepared_fft16[kMaxDevices] = {};
size_t g_prepared_train[kMaxDevices] = {};
size_t g_prepared_train16[kMaxDevices] = {};

int prepare(const void* kernel, size_t bytes,
            size_t (&prepared)[kMaxDevices]) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (bytes <= prepared[dev]) return 0;
  const int rc = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc == 0) prepared[dev] = bytes;
  return rc;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

bool fft16_shape(int C, int S) { return S == kFS && C >= 1 && C <= kFMaxC; }

}  // namespace

// Dynamic shared memory one CTA of K4 needs (either code path).
extern "C" int tpu_mot_kcf_detect_smem_bytes(int C, int S) {
  return (int)(fft16_shape(C, S) ? fft16_smem_bytes(C) : smem_bytes(C, S));
}

// Dynamic shared memory one CTA of K5 needs (either code path).
extern "C" int tpu_mot_kcf_train_smem_bytes(int C, int S) {
  return (int)(fft16_shape(C, S) ? train_fft16_smem_bytes(C)
                                 : smem_bytes(C, S));
}

// The device's per-block shared-memory limit (opt-in), or -1.
extern "C" int tpu_mot_kcf_smem_limit() {
  int dev = 0;
  int limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return -1;
  }
  return limit;
}

namespace {

// info[0] the code path (1 = FFTs in registers, 0 = direct DFTs), info[1]
// threads per CTA, info[2] registers per thread, info[3] dynamic shared
// memory per CTA, info[4] CTAs that fit on one SM at once.  The
// shared-memory attribute is raised through `prepare` only, never lowered.
int kernel_info(const void* kernel, bool fast, int threads, size_t bytes,
                size_t (&prepared)[kMaxDevices], int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  const int rc = prepare(kernel, bytes, prepared);
  if (rc != 0) return rc;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, threads,
                                                      bytes);
  info[0] = fast;
  info[1] = threads;
  info[2] = attr.numRegs;
  info[3] = (int)bytes;
  info[4] = ctas;
  return (int)err;
}

}  // namespace

// What K4 launches for C channels of S x S features at 16-byte aligned
// feature and response addresses (see kernel_info).  Returns a CUDA error
// code.
extern "C" int tpu_mot_kcf_detect_info(int C, int S, int* info) {
  const size_t bytes = tpu_mot_kcf_detect_smem_bytes(C, S);
  if (fft16_shape(C, S)) {
    return kernel_info((const void*)kcf_detect_fft16_kernel, true, kFThreads,
                       bytes, g_prepared_fft16, info);
  }
  return kernel_info((const void*)kcf_detect_kernel, false, kThreads, bytes,
                     g_prepared_detect, info);
}

// What K5 launches for C channels of S x S features at 16-byte aligned
// feature and model addresses (see kernel_info).  Returns a CUDA error code.
extern "C" int tpu_mot_kcf_train_info(int C, int S, int* info) {
  const size_t bytes = tpu_mot_kcf_train_smem_bytes(C, S);
  if (fft16_shape(C, S)) {
    return kernel_info((const void*)kcf_train_fft16_kernel, true, kFThreads,
                       bytes, g_prepared_train16, info);
  }
  return kernel_info((const void*)kcf_train_kernel, false, kThreads, bytes,
                     g_prepared_train, info);
}

// K4.  feat [N, C, S, S] float32; xf [T, C, S, Sf], alphaf [T, S, Sf]
// complex64 (interleaved); tw [S] complex64; out [N, S, S] float32; N a
// multiple of T; denom = sigma^2 S^2 C.  Returns cudaGetLastError().
extern "C" int tpu_mot_kcf_detect(const void* feat, const void* xf,
                                  const void* alphaf, const void* tw,
                                  void* out, int N, int T, int C, int S,
                                  float denom, void* stream) {
  if (fft16_shape(C, S) && aligned16(feat) && aligned16(out)) {
    const size_t bytes = fft16_smem_bytes(C);
    const int rc = prepare((const void*)kcf_detect_fft16_kernel, bytes,
                           g_prepared_fft16);
    if (rc != 0) return rc;
    kcf_detect_fft16_kernel<<<N, kFThreads, bytes,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(feat), static_cast<const float2*>(xf),
        static_cast<const float2*>(alphaf), static_cast<float*>(out), T, C,
        denom);
    return (int)cudaGetLastError();
  }
  const size_t bytes = smem_bytes(C, S);
  const int rc =
      prepare((const void*)kcf_detect_kernel, bytes, g_prepared_detect);
  if (rc != 0) return rc;
  kcf_detect_kernel<<<N, kThreads, bytes, static_cast<cudaStream_t>(
                                              stream)>>>(
      static_cast<const float*>(feat), static_cast<const float2*>(xf),
      static_cast<const float2*>(alphaf), static_cast<const float2*>(tw),
      static_cast<float*>(out), T, C, S, denom);
  return (int)cudaGetLastError();
}

// K5.  feat [T, C, S, S] float32; xf, alphaf the old model (complex64);
// yf [S, Sf] complex64; lr [T] float32; tw [S]; out_xf, out_alphaf the new
// model, not the old one's memory.  Returns cudaGetLastError().
extern "C" int tpu_mot_kcf_train(const void* feat, const void* xf,
                                 const void* alphaf, const void* yf,
                                 const void* lr, const void* tw, void* out_xf,
                                 void* out_alphaf, int T, int C, int S,
                                 float denom, float lambda, void* stream) {
  if (fft16_shape(C, S) && aligned16(feat) && aligned16(xf) &&
      aligned16(out_xf)) {
    const size_t bytes = train_fft16_smem_bytes(C);
    const int rc = prepare((const void*)kcf_train_fft16_kernel, bytes,
                           g_prepared_train16);
    if (rc != 0) return rc;
    kcf_train_fft16_kernel<<<T, kFThreads, bytes,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(feat), static_cast<const float2*>(xf),
        static_cast<const float2*>(alphaf), static_cast<const float2*>(yf),
        static_cast<const float*>(lr), static_cast<float2*>(out_xf),
        static_cast<float2*>(out_alphaf), C, denom, lambda);
    return (int)cudaGetLastError();
  }
  const size_t bytes = smem_bytes(C, S);
  const int rc =
      prepare((const void*)kcf_train_kernel, bytes, g_prepared_train);
  if (rc != 0) return rc;
  kcf_train_kernel<<<T, kThreads, bytes, static_cast<cudaStream_t>(
                                             stream)>>>(
      static_cast<const float*>(feat), static_cast<const float2*>(xf),
      static_cast<const float2*>(alphaf), static_cast<const float2*>(yf),
      static_cast<const float*>(lr), static_cast<const float2*>(tw),
      static_cast<float2*>(out_xf), static_cast<float2*>(out_alphaf), C, S,
      denom, lambda);
  return (int)cudaGetLastError();
}

// What K6 launches: info[0] its code path (0: it has one), info[1] threads
// per CTA, info[2] registers per thread, info[3] static shared memory per
// CTA, info[4] CTAs resident per SM.  Returns a CUDA error code.
extern "C" int tpu_mot_kcf_train_shift_info(int* info) {
  cudaFuncAttributes attr;
  cudaError_t err =
      cudaFuncGetAttributes(&attr, (const void*)kcf_train_shift_kernel);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, (const void*)kcf_train_shift_kernel, kGThreads, 0);
  info[0] = 0;
  info[1] = kGThreads;
  info[2] = attr.numRegs;
  info[3] = (int)attr.sharedSizeBytes;
  info[4] = ctas;
  return (int)err;
}

// K6.  zf, xf [R, 1, 64, 33], alphaf [R, 64, 33], yf [64, 33] complex64
// (interleaved), each 16-byte aligned; dy, dx, lr [R] float32; tw [64]
// complex64 e^{-2 pi i j / 64}; out_xf, out_alphaf the new model, not the
// old one's memory; denom = sigma^2 4096.  Returns cudaGetLastError().
extern "C" int tpu_mot_kcf_train_shift(const void* zf, const void* xf,
                                       const void* alphaf, const void* yf,
                                       const void* dy, const void* dx,
                                       const void* lr, const void* tw,
                                       void* out_xf, void* out_alphaf, int R,
                                       float denom, float lambda,
                                       void* stream) {
  kcf_train_shift_kernel<<<R, kGThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(zf), static_cast<const float4*>(xf),
      static_cast<const float4*>(alphaf), static_cast<const float4*>(yf),
      static_cast<const float*>(dy), static_cast<const float*>(dx),
      static_cast<const float*>(lr), static_cast<const float2*>(tw),
      static_cast<float4*>(out_xf), static_cast<float4*>(out_alphaf), denom,
      lambda);
  return (int)cudaGetLastError();
}

// What K8 launches, as tpu_mot_kcf_train_shift_info.  Returns a CUDA error
// code.
extern "C" int tpu_mot_kcf_search_info(int* info) {
  cudaFuncAttributes attr;
  cudaError_t err =
      cudaFuncGetAttributes(&attr, (const void*)kcf_search_kernel);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, (const void*)kcf_search_kernel, kGThreads, 0);
  info[0] = 0;
  info[1] = kGThreads;
  info[2] = attr.numRegs;
  info[3] = (int)attr.sharedSizeBytes;
  info[4] = ctas;
  return (int)err;
}

// K8.  feat [N, 1, 64, 64] float32; xf [R, 1, 64, 33], alphaf [R, 64, 33]
// complex64 (interleaved); tw [64] complex64 e^{-2 pi i j / 64}; out_zf
// [N, 1, 64, 33] complex64; out_resp [N, 64, 64] float32; out_stats [4, N]
// float32 (dy, dx, peak, psr); out_idx [N] int64; N a multiple of R; denom
// = sigma^2 4096.  Returns cudaGetLastError().
extern "C" int tpu_mot_kcf_search(const void* feat, const void* xf,
                                  const void* alphaf, const void* tw,
                                  void* out_zf, void* out_resp,
                                  void* out_stats, void* out_idx, int N,
                                  int R, float denom, void* stream) {
  kcf_search_kernel<<<N, kGThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(feat), static_cast<const float2*>(xf),
      static_cast<const float2*>(alphaf), static_cast<const float2*>(tw),
      static_cast<float2*>(out_zf), static_cast<float*>(out_resp),
      static_cast<float*>(out_stats), static_cast<long long*>(out_idx), N, R,
      denom);
  return (int)cudaGetLastError();
}
