// Fused KCF detect (K4) and train + blend (K5): the whole FFT-domain chain
// of one item in one CTA, with only the inputs read from and the results
// written to device memory.
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
// What bounds them on the H100: the bytes they move.  At the heavy bench
// shape (HF: 384 detect items and 128 tracks, C = 31, S = 16) K4 reads
// 12.2 MB of features and 4.6 MB of model and writes 0.4 MB of response,
// ~5 us at 3.35 TB/s; K5 reads 4.1 MB of features and reads and writes
// 4.6 MB of model, ~4 us.  The DFT work is ~0.1 GFLOP, far below the
// card's float32 rate.
//
// Design: one CTA of 256 threads per item, spectra in shared memory, native
// float2 complex math in float32.  The DFTs are direct row/column sums
// (S <= 64) over a twiddle table e^{-2 pi i j / S} that the wrapper builds
// once per S in float64 and rounds to float32, as the TPU kernel's constant
// operators are built.  Stage 1 takes the row DFT of every channel at once;
// stage 2 gives each thread one frequency (ky, kx) and loops over the
// channels, so the cross spectrum and the energies sum in registers in
// channel order with no atomics; the Gaussian kernel, its spectrum and the
// final inverse are four more S x Sf / S x S stages.  K4 reads model row
// `item % T` instead of a model tiled over the 3 scales: the same function
// with 2/3 less model traffic.  The chain is latency-bound per CTA (a
// dozen barriers, small stages); many CTAs per SM hide that.
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

// K5: grid = T tracks.
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

// Opt the kernels in to `bytes` of dynamic shared memory (above 48 KB this
// must be asked for), then check it is within the device's limit.
int prepare(const void* kernel, size_t bytes) {
  int dev = 0;
  int limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return (int)err;
  if (bytes > (size_t)limit) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// Dynamic shared memory one CTA needs for C channels of S x S features.
extern "C" int tpu_mot_kcf_smem_bytes(int C, int S) {
  return (int)smem_bytes(C, S);
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

// K4.  feat [N, C, S, S] float32; xf [T, C, S, Sf], alphaf [T, S, Sf]
// complex64 (interleaved); tw [S] complex64; out [N, S, S] float32; N a
// multiple of T; denom = sigma^2 S^2 C.  Returns cudaGetLastError().
extern "C" int tpu_mot_kcf_detect(const void* feat, const void* xf,
                                  const void* alphaf, const void* tw,
                                  void* out, int N, int T, int C, int S,
                                  float denom, void* stream) {
  const size_t bytes = smem_bytes(C, S);
  const int rc = prepare((const void*)kcf_detect_kernel, bytes);
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
// model.  Returns cudaGetLastError().
extern "C" int tpu_mot_kcf_train(const void* feat, const void* xf,
                                 const void* alphaf, const void* yf,
                                 const void* lr, const void* tw, void* out_xf,
                                 void* out_alphaf, int T, int C, int S,
                                 float denom, float lambda, void* stream) {
  const size_t bytes = smem_bytes(C, S);
  const int rc = prepare((const void*)kcf_train_kernel, bytes);
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
