// Jacobi gap-bidding auction: the whole solve in one CTA.
//
// Replaces the TPU kernel tpu_mot/kernels/auction.py:auction_solve_pallas
// (body _auction_kernel), which keeps the benefit matrix in VMEM and runs
// the auction's while_loop inside the kernel.
//
// What bounds it on the H100: neither bandwidth nor arithmetic.  By the
// byte rule the bound is the 100 KB matrix over the card's memory rate
// (0.00003 ms at n = 160), but the solve is one chain of dependent rounds
// in one CTA, so what one CTA cannot beat is a launch, the matrix staged
// through a single SM, and two barriers plus one pass over the bidding
// rows per round.  A multi-CTA or host-driven loop would pay a grid-wide
// sync or a launch per round instead.
//
// Serving solves a batch of S problems [S, n, n] in one launch, one CTA per
// problem (each reads its own matrix and writes its own col_of and iters):
// S problems fill S SMs at the latency of one, and each is bit-equal to the
// single solve.
//
// Design: one CTA of 1024 threads.  The matrix comes into dynamic shared
// memory (above the 48 KB default, hence the opt-in attribute) by one bulk
// asynchronous copy that completes on an mbarrier while the threads
// initialise the state arrays; a matrix whose rows are not multiples of 16
// bytes, or whose base is not 16-byte aligned, is staged by scalar loads
// into rows padded to a multiple of four columns.  A round is two phases
// and two barriers:
//   1. rows: eight lanes per bidding row read it once as float4 and keep
//      (m1, first-maximum column c*, m2) together; three shuffle steps
//      merge the triples (larger m1 wins, the lower column on ties, and
//      m2 = max(winner's m2, loser's m1): max is exact, so m2 is bit-equal
//      to a second pass that skips c*, a second column equal to m1 giving
//      m2 = m1).  The row then SCATTERS its bid
//      (p[c*] + (m1 - m2)) + eps to its column with one shared-memory
//      atomicMax on a 64-bit key: the bid's float bits mapped to an
//      order-preserving unsigned integer in the high word, 0xFFFFFFFF - row
//      in the low word.  The largest key is the highest bid and, among
//      equal bids, the lowest row: the plain version's first-maximum row.
//      Bids are finite and positive: prices start at 0 and only rise (a
//      new price is a bid on that column, p[c*] + gap + eps with gap =
//      m1 - m2 >= 0), so for finite benefits every bid is >= eps, the
//      mapping keeps float order exactly, and no real bid can look like
//      the plain version's "no bid" marker (-1e30).
//   2. columns: a thread per column with a key gives the column to the
//      winner w (col_of[w] = j), evicts the old owner (col_of[old] = -1),
//      sets owner and price and clears the key.  Winners were unassigned
//      and old owners were assigned when the round began; a row bids on
//      one column and owns at most one; so no two threads write the same
//      entry of col_of and the eviction and the win need no barrier
//      between them.  The phase's closing barrier counts the columns that
//      had no owner (__syncthreads_count): each takes one row off the
//      unassigned count that every thread keeps, which is the exit test.
// The arithmetic is adds, subtracts and max only, done with the _rn
// intrinsics so nothing is contracted or reordered: col_of and iters are
// bit-identical to the plain version (auction_solve_ref) and to the TPU
// kernel, not merely of equal cost.
//
// Two places for the matrix.  Up to shared_max_n() (237) columns it is
// staged into shared memory as above.  From 238 up to 1024 columns (the
// thread-per-column limit, kThreads) the matrix does not fit in the 227 KB
// a CTA may hold (a [256, 256] float32 matrix is 256 KB), so the bidding
// rows are read from global memory instead, where they stay resident in
// the 50 MB L2 ([1024, 1024] is 4 MB): eight lanes a row read it as
// float4 where rows are multiples of 16 bytes at an aligned base, by
// scalar loads otherwise.  Prices, keys, col_of, row_of stay in shared
// memory (under 21 KB at n = 1024).  The round, the arithmetic and the
// tie-breaks are the same code, so both places give the same col_of and
// iters.  The TPU kernel has no such split: VMEM holds b at any n the
// tracker builds (a 1024 x 1024 matrix is 4 MB there).
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNeg = -1.0e30f;
constexpr int kThreads = 1024;  // the largest n: a thread per column
constexpr int kGroup = 8;       // lanes per bidding row
constexpr size_t kMaxSmem = 232448;  // 227 KB opt-in limit of sm_90

// Row stride in shared memory: a multiple of four floats (float4 reads).
__host__ __device__ inline int row_stride(int n) { return (n + 3) & ~3; }

// Dynamic shared memory of a solve of n columns, with the matrix in shared
// memory (shared) or read from global memory.
__host__ __device__ inline size_t smem_bytes(int n, bool shared) {
  // b [n * ld] (shared only) + prices [ld] floats, keys [n] + the
  // mbarrier (8 bytes each), col_of, row_of [n] ints.
  const size_t ld = row_stride(n);
  return ((shared ? n * ld : 0) + ld) * 4 + (size_t)(n + 1) * 8 +
         (size_t)2 * n * 4;
}

// Float bits -> unsigned with the same order (any non-NaN values), > 0.
__device__ inline uint32_t ordered_bits(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ inline float from_ordered_bits(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One step of a lane's ascending scan over its columns.
__device__ inline void scan_step(float v, int j, float& m1, int& c,
                                 float& m2) {
  if (v > m1) {  // strict: keeps the first maximum
    m2 = fmaxf(m2, m1);
    m1 = v;
    c = j;
  } else {
    m2 = fmaxf(m2, v);
  }
}

// kShared: the matrix in shared memory (n <= shared_max_n()), else read
// from global memory.  aligned: the rows are multiples of 16 bytes at a
// 16-byte aligned base (n % 4 == 0), so the shared path stages the matrix
// by one bulk asynchronous copy and the global path reads it as float4.
template <bool kShared>
__global__ void __launch_bounds__(kThreads, 1)
auction_kernel(const float* __restrict__ b_batch, int* __restrict__ col_batch,
               int* __restrict__ iters_batch, int n, float eps,
               int max_iters, int aligned) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // This CTA's problem.
  const float* __restrict__ b_g = b_batch + (size_t)blockIdx.x * n * n;
  int* __restrict__ col_out = col_batch + (size_t)blockIdx.x * n;
  int* __restrict__ iters_out = iters_batch + blockIdx.x;
  const int ld = row_stride(n);
  float* b = reinterpret_cast<float*>(smem_raw);
  float* prices = b + (kShared ? (size_t)n * ld : 0);
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(prices + ld);
  unsigned long long* mbar = keys + n;
  int* col_of = reinterpret_cast<int*>(mbar + 1);
  int* row_of = col_of + n;

  const int tid = threadIdx.x;
  const int sub = tid & (kGroup - 1);
  const int group = tid / kGroup;
  constexpr int kGroups = kThreads / kGroup;

  // Staging (the global path has none).  aligned: ld == n and b_g is
  // 16-byte aligned, so the matrix is one contiguous copy of n * n * 4
  // bytes (a multiple of 16).
  const bool bulk = kShared && aligned;
  if (bulk) {
    if (tid == 0) {
      const uint32_t bar = smem_addr(mbar);
      const uint32_t bytes = (uint32_t)n * n * 4;
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(bar), "r"(bytes)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];" ::"r"(smem_addr(b)),
          "l"(b_g), "r"(bytes), "r"(bar)
          : "memory");
    }
  } else if (kShared) {
    for (int i = tid; i < n * ld; i += kThreads) {
      const int r = i / ld;
      const int j = i - r * ld;
      b[i] = j < n ? b_g[r * n + j] : -INFINITY;  // pad: never a maximum
    }
  }
  for (int i = tid; i < ld; i += kThreads) prices[i] = 0.0f;
  for (int i = tid; i < n; i += kThreads) {
    keys[i] = 0ull;  // 0 = no bid: every real key has a nonzero high word
    col_of[i] = -1;
    row_of[i] = -1;
  }
  __syncthreads();  // the state, and the mbarrier's initialisation
  if (bulk) {
    const uint32_t bar = smem_addr(mbar);
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          "selp.u32 %0, 1, 0, p;\n"
          "}"
          : "=r"(done)
          : "r"(bar)
          : "memory");
    }
  }

  const float4* b4 = reinterpret_cast<const float4*>(b);
  const float4* p4 = reinterpret_cast<const float4*>(prices);
  const int ld4 = ld >> 2;
  int unassigned = n;  // the same in every thread
  int it = 0;
  while (unassigned > 0 && it < max_iters) {
    // 1. Row phase: eight lanes per row, one pass, bids scattered.
    for (int base = 0; base < n; base += kGroups) {  // warp-uniform bound
      const int r = base + group;
      const bool bidding = r < n && col_of[r] < 0;
      if (!__any_sync(0xffffffffu, bidding)) continue;
      float m1 = -INFINITY;
      float m2 = kNeg;
      int c = n;
      if (bidding && (kShared || aligned)) {
        const float4* br =
            kShared ? b4 + (size_t)r * ld4
                    : reinterpret_cast<const float4*>(b_g + (size_t)r * n);
        for (int q = sub; q < ld4; q += kGroup) {  // ascending columns
          const float4 bv = kShared ? br[q] : __ldg(br + q);
          const float4 pv = p4[q];
          const int j = q << 2;
          scan_step(__fsub_rn(bv.x, pv.x), j, m1, c, m2);
          scan_step(__fsub_rn(bv.y, pv.y), j + 1, m1, c, m2);
          scan_step(__fsub_rn(bv.z, pv.z), j + 2, m1, c, m2);
          scan_step(__fsub_rn(bv.w, pv.w), j + 3, m1, c, m2);
        }
      } else if (bidding) {
        // global memory, rows not 16-byte multiples: the same quads by
        // scalar loads, the columns past n read as -inf (never a maximum),
        // as the shared path's padding does.
        const float* br = b_g + (size_t)r * n;
        for (int q = sub; q < ld4; q += kGroup) {  // ascending columns
          const float4 pv = p4[q];
          const int j = q << 2;  // < n
          const float b1 = j + 1 < n ? __ldg(br + j + 1) : -INFINITY;
          const float b2 = j + 2 < n ? __ldg(br + j + 2) : -INFINITY;
          const float b3 = j + 3 < n ? __ldg(br + j + 3) : -INFINITY;
          scan_step(__fsub_rn(__ldg(br + j), pv.x), j, m1, c, m2);
          scan_step(__fsub_rn(b1, pv.y), j + 1, m1, c, m2);
          scan_step(__fsub_rn(b2, pv.z), j + 2, m1, c, m2);
          scan_step(__fsub_rn(b3, pv.w), j + 3, m1, c, m2);
        }
      }
      for (int off = kGroup / 2; off > 0; off >>= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m1, off);
        const int co = __shfl_xor_sync(0xffffffffu, c, off);
        const float m2o = __shfl_xor_sync(0xffffffffu, m2, off);
        const bool take = mo > m1 || (mo == m1 && co < c);
        m2 = fmaxf(take ? m2o : m2, take ? m1 : mo);
        m1 = take ? mo : m1;
        c = take ? co : c;
      }
      if (bidding && sub == 0) {
        if (m2 <= kNeg * 0.5f) m2 = m1;  // single-column case
        const float bid =
            __fadd_rn(__fadd_rn(prices[c], __fsub_rn(m1, m2)), eps);
        const unsigned long long key =
            ((unsigned long long)ordered_bits(bid) << 32) |
            (0xFFFFFFFFu - (uint32_t)r);
        atomicMax(&keys[c], key);
      }
    }
    __syncthreads();

    // 2. Column phase: win, eviction, owner and price in one step.
    int gained = 0;
    if (tid < n) {
      const unsigned long long key = keys[tid];
      if (key != 0ull) {
        const int w = (int)(0xFFFFFFFFu - (uint32_t)key);
        const int old = row_of[tid];
        col_of[w] = tid;
        if (old >= 0) col_of[old] = -1;
        row_of[tid] = w;
        prices[tid] = from_ordered_bits((uint32_t)(key >> 32));
        keys[tid] = 0ull;
        gained = old < 0;
      }
    }
    unassigned -= __syncthreads_count(gained);
    ++it;
  }

  for (int r = tid; r < n; r += kThreads) col_out[r] = col_of[r];
  if (tid == 0) *iters_out = it;
}

// Whether the matrix of n columns and the solve's state fit in one CTA's
// shared memory (else the rows are read from global memory).
bool shared_path(int n) { return smem_bytes(n, true) <= kMaxSmem; }

// Whether rows of n columns at a 16-byte aligned address are staged by the
// bulk asynchronous copy (shared) or read as float4 (global); else by
// scalar loads.
bool aligned_rows(int n) { return n % 4 == 0; }

// Opt a kernel in to the shared memory of n columns.  The attribute is a
// ceiling: it is raised when a larger n arrives, per kernel and device,
// and otherwise left alone, so a steady caller pays for it once.
template <bool kShared>
int prepare(size_t smem) {
  static size_t prepared[64] = {};
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (smem <= prepared[dev]) return 0;
  const int rc = (int)cudaFuncSetAttribute(
      auction_kernel<kShared>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc == 0) prepared[dev] = smem;
  return rc;
}

template <bool kShared>
int info_of(int n, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, auction_kernel<kShared>);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(n, kShared);
  const int rc = prepare<kShared>(smem);
  if (rc != 0) return rc;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, auction_kernel<kShared>, kThreads, smem);
  info[0] = (kShared ? 0 : 2) + aligned_rows(n);  // path
  info[1] = kThreads;
  info[2] = attr.numRegs;
  info[3] = (int)smem;
  info[4] = ctas;
  return (int)err;
}

template <bool kShared>
int launch(const void* b, void* col_out, void* iters_out, int n, int batch,
           float eps, int max_iters, void* stream) {
  const size_t smem = smem_bytes(n, kShared);
  const int rc = prepare<kShared>(smem);
  if (rc != 0) return rc;
  // Both 16-byte paths need every problem's matrix aligned.  They take
  // n % 4 == 0, so a matrix is n * n * 4 bytes, a multiple of 64, and
  // every problem's base is aligned exactly when the first one's is; any
  // other n reads by scalar loads.
  const int aligned =
      aligned_rows(n) && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  auction_kernel<kShared><<<batch, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(b), static_cast<int*>(col_out),
      static_cast<int*>(iters_out), n, eps, max_iters, aligned);
  return (int)cudaGetLastError();
}

}  // namespace

// The largest n a solve takes: a thread per column.
extern "C" int tpu_mot_auction_max_n() { return kThreads; }

// The largest n whose matrix is staged into shared memory.
extern "C" int tpu_mot_auction_shared_max_n() {
  int n = 1;
  while (shared_path(n + 1)) ++n;
  return n;
}

// What a solve of n columns launches: info[0] the path (0 = shared memory
// staged by scalar loads, 1 = shared memory staged by the bulk
// asynchronous copy, 2 = global memory read by scalar loads, 3 = global
// memory read as float4; the aligned forms need a 16-byte aligned matrix),
// info[1] threads per CTA, info[2] registers per thread, info[3] dynamic
// shared memory, info[4] CTAs that fit on one SM at once (a solve
// launches one a problem).  Returns a CUDA error code.
extern "C" int tpu_mot_auction_info(int n, int* info) {
  if (n < 1 || n > kThreads) return (int)cudaErrorInvalidValue;
  return shared_path(n) ? info_of<true>(n, info) : info_of<false>(n, info);
}

// b: [batch, n, n] float32 benefits (device); col_out: [batch, n] int32;
// iters_out: [batch] int32.  One CTA per problem.  Launches on `stream`
// and returns cudaGetLastError().
extern "C" int tpu_mot_auction_solve(const void* b, void* col_out,
                                     void* iters_out, int n, int batch,
                                     float eps, int max_iters,
                                     void* stream) {
  if (batch < 1 || n < 1 || n > kThreads) return (int)cudaErrorInvalidValue;
  return shared_path(n)
             ? launch<true>(b, col_out, iters_out, n, batch, eps, max_iters,
                            stream)
             : launch<false>(b, col_out, iters_out, n, batch, eps,
                             max_iters, stream);
}
