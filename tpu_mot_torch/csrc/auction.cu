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
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNeg = -1.0e30f;
constexpr int kThreads = 1024;  // >= the largest n: a thread per column
constexpr int kGroup = 8;       // lanes per bidding row
constexpr size_t kMaxSmem = 232448;  // 227 KB opt-in limit of sm_90

// Row stride in shared memory: a multiple of four floats (float4 reads).
__host__ __device__ inline int row_stride(int n) { return (n + 3) & ~3; }

__host__ __device__ inline size_t smem_bytes(int n) {
  // b [n * ld] + prices [ld] floats, keys [n] + the mbarrier (8 bytes
  // each), col_of, row_of [n] ints.
  const size_t ld = row_stride(n);
  return (n * ld + ld) * 4 + (size_t)(n + 1) * 8 + (size_t)2 * n * 4;
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

__global__ void __launch_bounds__(kThreads, 1)
auction_kernel(const float* __restrict__ b_batch, int* __restrict__ col_batch,
               int* __restrict__ iters_batch, int n, float eps,
               int max_iters, int bulk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // This CTA's problem.
  const float* __restrict__ b_g = b_batch + (size_t)blockIdx.x * n * n;
  int* __restrict__ col_out = col_batch + (size_t)blockIdx.x * n;
  int* __restrict__ iters_out = iters_batch + blockIdx.x;
  const int ld = row_stride(n);
  float* b = reinterpret_cast<float*>(smem_raw);
  float* prices = b + (size_t)n * ld;
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(prices + ld);
  unsigned long long* mbar = keys + n;
  int* col_of = reinterpret_cast<int*>(mbar + 1);
  int* row_of = col_of + n;

  const int tid = threadIdx.x;
  const int sub = tid & (kGroup - 1);
  const int group = tid / kGroup;
  constexpr int kGroups = kThreads / kGroup;

  // Staging.  bulk: ld == n and b_g is 16-byte aligned, so the matrix is
  // one contiguous copy of n * n * 4 bytes (a multiple of 16).
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
  } else {
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
      if (bidding) {
        const float4* br = b4 + (size_t)r * ld4;
        for (int q = sub; q < ld4; q += kGroup) {  // ascending columns
          const float4 bv = br[q];
          const float4 pv = p4[q];
          const int j = q << 2;
          scan_step(__fsub_rn(bv.x, pv.x), j, m1, c, m2);
          scan_step(__fsub_rn(bv.y, pv.y), j + 1, m1, c, m2);
          scan_step(__fsub_rn(bv.z, pv.z), j + 2, m1, c, m2);
          scan_step(__fsub_rn(bv.w, pv.w), j + 3, m1, c, m2);
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

// Whether a matrix of n columns at a 16-byte aligned address is staged by
// the bulk asynchronous copy (else by scalar loads into padded rows).
bool bulk_path(int n) { return n % 4 == 0; }

// Opt the kernel in to the shared memory of n columns.  The attribute is
// a ceiling: it is raised when a larger n arrives, per device, and
// otherwise left alone, so a steady caller pays for it once.
int prepare(size_t smem) {
  static size_t prepared[64] = {};
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (smem <= prepared[dev]) return 0;
  const int rc = (int)cudaFuncSetAttribute(
      auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc == 0) prepared[dev] = smem;
  return rc;
}

}  // namespace

extern "C" int tpu_mot_auction_max_n() {
  int n = 1;
  while (smem_bytes(n + 1) <= kMaxSmem) ++n;
  return n;
}

// What a solve of n columns launches: info[0] the staging path (1 = bulk
// asynchronous copy, 0 = scalar loads), info[1] threads per CTA, info[2]
// registers per thread, info[3] dynamic shared memory, info[4] CTAs that
// fit on one SM at once (the solve launches one).  Returns a CUDA error
// code.
extern "C" int tpu_mot_auction_info(int n, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, auction_kernel);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(n);
  const int rc = prepare(smem);
  if (rc != 0) return rc;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, auction_kernel,
                                                      kThreads, smem);
  info[0] = bulk_path(n);
  info[1] = kThreads;
  info[2] = attr.numRegs;
  info[3] = (int)smem;
  info[4] = ctas;
  return (int)err;
}

// b: [batch, n, n] float32 benefits (device); col_out: [batch, n] int32;
// iters_out: [batch] int32.  One CTA per problem.  Launches on `stream`
// and returns cudaGetLastError().
extern "C" int tpu_mot_auction_solve(const void* b, void* col_out,
                                     void* iters_out, int n, int batch,
                                     float eps, int max_iters,
                                     void* stream) {
  if (batch < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(n);
  const int rc = prepare(smem);
  if (rc != 0) return rc;
  // The bulk copy needs every problem's matrix 16-byte aligned.  It takes
  // n % 4 == 0, so a matrix is n * n * 4 bytes, a multiple of 64, and every
  // problem's base is aligned exactly when the first one's is; any other n
  // stages by scalar loads.
  const int bulk = bulk_path(n) && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  auction_kernel<<<batch, kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(b), static_cast<int*>(col_out),
      static_cast<int*>(iters_out), n, eps, max_iters, bulk);
  return (int)cudaGetLastError();
}
