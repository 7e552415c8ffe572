// K7: the paper's in-memory compare-and-swap, from its gate program.
//
// Replaces the Pallas kernel of src/repro/kernels/bitserial_cas.py:
// cas_blocks (pallas_call at :84, body _exec_program :28-64), reached
// through kernels/ops.py bitserial_cas, and the stage loop around it in
// src/repro/core/sorter.py:67-80 (gather, CAS, select, scatter).
//
// What it computes: for every operand pair (a, b) of W-bit unsigned words,
// (min, max), from the two-input NOR/AND/NOT/COPY program of
// core/gates.build_cas_program(W): 28 ops on 22 rows at W = 4, 104 on 98 at
// W = 32.  The kernels never compare a with b and call no min or max.
//
// The programs are straight-line code in cas_programs.cuh, generated from
// kernels/bitserial_cas.py program_table(W): every op is one or two integer
// instructions on a named local, so each row of the simulated SRAM array
// lives in a register (ptxas: no stack frame, no spills at any W).  nvcc
// compiles the program's logic rather than each gate (it merges NOR + NOT
// into one LOP3, folds runs of shifts, drops the closing COPYs), so a pair
// costs fewer instructions than the program has gates; chip_smoke.py counts
// them in the SASS and checks that no min/max instruction appears.
//
// Two kernels:
//  * bitserial_cas: (lo, hi) of n flat pairs, 4 pairs a thread by 16-byte
//    loads and stores where all four pointers allow it;
//  * bitserial_cas_stage: one stage (k, j) of the bitonic network over
//    (batch, n) words, in place.  A thread takes the pair (i, i ^ j) with
//    i & j == 0, runs the program and writes (min, max) to (i, i ^ j) when
//    i & k == 0, else (max, min).  Every position lies in exactly one pair
//    of a stage, so no write collides and no gather index is needed.
//
// Bound on the H100 (3.35 TB/s; INT32 rate 132 SMs x 64 lanes x 1.98 GHz
// = 16.7 Tops/s): a pair reads 8 bytes and writes 8 (2^23 pairs: 0.040 ms),
// against the INT32 instructions the compiled program issues a pair.
#include <cstdint>
#include <cuda_runtime.h>

#include "cas_programs.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 32;

inline unsigned blocks_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

template <int W>
__device__ __forceinline__ void cas_word(int a, int b, int& lo, int& hi) {
  uint32_t x = static_cast<uint32_t>(a), y = static_cast<uint32_t>(b);
  cas_program<W>(x, y);
  lo = static_cast<int>(x);
  hi = static_cast<int>(y);
}

template <int W>
__global__ void __launch_bounds__(kThreads)
cas_pairs(const int* __restrict__ a, const int* __restrict__ b,
          int* __restrict__ lo, int* __restrict__ hi, long long n,
          bool vec) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long n4 = n >> 2;
    const int4* a4 = reinterpret_cast<const int4*>(a);
    const int4* b4 = reinterpret_cast<const int4*>(b);
    int4* lo4 = reinterpret_cast<int4*>(lo);
    int4* hi4 = reinterpret_cast<int4*>(hi);
    for (long long g = tid; g < n4; g += stride) {
      const int4 x = a4[g], y = b4[g];
      int4 l, h;
      cas_word<W>(x.x, y.x, l.x, h.x);
      cas_word<W>(x.y, y.y, l.y, h.y);
      cas_word<W>(x.z, y.z, l.z, h.z);
      cas_word<W>(x.w, y.w, l.w, h.w);
      lo4[g] = l;
      hi4[g] = h;
    }
    done = n4 << 2;
  }
  for (long long p = done + tid; p < n; p += stride) {
    cas_word<W>(a[p], b[p], lo[p], hi[p]);
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
cas_stage(int* __restrict__ v, long long pairs, int log_half, int k, int j) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long half_mask = (1LL << log_half) - 1;
  for (long long g = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       g < pairs; g += stride) {
    int* row = v + ((g >> log_half) << (log_half + 1));
    const int p = static_cast<int>(g & half_mask);
    // p with a 0 inserted at bit log2(j): the pair's low index
    const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
    const int ip = i | j;
    int lo, hi;
    cas_word<W>(row[i], row[ip], lo, hi);
    const bool up = (i & k) == 0;
    row[i] = up ? lo : hi;
    row[ip] = up ? hi : lo;
  }
}

template <int W>
int launch_pairs(const void* a, const void* b, void* lo, void* hi,
                 long long n, cudaStream_t stream) {
  const bool vec = ((reinterpret_cast<uintptr_t>(a) |
                     reinterpret_cast<uintptr_t>(b) |
                     reinterpret_cast<uintptr_t>(lo) |
                     reinterpret_cast<uintptr_t>(hi)) & 15) == 0;
  cas_pairs<W><<<blocks_for(vec ? (n + 3) / 4 : n), kThreads, 0, stream>>>(
      static_cast<const int*>(a), static_cast<const int*>(b),
      static_cast<int*>(lo), static_cast<int*>(hi), n, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int launch_stage(void* v, long long batch, long long n, int k, int j,
                 cudaStream_t stream) {
  int log_half = 0;
  while ((2LL << log_half) < n) ++log_half;
  const long long pairs = batch * (n / 2);
  cas_stage<W><<<blocks_for(pairs), kThreads, 0, stream>>>(
      static_cast<int*>(v), pairs, log_half, k, j);
  return static_cast<int>(cudaGetLastError());
}

inline bool pow2(long long x) { return x > 0 && (x & (x - 1)) == 0; }

}  // namespace

#define CAS_WIDTHS(CALL) \
  switch (width) {       \
    case 2: CALL(2);     \
    case 4: CALL(4);     \
    case 8: CALL(8);     \
    case 16: CALL(16);   \
    case 32: CALL(32);   \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

// (min, max) of n pairs of W-bit words (int32 carriers of the W low bits).
// Returns the cudaError_t of the launch; 1 (cudaErrorInvalidValue) for a
// width the kernel does not take.
extern "C" int bitserial_cas(const void* a, const void* b, void* lo,
                             void* hi, long long n, int width,
                             void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CAS_PAIRS(W) return launch_pairs<W>(a, b, lo, hi, n, s)
  CAS_WIDTHS(CAS_PAIRS)
#undef CAS_PAIRS
}

// Bitonic stage (k, j) over each row of the contiguous (batch, n) int32
// words v, in place.  n, k, j powers of two, j < k <= n < 2^31.
extern "C" int bitserial_cas_stage(void* v, long long batch, long long n,
                                   long long k, long long j, int width,
                                   void* stream) {
  if (!pow2(n) || n < 2 || n >= (1LL << 31) || !pow2(k) || k < 2 ||
      k > n || !pow2(j) || j >= k || batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // k = n = 2^31 is refused above, so both fit an int
  const int ki = static_cast<int>(k), ji = static_cast<int>(j);
#define CAS_STAGE(W) return launch_stage<W>(v, batch, n, ki, ji, s)
  CAS_WIDTHS(CAS_STAGE)
#undef CAS_STAGE
}

#undef CAS_WIDTHS
