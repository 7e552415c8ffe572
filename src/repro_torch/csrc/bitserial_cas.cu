// K7: the paper's in-memory compare-and-swap, gate by gate.
//
// Replaces the Pallas kernel of src/repro/kernels/bitserial_cas.py:
// cas_blocks (pallas_call at :84, body _exec_program :28-64), reached
// through kernels/ops.py:187 bitserial_cas.
//
// What it computes: for every operand pair (a, b) of W-bit unsigned words,
// (min, max), by running the two-input NOR/AND/NOT/COPY program of
// core/gates.build_cas_program(W) one op ("IMC cycle") at a time over the
// simulated 6T SRAM array of that pair: 28 ops on 22 rows at W = 4, 104 on
// 98 at W = 32.  The kernel never compares a with b itself.
//
// The program comes from Python as a table of int32 ops, 7 fields each:
// kind (NOR 0, AND 1, NOT 2, COPY 3), src1, src2 (the constant row for NOT
// and COPY), dst, movement (SAME 0, SHIFT_RIGHT 1, BCAST_LAST 2,
// BCAST_COL 3), fill, bcast_col.  No netlist is written out here.
//
// Layout: one SRAM row of one pair is one W-bit mask in a uint32_t.  The
// reference's column c (column 0 the MSB) is bit W-1-c, so
//   SHIFT_RIGHT  column c-1 -> c, fill into column 0: v >> 1 | fill << W-1
//   BCAST_LAST   column W-1 is bit 0
//   BCAST_COL c  bit W-1-c
// and every result is masked to W bits (mask = W == 32 ? ~0u : (1 << W)-1;
// 1u << 32 is undefined behaviour and never evaluated).
//
// Bound on the H100: each pair reads two int32 words and writes two, 16 B;
// 2^26 pairs move 1.07 GB, 0.32 ms at 3.35 TB/s.  The program needs at
// least one logic instruction per op and pair: 28 at W = 4 (bytes-bound),
// 104 at W = 32, about 0.4 ms at the card's INT32 issue rate
// (operations-bound).
//
// Design (a first, simple version): one thread per pair, grid-stride over
// the flattened pairs; the op table is copied into shared memory once per
// CTA and every thread walks it, so all lanes of a warp read the same op
// (a shared-memory broadcast) and take the same branch.  The row file is a
// per-thread array indexed by the table, so it lives in local memory
// (cached in L1/L2), not in registers.  Rows other than the constants and
// A/B are never read before the program writes them.  Unrolling the
// program at compile time (rows in registers), or bit-slicing 32 pairs per
// thread, is later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFields = 7;
constexpr int kMaxOps = 128;    // kernels/bitserial_cas.py MAX_OPS
constexpr int kMaxRows = 128;   // kernels/bitserial_cas.py MAX_ROWS
constexpr long long kMaxBlocks = 1LL << 20;

enum : int { kNor = 0, kAnd = 1, kNot = 2, kCopy = 3 };
enum : int { kSame = 0, kShiftRight = 1, kBcastLast = 2, kBcastCol = 3 };

__global__ void __launch_bounds__(kThreads)
cas_kernel(const int* __restrict__ a, const int* __restrict__ b,
           int* __restrict__ lo, int* __restrict__ hi, long long n,
           const int* __restrict__ prog, int n_ops, int width) {
  __shared__ int sprog[kMaxOps * kFields];
  for (int i = threadIdx.x; i < n_ops * kFields; i += kThreads)
    sprog[i] = prog[i];
  __syncthreads();

  const uint32_t mask = width == 32 ? 0xFFFFFFFFu : ((1u << width) - 1u);
  const uint32_t top = 1u << (width - 1);
  uint32_t row[kMaxRows];
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long p = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       p < n; p += stride) {
    row[0] = 0u;                                   // ROW_ZERO
    row[1] = mask;                                 // ROW_ONE
    row[2] = static_cast<uint32_t>(a[p]) & mask;   // ROW_A
    row[3] = static_cast<uint32_t>(b[p]) & mask;   // ROW_B
    for (int i = 0; i < n_ops; ++i) {
      const int* op = sprog + i * kFields;
      const uint32_t x = row[op[1]], y = row[op[2]];
      uint32_t v = (op[0] == kNor || op[0] == kNot) ? (~(x | y) & mask)
                                                    : (x & y);
      const int mv = op[4];
      if (mv == kShiftRight) {
        v = ((v >> 1) | (op[5] ? top : 0u)) & mask;
      } else if (mv == kBcastLast) {
        v = (v & 1u) ? mask : 0u;
      } else if (mv == kBcastCol) {
        v = ((v >> (width - 1 - op[6])) & 1u) ? mask : 0u;
      }
      row[op[3]] = v;
    }
    lo[p] = static_cast<int>(row[2]);
    hi[p] = static_cast<int>(row[3]);
  }
}

}  // namespace

// (min, max) of n pairs of W-bit words (int32 carriers of the W low bits)
// by the gate program `prog` (n_ops x 7 int32, on the card), whose rows are
// all below n_rows.  Returns the cudaError_t of the launch; 1
// (cudaErrorInvalidValue) for a width, op count or row count the kernel
// does not take.
extern "C" int bitserial_cas(const void* a, const void* b, void* lo,
                             void* hi, long long n, const void* prog,
                             int n_ops, int n_rows, int width,
                             void* stream) {
  if (width < 2 || width > 32 || (width & (width - 1)) != 0 ||
      n_ops < 1 || n_ops > kMaxOps || n_rows < 4 || n_rows > kMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cas_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(a), static_cast<const int*>(b),
      static_cast<int*>(lo), static_cast<int*>(hi), n,
      static_cast<const int*>(prog), n_ops, width);
  return static_cast<int>(cudaGetLastError());
}
