// K4: one digit pass of the MSD radix select's threshold refinement.
//
// Replaces the Pallas kernel of src/repro/kernels/radix_select.py:
// _tile_hist (pallas_call at :128, body _hist_kernel :108-112), as reached
// through _masked_hist (:138-151) from _kth_key_digit_serial (:158-185).
// The digit choice between passes and the exact-k compaction stay in
// PyTorch (kernels/radix_select.py), as jnp stays outside Pallas in the
// reference.
//
// What it computes, per row: the histogram of one digit (bits [shift,
// shift + digit_bits)) of the encoded keys that are still active, i.e.
// whose bits above the digit equal the row's threshold prefix (every key on
// the first pass).  The reference counts inactive and pad slots into a
// throwaway column; here they are simply not counted.
//
// Bound on the H100: one pass reads every key once and writes rows * radix
// int32 counts, n * key bytes + rows * radix * 4 over 3.35 TB/s; e.g. 2^24
// float32 keys, 67 MB, 0.020 ms.  The O(n) shifts and compares are far
// below the card's integer rate.
//
// Design: a grid over (row, tile).  Each CTA of 256 threads reads its tile
// of the source dtype and encodes in registers (keys.cuh encode_key, with
// the descending complement when asked), so no encoded copy of the row is
// ever written; tests each key against the threshold prefix, read once
// from device memory; and counts the active digits into a shared-memory
// histogram.  Lanes of a warp that share a digit are combined first
// (__match_any_sync), so one shared atomic serves each distinct digit of
// the warp: the first, all-active pass of real keys has few distinct top
// digits.  The CTA then adds its non-zero counts into the row's histogram
// in device memory with one global atomic each.  Integer counts do not
// depend on the order of the atomics, so the result is deterministic and
// does not depend on the tile size.
#include "keys.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRadix = 256;

template <typename TR>
__global__ void __launch_bounds__(kThreads)
select_hist_kernel(const typename TR::S* __restrict__ keys,
                   const long long* __restrict__ thresh,
                   int* __restrict__ hist, long long n, int tile,
                   int tiles_per_row, int shift, int digit_bits,
                   uint32_t flip) {
  __shared__ int h[kMaxRadix];
  const int radix = 1 << digit_bits;
  for (int i = threadIdx.x; i < radix; i += kThreads) h[i] = 0;
  __syncthreads();

  constexpr int kBits = 8 * static_cast<int>(sizeof(typename TR::S));
  const long long row = blockIdx.x / tiles_per_row;
  const long long start =
      static_cast<long long>(blockIdx.x % tiles_per_row) * tile;
  const long long end = min(start + tile, n);
  const int hi = shift + digit_bits;
  // bits above the digit: the threshold prefix fixed by earlier passes
  const bool all = hi >= kBits;
  const uint32_t prefix =
      all ? 0u : static_cast<uint32_t>(
                     static_cast<unsigned long long>(thresh[row]) >> hi);
  const typename TR::S* kr = keys + row * n;
  const unsigned lane_below = (1u << (threadIdx.x & 31)) - 1u;
  // every lane runs the same trip count, so the warp stays converged for
  // __match_any_sync
  for (long long base = start; base < end; base += kThreads) {
    const long long i = base + threadIdx.x;
    int d = -1;                        // -1: not counted
    if (i < end) {
      const uint32_t u = encode_key<TR>(kr[i]) ^ flip;
      if (all || (u >> hi) == prefix) {
        d = static_cast<int>((u >> shift) & static_cast<uint32_t>(radix - 1));
      }
    }
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (d >= 0 && (peers & lane_below) == 0) atomicAdd(&h[d], __popc(peers));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < radix; i += kThreads) {
    if (h[i] != 0) atomicAdd(&hist[row * radix + i], h[i]);
  }
}

template <typename TR>
int launch(const void* keys, const void* thresh, void* hist, long long rows,
           long long n, int tile, int shift, int digit_bits, int descending,
           cudaStream_t stream) {
  constexpr int kBits = 8 * static_cast<int>(sizeof(typename TR::S));
  if (digit_bits < 1 || digit_bits > 8 || tile < 1 || shift < 0 ||
      shift + digit_bits > kBits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles_per_row = (n + tile - 1) / tile;
  const long long grid = rows * tiles_per_row;
  if (grid < 1 || grid > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint32_t flip =
      descending ? (kBits == 32 ? 0xffffffffu : (1u << kBits) - 1u) : 0u;
  select_hist_kernel<TR><<<static_cast<unsigned>(grid), kThreads, 0,
                           stream>>>(
      static_cast<const typename TR::S*>(keys),
      static_cast<const long long*>(thresh), static_cast<int*>(hist), n, tile,
      static_cast<int>(tiles_per_row), shift, digit_bits, flip);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hist[row * 2^digit_bits + d] += the count of active keys of row `row` of
// the contiguous (rows, n) key array whose digit at `shift` is d.  A key is
// active when its encoded bits above shift + digit_bits equal those of
// thresh[row] (an int64 holding the unsigned encoded prefix), or always
// when no bits lie above.  Keys are encoded by the codec of dtype `code`
// (complemented when `descending`); pass the unsigned code of the width for
// keys that are encoded already.  `hist` must be zeroed by the caller.
// Returns the cudaError_t of the launch.
extern "C" int select_digit_hist(int code, const void* keys,
                                 const void* thresh, void* hist,
                                 long long rows, long long n, int tile,
                                 int shift, int digit_bits, int descending,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  KEY_DISPATCH(code, TR,
               return launch<TR>(keys, thresh, hist, rows, n, tile, shift,
                                 digit_bits, descending, s))
}
