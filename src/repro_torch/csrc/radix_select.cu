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
// Design: a grid sized to the card, one CTA of 1024 threads an SM.  Each
// row is cut into `parts` contiguous spans of 16-byte vectors (4 float32,
// 8 bf16 / int16, 16 int8 keys a load), chosen so that rows * parts fills
// the grid; CTAs stride over the (row, part) segments.  Each thread keeps
// kUnroll vector loads in flight, encodes the keys in registers (keys.cuh
// encode_key, with the descending complement when asked; no encoded copy of
// the row is ever written), tests each against the row's threshold prefix
// and counts its digit into shared memory.  The counters are `copies`
// sub-histograms, bin d of copy c at d * copies + c, and a lane counts into
// copy lane % copies: with 32 copies no two lanes of a warp ever touch one
// address or one bank, however skewed the digits are (the first pass of
// real keys has a few distinct top digits), so no lane waits on another and
// no __match_any_sync is needed.  Short segments take fewer copies, so that
// zeroing and summing them stays small beside the counting.  At the end of
// a segment the CTA sums each bin over its copies and adds it into the
// row's histogram in device memory, one global atomic a non-zero bin: a few
// hundred CTAs, not one per 4096-key tile.  Integer counts do not depend
// on the order of the atomics, so the result is deterministic.  The caller
// zeroes the histogram once a selection, not once a pass.
#include "keys.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 4;         // 16-byte loads in flight a thread
constexpr int kMaxCopies = 32;

template <typename TR>
__global__ void __launch_bounds__(kThreads)
select_hist_kernel(const typename TR::S* __restrict__ keys,
                   const long long* __restrict__ thresh,
                   int* __restrict__ hist, long long n, long long segments,
                   int parts, int copies, int shift, int digit_bits,
                   uint32_t flip) {
  typedef typename TR::S S;
  constexpr int E = static_cast<int>(sizeof(S));
  constexpr int kVec = 16 / E;
  constexpr int kBits = 8 * E;
  extern __shared__ int h[];        // radix * copies counters
  const int radix = 1 << digit_bits;
  const uint32_t mask = static_cast<uint32_t>(radix - 1);
  const int copy = static_cast<int>(threadIdx.x) & (copies - 1);
  const int hi = shift + digit_bits;
  // bits above the digit: the threshold prefix fixed by earlier passes
  const bool all = hi >= kBits;

  for (long long seg = blockIdx.x; seg < segments; seg += gridDim.x) {
    const long long row = seg / parts;
    const int part = static_cast<int>(seg - row * parts);
    for (int i = threadIdx.x; i < radix * copies; i += kThreads) h[i] = 0;
    __syncthreads();

    const uint32_t prefix =
        all ? 0u : static_cast<uint32_t>(
                       static_cast<unsigned long long>(thresh[row]) >> hi);
    auto add = [&](S s) {
      const uint32_t u = encode_key<TR>(s) ^ flip;
      if (all || (u >> hi) == prefix) {
        atomicAdd(&h[static_cast<int>((u >> shift) & mask) * copies + copy],
                  1);
      }
    };
    auto add_vec = [&](const uint4& w) {
      S s[kVec];
      memcpy(s, &w, 16);
#pragma unroll
      for (int q = 0; q < kVec; ++q) add(s[q]);
    };

    // the row: a scalar head up to the first 16-byte boundary, vectors, a
    // scalar tail; the vectors split evenly among the row's parts
    const S* kr = keys + row * n;
    const long long head = min(
        n, static_cast<long long>(
               ((16 - (reinterpret_cast<uintptr_t>(kr) & 15)) & 15) / E));
    const long long nvec = (n - head) / kVec;
    const uint4* vp = reinterpret_cast<const uint4*>(kr + head);
    const long long ve = nvec * (part + 1) / parts;
    long long v = nvec * part / parts + threadIdx.x;
    for (; v + (kUnroll - 1) * kThreads < ve; v += kUnroll * kThreads) {
      uint4 w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) w[u] = __ldg(vp + v + u * kThreads);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add_vec(w[u]);
    }
    for (; v < ve; v += kThreads) add_vec(__ldg(vp + v));
    if (part == 0) {
      for (long long i = threadIdx.x; i < head; i += kThreads) add(kr[i]);
      for (long long i = head + nvec * kVec + threadIdx.x; i < n;
           i += kThreads) {
        add(kr[i]);
      }
    }
    __syncthreads();

    // one global atomic a non-zero bin; thread d reads its bin's copies
    // from a rotated start, so a warp's reads fall into distinct banks
    for (int d = threadIdx.x; d < radix; d += kThreads) {
      int sum = 0;
      for (int c = 0; c < copies; ++c) {
        sum += h[d * copies + ((c + d) & (copies - 1))];
      }
      if (sum != 0) atomicAdd(&hist[row * radix + d], sum);
    }
    __syncthreads();
  }
}

template <typename TR>
int launch(const void* keys, const void* thresh, void* hist, long long rows,
           long long n, int shift, int digit_bits, int descending,
           cudaStream_t stream) {
  typedef typename TR::S S;
  constexpr int kBits = 8 * static_cast<int>(sizeof(S));
  constexpr int kVec = 16 / static_cast<int>(sizeof(S));
  if (digit_bits < 1 || digit_bits > 8 || shift < 0 ||
      shift + digit_bits > kBits || rows < 1 || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // parts a row: the grid over the rows, rounded, but no part shorter than
  // one unrolled sweep of the CTA
  const long long sweep = static_cast<long long>(kThreads) * kUnroll * kVec;
  long long parts = (sms + rows / 2) / rows;
  const long long most = (n + sweep - 1) / sweep;
  parts = parts < 1 ? 1 : (parts > most ? most : parts);
  const long long segments = rows * parts;
  const long long grid = segments < sms ? segments : sms;
  // sub-histograms: as many as the segment has keys for, 4 a counter, at
  // most one a lane
  const int radix = 1 << digit_bits;
  int copies = 1;
  while (copies < kMaxCopies &&
         static_cast<long long>(2 * copies) * radix * 4 <= n / parts) {
    copies *= 2;
  }
  const uint32_t flip =
      descending ? (kBits == 32 ? 0xffffffffu : (1u << kBits) - 1u) : 0u;
  select_hist_kernel<TR><<<static_cast<unsigned>(grid), kThreads,
                           radix * copies * sizeof(int), stream>>>(
      static_cast<const S*>(keys), static_cast<const long long*>(thresh),
      static_cast<int*>(hist), n, segments, static_cast<int>(parts), copies,
      shift, digit_bits, flip);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hist[row * 2^digit_bits + d] += the count of active keys of row `row` of
// the contiguous (rows, n) key array whose digit at `shift` is d.  A key is
// active when its encoded bits above shift + digit_bits equal those of
// thresh[row] (an int64 holding the unsigned encoded prefix), or always
// when no bits lie above.  Keys are encoded by the codec of dtype `code`
// (complemented when `descending`); pass the unsigned code of the width for
// keys that are encoded already.  `hist` must be zeroed by the caller (once
// for any number of passes into distinct histograms).  Returns the
// cudaError_t of the launch.
extern "C" int select_digit_hist(int code, const void* keys,
                                 const void* thresh, void* hist,
                                 long long rows, long long n, int shift,
                                 int digit_bits, int descending,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  KEY_DISPATCH(code, TR,
               return launch<TR>(keys, thresh, hist, rows, n, shift,
                                 digit_bits, descending, s))
}
