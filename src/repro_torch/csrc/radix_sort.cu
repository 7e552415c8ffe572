// K3: one digit pass of a stable LSD radix sort over keycodec keys.
//
// Replaces the Pallas kernels of src/repro/kernels/radix_sort.py:
// _digit_stats (pallas_call at :123, body _digit_stats_kernel :90-95) and
// _global_pos (pallas_call at :141, body _global_pos_kernel :98-102), plus
// the XLA scatter that _pass_permutation (:155-179) runs after them.  The
// pass loop, padding and the cross-tile prefix sum stay in PyTorch
// (kernels/radix_sort.py), as jnp.cumsum stays outside Pallas in the
// reference.
//
// Bound on the H100, per pass over n keys of b bytes in tiles of T with
// radix R: the upsweep reads n*b bytes and writes (n/T)*R*4; the downsweep
// reads n*b (+4n payload) and the (n/T)*R*4 bases and writes n*b (+4n).
// A 2^26-key uint32 key-value pass at T=4096, R=256 moves 1.28 GiB, 0.41 ms.
//
// Design:
//  * upsweep, one CTA of 256 threads per tile: digit histogram with
//    shared-memory atomics (a count does not depend on arrival order);
//  * downsweep, one CTA per tile: the stable in-tile rank of each element is
//    recomputed by position, never by atomics (their order is arbitrary).
//    The tile is walked 256 elements at a time; in each step a warp finds
//    the lanes that share its digit with __match_any_sync, ranks a lane by
//    the peers below it, adds the counts of that digit in the warps before
//    it, and adds the running count of the digit from earlier steps.  The
//    element goes straight to base[tile][digit] + rank, which fuses the
//    reference's position kernel with its scatter.  Key and payload move in
//    one write each.
#include "keys.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRadix = 256;

template <typename U>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const U* __restrict__ keys, int* __restrict__ hist, int m,
            int tile, int tiles_per_row, int shift, int radix) {
  __shared__ int h[kMaxRadix];
  for (int i = threadIdx.x; i < radix; i += kThreads) h[i] = 0;
  __syncthreads();
  const long long blk = blockIdx.x;
  const long long row = blk / tiles_per_row;
  const int t = static_cast<int>(blk % tiles_per_row);
  const U* kr = keys + row * m + static_cast<long long>(t) * tile;
  for (int i = threadIdx.x; i < tile; i += kThreads) {
    atomicAdd(&h[(static_cast<uint32_t>(kr[i]) >> shift) & (radix - 1)], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < radix; i += kThreads) {
    hist[blk * radix + i] = h[i];
  }
}

template <typename U, bool KV>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const U* __restrict__ kin, const int* __restrict__ vin,
               U* __restrict__ kout, int* __restrict__ vout,
               const int* __restrict__ base, int m, int tile,
               int tiles_per_row, int shift, int radix) {
  __shared__ int run[kMaxRadix];
  __shared__ int wc[kWarps][kMaxRadix];
  const long long blk = blockIdx.x;
  const long long row = blk / tiles_per_row;
  const int t = static_cast<int>(blk % tiles_per_row);
  const long long rowoff = row * m;
  const long long toff = rowoff + static_cast<long long>(t) * tile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  for (int i = threadIdx.x; i < radix; i += kThreads) {
    run[i] = base[blk * radix + i];
  }
  for (int s = 0; s < tile; s += kThreads) {
    for (int i = threadIdx.x; i < kWarps * kMaxRadix; i += kThreads) {
      (&wc[0][0])[i] = 0;
    }
    __syncthreads();
    const int i = s + threadIdx.x;
    const bool valid = i < tile;
    const U key = valid ? kin[toff + i] : U(0);
    const int val = (KV && valid) ? vin[toff + i] : 0;
    // invalid lanes carry digit -1 and so only match each other
    const int d = valid
        ? static_cast<int>((static_cast<uint32_t>(key) >> shift) & (radix - 1))
        : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int lrank = __popc(peers & below);
    if (valid && lrank == 0) wc[warp][d] = __popc(peers);
    __syncthreads();
    if (valid) {
      int pos = run[d] + lrank;
      for (int w = 0; w < warp; ++w) pos += wc[w][d];
      kout[rowoff + pos] = key;
      if (KV) vout[rowoff + pos] = val;
    }
    __syncthreads();
    for (int dd = threadIdx.x; dd < radix; dd += kThreads) {
      int c = 0;
      for (int w = 0; w < kWarps; ++w) c += wc[w][dd];
      run[dd] += c;
    }
    __syncthreads();
  }
}

template <typename U>
int launch_hist(const void* keys, void* hist, long long rows, int m,
                int tile, int shift, int digit_bits, cudaStream_t stream) {
  const int tiles_per_row = m / tile;
  hist_kernel<U><<<static_cast<unsigned>(rows * tiles_per_row), kThreads, 0,
                   stream>>>(static_cast<const U*>(keys),
                             static_cast<int*>(hist), m, tile, tiles_per_row,
                             shift, 1 << digit_bits);
  return static_cast<int>(cudaGetLastError());
}

template <typename U, bool KV>
int launch_scatter(const void* kin, const void* vin, void* kout, void* vout,
                   const void* base, long long rows, int m, int tile,
                   int shift, int digit_bits, cudaStream_t stream) {
  const int tiles_per_row = m / tile;
  scatter_kernel<U, KV><<<static_cast<unsigned>(rows * tiles_per_row),
                          kThreads, 0, stream>>>(
      static_cast<const U*>(kin), static_cast<const int*>(vin),
      static_cast<U*>(kout), static_cast<int*>(vout),
      static_cast<const int*>(base), m, tile, tiles_per_row, shift,
      1 << digit_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Upsweep: hist[(row * m/tile + t) * 2^digit_bits + d] = count of digit d
// (bits [shift, shift + digit_bits) of the unsigned key) in tile t of row
// `row` of the contiguous (rows, m) key array; m is a multiple of tile.
extern "C" int radix_digit_hist(int key_bytes, const void* keys, void* hist,
                                long long rows, int m, int tile, int shift,
                                int digit_bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (key_bytes) {
    case 1: return launch_hist<uint8_t>(keys, hist, rows, m, tile, shift,
                                        digit_bits, s);
    case 2: return launch_hist<uint16_t>(keys, hist, rows, m, tile, shift,
                                         digit_bits, s);
    case 4: return launch_hist<uint32_t>(keys, hist, rows, m, tile, shift,
                                         digit_bits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Downsweep: every element of tile t goes to slot base[t][digit] + its
// stable rank among the tile's elements of that digit, within its row.
// vin/vout null -> keys only.
extern "C" int radix_digit_scatter(int key_bytes, const void* kin,
                                   const void* vin, void* kout, void* vout,
                                   const void* base, long long rows, int m,
                                   int tile, int shift, int digit_bits,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool kv = vin != nullptr;
#define RADIX_SCATTER(U)                                                    \
  return kv ? launch_scatter<U, true>(kin, vin, kout, vout, base, rows, m, \
                                      tile, shift, digit_bits, s)          \
            : launch_scatter<U, false>(kin, vin, kout, vout, base, rows, m,\
                                       tile, shift, digit_bits, s)
  switch (key_bytes) {
    case 1: RADIX_SCATTER(uint8_t);
    case 2: RADIX_SCATTER(uint16_t);
    case 4: RADIX_SCATTER(uint32_t);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RADIX_SCATTER
}
