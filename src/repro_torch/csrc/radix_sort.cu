// K3: stable LSD radix sort over keycodec keys, onesweep.
//
// Replaces the Pallas kernels of src/repro/kernels/radix_sort.py:
// _digit_stats (pallas_call at :123, body _digit_stats_kernel :90-95) and
// _global_pos (pallas_call at :141, body _global_pos_kernel :98-102), with
// the cross-tile prefix sum between them (jnp.cumsum, :170-172) and the
// XLA scatter that _pass_permutation (:155-179) runs after them.
//
// A sort of (rows, m) keys of b bytes with d-bit digits is 1 + 8b/d
// launches and no glue:
//  * radix_onesweep_hist: one read of the keys counts the digits of every
//    pass of every row, (rows, passes, 2^d) int32: per-CTA shared-memory
//    counts (8 copies, lane & 7 picks one, so lanes with one digit do not
//    serialise 32 deep; 4 loads a thread in flight before their counts),
//    then one global atomic per nonzero bin;
//  * radix_onesweep_pass, once a digit pass: each CTA takes the next tile
//    id (rows x ceil(m / 4096) tiles, row-major) from an atomic counter, so
//    a tile waits only on tiles whose CTAs have started.  It loads 4096
//    keys (and payloads) into registers, 16 a thread, warp-striped, and
//    ranks each stably by position: per warp, __match_any_sync finds the
//    lanes of one digit, the lowest of them bumps the warp's count of that
//    digit, and the rank is that count plus the peers below the lane.  The
//    tile publishes its per-digit counts with decoupled look-back: a 64-bit
//    status word per (tile, digit), the count in the low half and
//    (pass + 1) << 2 | flag in the high half (flag 1 the tile's own count,
//    2 the inclusive prefix of the row up to it), so one zeroed array
//    serves every pass of a sort without clearing.  The first tile of a
//    row publishes its prefix at once; a later one walks back over its
//    row's tiles, adding counts until it meets a prefix.  The digit's base
//    in the row is the exclusive scan of the histogram, done in the CTA.
//    Then the tile is reordered by digit in shared memory and written out
//    so that consecutive threads write consecutive addresses of one
//    digit's run: a warp's 32 stores fill whole sectors, not 32 sectors.
//    The last tile of a row is partial; its missing items take no rank.
//
//  * radix_bucket_hist (a third entry, replacing the same _digit_stats call
//    where src/repro/engine/samplesort.py:121-137 counts a sorted shard's
//    keys by splitter interval with the interval id as the digit): the
//    counts of searchsorted(splitters, key, side="left") over the D
//    buckets of D - 1 splitters, plus the reference's pad bin (always 0
//    here: the kernel reads exactly n keys), so D + 1 bins <= 1024.
//    Contract: the shard is ascending in signed order and the splitters
//    are ascending, as every caller (bucket_bounds) has them; then the
//    count of bucket b is pos[b] - pos[b - 1], pos[j] = #{keys <=
//    splitter[j]} (pos[-1] = 0, pos[D - 1] = n), ties and repeated
//    splitters included.  One warp a bin finds pos[b] and pos[b - 1] with
//    two interleaved 33-ary searches: each round its 32 lanes read 32
//    evenly spaced keys of the interval left, and __ballot_sync(key <=
//    splitter) with __popc picks one of the 33 sub-intervals; once 32 keys
//    or fewer are left, one read of them ends it.  ceil(log33 n) dependent
//    rounds: 5 at 2^25 keys, each one read of 32 adjacent-in-rank keys a
//    splitter.  Every bin is written (no zeroed buffer, one launch), one
//    warp a bin over ceil((D + 1) / 4) CTAs, so up to 1023 bins never
//    wait on one another.
//    Bound: latency, 5 dependent reads of device memory (or L2) a bin;
//    the bytes it must move, ~640 a splitter, are no bound.  (The first
//    version streamed every key through a binary search in shared memory:
//    one read of 2^25 int32 keys, 0.040 ms at 3.35 TB/s.)
//
// Bound on the H100 (3.35 TB/s), 2^26 uint32 keys with int32 payloads, 8-bit
// digits: the histogram reads the keys once (268 MB, 0.080 ms), each of the
// 4 passes reads and writes key and payload (1.07 GB, 0.32 ms): 1.36 ms a
// sort.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;      // kernels/radix_sort.py
                                              // ONESWEEP_TILE
constexpr int kMaxRadix = 256;
constexpr int kMaxBins = 1024;                // passes x radix, at most
constexpr int kParts = 8;
constexpr int kPartStride = kMaxBins + 1;     // copy q of bin b: bank q + b
constexpr long long kHistCtas = 132 * 8;
constexpr int kHistLoads = 4;

constexpr uint32_t kAggregate = 1u, kPrefix = 2u;

__device__ __forceinline__ void publish(unsigned long long* p, uint32_t tag,
                                        int count) {
  *reinterpret_cast<volatile unsigned long long*>(p) =
      (static_cast<unsigned long long>(tag) << 32) |
      static_cast<uint32_t>(count);
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// exclusive prefix sum of x over the CTA's threads; every thread calls it
__device__ __forceinline__ int block_excl_scan(int x, int* s_sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) s_sum[warp] = inc;
  __syncthreads();
  int pre = 0;
  for (int w = 0; w < warp; ++w) pre += s_sum[w];
  return pre + inc - x;
}

template <typename U>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const U* __restrict__ keys, int* __restrict__ hist, long long m,
            long long span, int chunks, int passes, int digit_bits) {
  __shared__ int bins[kParts * kPartStride];
  const int radix = 1 << digit_bits;
  const int nb = passes * radix;
  const uint32_t dmask = radix - 1;
  for (int i = threadIdx.x; i < kParts * kPartStride; i += kThreads) {
    bins[i] = 0;
  }
  __syncthreads();
  const long long row = blockIdx.x / chunks;
  const long long lo = (blockIdx.x % chunks) * span;
  const long long hi = lo + span < m ? lo + span : m;
  const U* kr = keys + row * m;
  int* part = bins + (threadIdx.x & (kParts - 1)) * kPartStride;
  // kHistLoads keys a thread in flight before their counts
  long long i = lo + threadIdx.x;
  for (; i + (kHistLoads - 1) * kThreads < hi; i += kHistLoads * kThreads) {
    uint32_t u[kHistLoads];
#pragma unroll
    for (int q = 0; q < kHistLoads; ++q) {
      u[q] = static_cast<uint32_t>(kr[i + q * kThreads]);
    }
#pragma unroll
    for (int q = 0; q < kHistLoads; ++q) {
      for (int p = 0; p < passes; ++p) {
        atomicAdd(&part[p * radix + ((u[q] >> (p * digit_bits)) & dmask)],
                  1);
      }
    }
  }
  for (; i < hi; i += kThreads) {
    const uint32_t u = static_cast<uint32_t>(kr[i]);
    for (int p = 0; p < passes; ++p) {
      atomicAdd(&part[p * radix + ((u >> (p * digit_bits)) & dmask)], 1);
    }
  }
  __syncthreads();
  int* hr = hist + row * nb;
  for (int b = threadIdx.x; b < nb; b += kThreads) {
    int s = 0;
    for (int q = 0; q < kParts; ++q) s += bins[q * kPartStride + b];
    if (s != 0) atomicAdd(&hr[b], s);
  }
}

template <typename U, bool KV>
__global__ void __launch_bounds__(kThreads)
pass_kernel(const U* __restrict__ kin, const int* __restrict__ vin,
            U* __restrict__ kout, int* __restrict__ vout,
            const int* __restrict__ hist,
            unsigned long long* __restrict__ status,
            unsigned long long* __restrict__ counter, long long m,
            int tiles_per_row, int pass, int passes, int digit_bits) {
  __shared__ int s_tile;
  __shared__ int s_whist[kWarps][kMaxRadix];
  __shared__ int s_start[kMaxRadix];
  __shared__ int s_dst[kMaxRadix];
  __shared__ int s_sum[2][kWarps];
  __shared__ U s_keys[kTile];
  __shared__ int s_vals[KV ? kTile : 1];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int radix = 1 << digit_bits;
  const int shift = pass * digit_bits;
  const uint32_t dmask = radix - 1;
  const uint32_t epoch = static_cast<uint32_t>(pass + 1) << 2;

  if (threadIdx.x == 0) {
    s_tile = static_cast<int>(atomicAdd(counter + pass, 1ULL));
  }
  for (int i = threadIdx.x; i < kWarps * kMaxRadix; i += kThreads) {
    (&s_whist[0][0])[i] = 0;
  }
  __syncthreads();
  const int g = s_tile;
  // a tile id past the grid means the counter (and so the look-back words)
  // came from an earlier sort: stop the launch with an error rather than
  // leave the output unwritten or read stale prefixes
  if (static_cast<unsigned>(g) >= gridDim.x) __trap();
  const long long row = g / tiles_per_row;
  const int t = g - static_cast<int>(row) * tiles_per_row;
  const long long tile0 = static_cast<long long>(t) * kTile;
  const int n_valid = m - tile0 < kTile ? static_cast<int>(m - tile0)
                                        : kTile;

  // load: item i of lane l of warp w is element w * 512 + i * 32 + l
  const U* kr = kin + row * m + tile0;
  const int* vr = KV ? vin + row * m + tile0 : nullptr;
  const int e0 = warp * (32 * kItems) + lane;
  uint32_t key[kItems];
  int val[kItems];
  int rank[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int e = e0 + i * 32;
    key[i] = e < n_valid ? static_cast<uint32_t>(kr[e]) : 0u;
    if (KV) val[i] = e < n_valid ? vr[e] : 0;
  }

  // stable rank within the warp's elements of one digit, in element order
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const bool valid = e0 + i * 32 < n_valid;
    // missing items carry digit -1 and so only match each other
    const int d = valid ? static_cast<int>((key[i] >> shift) & dmask) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int leader = __ffs(peers) - 1;
    int before = 0;
    if (valid && lane == leader) {
      before = s_whist[warp][d];
      s_whist[warp][d] = before + __popc(peers);
    }
    before = __shfl_sync(0xffffffffu, before, leader);
    rank[i] = before + __popc(peers & below);
    __syncwarp();
  }
  __syncthreads();

  // per digit: the warps' counts -> exclusive offsets, the tile's count
  const int d = threadIdx.x;
  int count = 0;
  unsigned long long* mine = status + static_cast<long long>(g) * radix + d;
  if (d < radix) {
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_whist[w][d];
      s_whist[w][d] = count;
      count += c;
    }
    publish(mine, epoch | (t == 0 ? kPrefix : kAggregate), count);
  }
  const int start = block_excl_scan(count, s_sum[0]);
  const int row_base = block_excl_scan(
      d < radix ? hist[(row * passes + pass) * radix + d] : 0, s_sum[1]);

  // decoupled look-back over the earlier tiles of this row
  if (d < radix) {
    int excl = 0;
    if (t > 0) {
      const unsigned long long* prev = mine - radix;
      while (true) {
        const unsigned long long w = peek(prev);
        const uint32_t tag = static_cast<uint32_t>(w >> 32);
        if ((tag & ~3u) != epoch) continue;        // not published yet
        excl += static_cast<int>(static_cast<uint32_t>(w));
        if ((tag & 3u) == kPrefix) break;
        prev -= radix;
      }
      publish(mine, epoch | kPrefix, excl + count);
    }
    s_start[d] = start;
    // slot s of the reordered tile, of digit d, goes to s_dst[d] + s
    s_dst[d] = row_base + excl - start;
  }
  __syncthreads();

  // reorder by digit in shared memory
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (e0 + i * 32 < n_valid) {
      const int dd = static_cast<int>((key[i] >> shift) & dmask);
      const int slot = s_start[dd] + s_whist[warp][dd] + rank[i];
      s_keys[slot] = static_cast<U>(key[i]);
      if (KV) s_vals[slot] = val[i];
    }
  }
  __syncthreads();

  // write out: consecutive threads, consecutive addresses of a digit's run
  U* ko = kout + row * m;
  int* vo = KV ? vout + row * m : nullptr;
  for (int s = threadIdx.x; s < n_valid; s += kThreads) {
    const U k = s_keys[s];
    const int dd = static_cast<int>((static_cast<uint32_t>(k) >> shift) &
                                    dmask);
    const int dst = s_dst[dd] + s;
    ko[dst] = k;
    if (KV) vo[dst] = s_vals[s];
  }
}

template <typename U>
int launch_hist(const void* keys, void* hist, long long rows, long long m,
                int digit_bits, cudaStream_t stream) {
  const int passes = static_cast<int>(sizeof(U)) * 8 / digit_bits;
  long long chunks = (kHistCtas + rows - 1) / rows;
  const long long most = (m + kTile - 1) / kTile;
  if (chunks > most) chunks = most;
  if (chunks < 1) chunks = 1;
  const long long span = (m + chunks - 1) / chunks;
  hist_kernel<U><<<static_cast<unsigned>(rows * chunks), kThreads, 0,
                   stream>>>(static_cast<const U*>(keys),
                             static_cast<int*>(hist), m, span,
                             static_cast<int>(chunks), passes, digit_bits);
  return static_cast<int>(cudaGetLastError());
}

template <typename U, bool KV>
int launch_pass(const void* kin, const void* vin, void* kout, void* vout,
                const void* hist, void* status, long long rows, long long m,
                int pass, int digit_bits, cudaStream_t stream) {
  const int passes = static_cast<int>(sizeof(U)) * 8 / digit_bits;
  const long long tiles_per_row = (m + kTile - 1) / kTile;
  const long long tiles = rows * tiles_per_row;
  unsigned long long* st = static_cast<unsigned long long*>(status);
  pass_kernel<U, KV><<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      static_cast<const U*>(kin), static_cast<const int*>(vin),
      static_cast<U*>(kout), static_cast<int*>(vout),
      static_cast<const int*>(hist), st, st + tiles * (1LL << digit_bits),
      m, static_cast<int>(tiles_per_row), pass, passes, digit_bits);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kMaxBucketBins = 1024;          // kernels/radix_sort.py
                                              // MAX_BUCKET_BINS
constexpr int kBucketWarps = 4;              // bins a CTA, one a warp

// pos[q] = the number of the n ascending keys <= s[q] where need[q], for
// both q at once (each a warp-wide 33-ary search; the two read their keys
// in the same rounds)
template <typename T>
__device__ __forceinline__ void count_le2(const T* __restrict__ keys,
                                          long long n, const T (&s)[2],
                                          const bool (&need)[2],
                                          long long (&pos)[2]) {
  const int lane = threadIdx.x & 31;
  // the answer lies in [lo, hi]: keys below lo are <= s, keys[hi] > s
  // (or hi = n); the hi - lo keys between are unread
  long long lo[2] = {0, 0};
  long long hi[2] = {need[0] ? n : 0, need[1] ? n : 0};
  while (lo[0] < hi[0] || lo[1] < hi[1]) {
    T k[2];
    bool ok[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const long long len = hi[q] - lo[q];
      // lane i reads p_i = lo + len (i + 1) / 33 (32 distinct keys while
      // len >= 33), else key lo + i
      const long long i = len > 32 ? lo[q] + len * (lane + 1) / 33
                                   : lo[q] + lane;
      ok[q] = len > 32 || lane < len;
      k[q] = ok[q] ? keys[i] : T(0);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const long long len = hi[q] - lo[q];
      const int c = __popc(__ballot_sync(0xffffffffu, ok[q] && k[q] <= s[q]));
      if (len <= 32) {
        lo[q] = hi[q] = lo[q] + c;
      } else {
        // keys p_0 .. p_{c-1} are <= s, p_c is not: (p_{c-1}, p_c]
        const long long l0 = lo[q];
        if (c > 0) lo[q] = l0 + len * c / 33 + 1;
        if (c < 32) hi[q] = l0 + len * (c + 1) / 33;
      }
    }
  }
  pos[0] = lo[0];
  pos[1] = lo[1];
}

template <typename T>
__global__ void __launch_bounds__(kBucketWarps * 32)
bucket_search_kernel(const T* __restrict__ keys, long long n,
                     const T* __restrict__ split, int n_split,
                     int* __restrict__ counts) {
  const int b = blockIdx.x * kBucketWarps + (threadIdx.x >> 5);
  if (b > n_split) return;                  // whole warps leave
  // pos[b] (n past the last splitter) and pos[b - 1] (0 before the first)
  const bool need[2] = {b < n_split, b > 0};
  const T s[2] = {need[0] ? split[b] : T(0), need[1] ? split[b - 1] : T(0)};
  long long pos[2];
  count_le2<T>(keys, n, s, need, pos);
  const long long upper = need[0] ? pos[0] : n;
  const long long lower = pos[1];             // 0 where not needed
  if ((threadIdx.x & 31) == 0) {
    counts[b] = static_cast<int>(upper - lower);
    if (b == n_split) counts[b + 1] = 0;    // the pad bin
  }
}

template <typename T>
int launch_bucket_hist(const void* keys, long long n, const void* split,
                       int n_split, void* counts, cudaStream_t stream) {
  const int ctas = (n_split + 1 + kBucketWarps - 1) / kBucketWarps;
  bucket_search_kernel<T><<<ctas, kBucketWarps * 32, 0, stream>>>(
      static_cast<const T*>(keys), n, static_cast<const T*>(split), n_split,
      static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

inline bool bad_shape(long long rows, long long m, int digit_bits) {
  const long long tiles = rows * ((m + kTile - 1) / kTile);
  return rows < 0 || m < 0 || m >= (1LL << 31) || tiles >= (1LL << 31) ||
         (digit_bits != 1 && digit_bits != 2 && digit_bits != 4 &&
          digit_bits != 8);
}

}  // namespace

// hist[row][p][d] += the count of digit d (bits [p * digit_bits, (p + 1) *
// digit_bits) of the unsigned key) in row `row` of the contiguous (rows, m)
// keys, for every pass p; hist must be zeroed.
extern "C" int radix_onesweep_hist(int key_bytes, const void* keys,
                                   void* hist, long long rows, long long m,
                                   int digit_bits, void* stream) {
  if (bad_shape(rows, m, digit_bits))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (key_bytes) {
    case 1: return launch_hist<uint8_t>(keys, hist, rows, m, digit_bits, s);
    case 2: return launch_hist<uint16_t>(keys, hist, rows, m, digit_bits, s);
    case 4: return launch_hist<uint32_t>(keys, hist, rows, m, digit_bits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Digit pass `pass` of each row: every element to the row's count of
// smaller digits (from hist, (rows, passes, 2^digit_bits) int32) plus its
// stable rank among the row's elements of its digit.  status: rows x
// ceil(m / 4096) x 2^digit_bits look-back words, then one tile counter a
// pass, all zeroed before the first pass of a sort and not touched between
// its passes (a counter that was not zeroed traps: the launch fails).
// vin/vout null -> keys only.
extern "C" int radix_onesweep_pass(int key_bytes, const void* kin,
                                   const void* vin, void* kout, void* vout,
                                   const void* hist, void* status,
                                   long long rows, long long m, int pass,
                                   int digit_bits, void* stream) {
  if (bad_shape(rows, m, digit_bits) || pass < 0 ||
      pass >= key_bytes * 8 / digit_bits)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool kv = vin != nullptr;
#define ONESWEEP_PASS(U)                                                    \
  return kv ? launch_pass<U, true>(kin, vin, kout, vout, hist, status,     \
                                   rows, m, pass, digit_bits, s)           \
            : launch_pass<U, false>(kin, vin, kout, vout, hist, status,    \
                                    rows, m, pass, digit_bits, s)
  switch (key_bytes) {
    case 1: ONESWEEP_PASS(uint8_t);
    case 2: ONESWEEP_PASS(uint16_t);
    case 4: ONESWEEP_PASS(uint32_t);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ONESWEEP_PASS
}

// counts[b] = the number of the n keys (signed carrier order: int8/16/32)
// whose lower bound among the n_split splitters is b, for b in [0,
// n_split], and counts[n_split + 1] = 0 (the reference's pad bin): every
// bin written.  The keys and the splitters must be ascending (a sorted
// shard); n_split + 2 <= 1024.  n == 0 launches nothing and writes
// nothing.
extern "C" int radix_bucket_hist(int key_bytes, const void* keys,
                                 long long n, const void* splitters,
                                 int n_split, void* counts, void* stream) {
  if (n < 0 || n_split < 0 || n_split + 2 > kMaxBucketBins)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (key_bytes) {
    case 1: return launch_bucket_hist<int8_t>(keys, n, splitters, n_split,
                                              counts, s);
    case 2: return launch_bucket_hist<int16_t>(keys, n, splitters, n_split,
                                               counts, s);
    case 4: return launch_bucket_hist<int32_t>(keys, n, splitters, n_split,
                                               counts, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
