// K2: stable merge-path merge of row-sorted run pairs, in either direction.
//
// Replaces the Pallas kernel of src/repro/kernels/merge_path.py: _merge_impl
// (pallas_call at :182; entries merge_pairs_blocks :137 and
// merge_pairs_kv_blocks :146; bodies _merge_chunk_kernel /
// _merge_chunk_kv_kernel :76-90 with _window_ranks :47-65), together with the
// diagonal search (_diag_search :97-117) and window gather (:120-125) that
// the reference runs outside the kernel.  A descending comparator replaces
// the flips that src/repro/engine/merge.py merge_pairs (:113-134) puts around
// every descending merge.
//
// Bound on the H100: each input element read once and each output written
// once, 2 * rows * 2L * (key bytes [+ 4 payload bytes]) over 3.35 TB/s;
// e.g. one 2^28-key float32 merge level moves 2 GiB, 0.64 ms.
//
// Design, two launches a merge:
//  * merge_partition_kernel: one thread per tile boundary of an output row
//    binary-searches the merge path's diagonal in device memory and writes
//    the cut (the a-elements before the boundary), rows * (tiles + 1) int32.
//    Every search runs at once, before the merge, so no CTA waits on one.
//  * merge_path_kernel: persistent CTAs of 256 threads walk the tiles of
//    kTile = 4096 outputs.  A tile's a- and b-windows (and payload windows)
//    are copied into shared memory by 16-byte cp.async of the aligned chunks
//    that cover them, two stages deep: the next tile's windows load while
//    this one merges.  A chunk may reach past its window, or past the
//    tensor: an aligned 16-byte chunk that holds a byte of the tensor lies
//    in a mapped page, and validity comes from the window counts alone,
//    never from the bytes around them or from key sentinels.  Each thread
//    searches its sub-diagonal in shared memory and merges its 16 outputs
//    into registers (payloads gathered after, by window position), writes
//    them back into the same stage buffer with one word of padding every 32
//    words (so a warp's stores fall into distinct banks), and the CTA writes
//    the tile out in aligned 16-byte stores, element stores at an unaligned
//    head and tail.
//
// Semantics: `a` wins ties in both directions (ascending takes a[i] when
// a[i] <= b[j], descending when a[i] >= b[j]), so merging two stable runs is
// stable, and the descending merge equals, bit for bit, the reference's
// flip-in / swap / ascending merge / flip-out.  Keys compare numerically
// (-0.0 == +0.0) and keep their bits.
#include "keys.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;    // outputs a tile
constexpr int kStages = 2;                  // tiles in flight a CTA

template <int E>
struct Word;
template <>
struct Word<1> { typedef uint8_t T; };
template <>
struct Word<2> { typedef uint16_t T; };
template <>
struct Word<4> { typedef uint32_t T; };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, uintptr_t src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x, of run a, precedes y, of run b, in the merge: a wins ties both ways
template <typename TR, bool DESC>
__device__ __forceinline__ bool a_first(typename TR::S x, typename TR::S y) {
  return DESC ? !key_lt<TR>(x, y) : !key_lt<TR>(y, x);
}

// number of a-elements among the first d outputs of merge(a, b)
template <typename TR, bool DESC>
__device__ __forceinline__ int diag_search(const typename TR::S* a,
                                           const typename TR::S* b, int la,
                                           int lb, int d) {
  int lo = max(0, d - lb);
  int hi = min(d, la);
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (a_first<TR, DESC>(a[mid - 1], b[d - mid])) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// slot of element p of a tile in the padded shared-memory layout: one
// 4-byte word after every 32 words, so thread t's kItems consecutive
// outputs fall into distinct banks across a warp, and the 16-byte chunks
// the CTA stores stay whole
template <int E>
__host__ __device__ constexpr int padded(int p) {
  return p + (p / (128 / E)) * (4 / E);
}

// bytes of one stage's area of E-byte elements: the windows' 16-byte chunks
// (at most kTile elements and 64 bytes), or the padded output tile shifted
// by up to one chunk
template <int E>
__host__ __device__ constexpr int area_bytes() {
  return ((kTile * E + 64 > padded<E>(kTile + 16 / E) * E
               ? kTile * E + 64
               : padded<E>(kTile + 16 / E) * E) +
          15) / 16 * 16;
}

template <typename S, bool KV>
__host__ __device__ constexpr int stage_bytes() {
  return area_bytes<sizeof(S)>() + (KV ? area_bytes<4>() : 0);
}

// 16-byte chunks that cover [addr, addr + nbytes)
__device__ __forceinline__ int chunks(uintptr_t addr, int nbytes) {
  return nbytes == 0 ? 0
                     : static_cast<int>(((addr + nbytes + 15) >> 4) -
                                        (addr >> 4));
}

// copy the chunks that cover [addr, addr + nbytes) to dst (16-byte
// aligned); the window then starts at dst + (addr & 15)
__device__ __forceinline__ void load_chunks(unsigned char* dst,
                                            uintptr_t addr, int nbytes) {
  const int n = chunks(addr, nbytes);
  const uintptr_t first = addr & ~static_cast<uintptr_t>(15);
  for (int c = threadIdx.x; c < n; c += kThreads) {
    cp_async16(dst + 16 * c, first + 16 * static_cast<uintptr_t>(c));
  }
}

template <typename S>
struct Args {
  const S* a;
  long long sa;
  const S* b;
  long long sb;
  const int* va;
  long long sva;
  const int* vb;
  long long svb;
  S* out;
  int* vout;
  const int* cuts;      // (rows, tpr + 1) from merge_partition_kernel
  long long rows;
  int L;
  int tpr;              // tiles a row
};

// the cuts that bound tile g: the a-elements before its first output and
// after its last (0, 0 past the last tile)
template <typename S>
__device__ __forceinline__ int2 cuts_of(const Args<S>& p, long long g) {
  if (g >= p.rows * p.tpr) return make_int2(0, 0);
  const long long row = g / p.tpr;
  const int* c = p.cuts + row * (p.tpr + 1) + (g - row * p.tpr);
  return make_int2(c[0], c[1]);
}

// one tile: its row, first output, output count (0 past the last tile)
// and its a- and b-windows
struct Tile {
  long long row;
  int d0, count, a0, na, b0, nb;
};

template <typename S>
__device__ __forceinline__ Tile tile_at(const Args<S>& p, long long g,
                                        int2 c) {
  Tile t = {0, 0, 0, 0, 0, 0, 0};
  if (g < p.rows * p.tpr) {
    t.row = g / p.tpr;
    t.d0 = static_cast<int>(g - t.row * p.tpr) * kTile;
    t.count = min(kTile, 2 * p.L - t.d0);
    t.a0 = c.x;
    t.na = c.y - c.x;
    t.b0 = t.d0 - t.a0;
    t.nb = t.count - t.na;
  }
  return t;
}

// the addresses of a tile's four windows and two outputs
template <typename S>
struct Spans {
  uintptr_t a, b, va, vb, out, vout;
};

template <typename S, bool KV>
__device__ __forceinline__ Spans<S> spans(const Args<S>& p, const Tile& t) {
  Spans<S> s;
  s.a = reinterpret_cast<uintptr_t>(p.a + t.row * p.sa + t.a0);
  s.b = reinterpret_cast<uintptr_t>(p.b + t.row * p.sb + t.b0);
  s.out = reinterpret_cast<uintptr_t>(p.out + t.row * 2 * p.L + t.d0);
  s.va = s.vb = s.vout = 0;
  if (KV) {
    s.va = reinterpret_cast<uintptr_t>(p.va + t.row * p.sva + t.a0);
    s.vb = reinterpret_cast<uintptr_t>(p.vb + t.row * p.svb + t.b0);
    s.vout = reinterpret_cast<uintptr_t>(p.vout + t.row * 2 * p.L + t.d0);
  }
  return s;
}

template <typename S, bool KV>
__device__ __forceinline__ void issue(const Args<S>& p, const Tile& t,
                                      unsigned char* stage) {
  constexpr int E = sizeof(S);
  if (t.count == 0) return;
  const Spans<S> s = spans<S, KV>(p, t);
  load_chunks(stage, s.a, t.na * E);
  load_chunks(stage + 16 * chunks(s.a, t.na * E), s.b, t.nb * E);
  if (KV) {
    unsigned char* vs = stage + area_bytes<E>();
    load_chunks(vs, s.va, t.na * 4);
    load_chunks(vs + 16 * chunks(s.va, t.na * 4), s.vb, t.nb * 4);
  }
}

// write `count` E-byte elements, held at padded(h + i) of `area`, to
// dst + i, where h is dst's offset in elements from its 16-byte chunk
template <int E>
__device__ __forceinline__ void store_tile(const unsigned char* area,
                                           int count, uintptr_t dst) {
  typedef typename Word<E>::T W;
  constexpr int kVec = 16 / E;
  const int h = static_cast<int>(dst & 15) / E;
  const uintptr_t base = dst & ~static_cast<uintptr_t>(15);
  const int end = h + count;
  const int n = (end + kVec - 1) / kVec;
  for (int c = threadIdx.x; c < n; c += kThreads) {
    const int p0 = c * kVec;
    if (p0 >= h && p0 + kVec <= end) {
      const uint32_t* w =
          reinterpret_cast<const uint32_t*>(area + padded<E>(p0) * E);
      *reinterpret_cast<uint4*>(base + 16 * static_cast<uintptr_t>(c)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      for (int q = max(p0, h); q < min(p0 + kVec, end); ++q) {
        *reinterpret_cast<W*>(base + static_cast<uintptr_t>(q) * E) =
            *reinterpret_cast<const W*>(area + padded<E>(q) * E);
      }
    }
  }
}

// CTAs an SM the register budget aims at: 4 key-only (64 registers), 3
// key-value (80); ptxas spills the 2-byte key-value merges at 80, so those
// take 2 (128)
template <typename S, bool KV>
__host__ __device__ constexpr int min_ctas() {
  return KV ? (sizeof(S) == 2 ? 2 : 3) : 4;
}

template <typename TR, bool KV, bool DESC>
__global__ void __launch_bounds__(kThreads,
                                  (min_ctas<typename TR::S, KV>()))
merge_path_kernel(const Args<typename TR::S> p) {
  typedef typename TR::S S;
  constexpr int E = sizeof(S);
  constexpr int kStage = stage_bytes<S, KV>();
  extern __shared__ __align__(16) unsigned char smem[];

  const long long ntiles = p.rows * p.tpr;
  const long long step = gridDim.x;
  long long g = blockIdx.x;
  // only the cuts of the tiles in flight stay in registers, oldest first
  int2 cq[kStages];
#pragma unroll
  for (int q = 0; q < kStages; ++q) {
    cq[q] = cuts_of(p, g + q * step);
    issue<S, KV>(p, tile_at(p, g + q * step, cq[q]), smem + q * kStage);
    cp_async_commit();
  }
  int s = 0;
  for (; g < ntiles; g += step) {
    // the cuts of the tile this stage loads next, read ahead of their use
    const int2 c_after = cuts_of(p, g + kStages * step);
    const Tile cur = tile_at(p, g, cq[0]);
    unsigned char* st = smem + s * kStage;
    unsigned char* vst = st + area_bytes<E>();
    // the windows' places in the stage and the outputs' offsets from
    // their 16-byte chunks: small ints, not the tile's six addresses
    int oa, ob, wva, wvb, ho, hvo;
    {
      const Spans<S> sp = spans<S, KV>(p, cur);
      oa = static_cast<int>(sp.a & 15);
      ob = 16 * chunks(sp.a, cur.na * E) + static_cast<int>(sp.b & 15);
      // payload windows, in int32 words of the payload area
      wva = static_cast<int>(sp.va & 15) / 4;
      wvb = KV ? (16 * chunks(sp.va, cur.na * 4) +
                  static_cast<int>(sp.vb & 15)) / 4
               : 0;
      ho = static_cast<int>(sp.out & 15) / E;
      hvo = static_cast<int>(sp.vout & 15) / 4;
    }
    cp_async_wait<kStages - 1>();
    __syncthreads();

    const S* wa = reinterpret_cast<const S*>(st + oa);
    const S* wb = reinterpret_cast<const S*>(st + ob);
    const int dt = threadIdx.x * kItems;
    const int mine = min(kItems, cur.count - dt);
    S k[kItems];
    int v[kItems];
    if (mine > 0) {
      int i = diag_search<TR, DESC>(wa, wb, cur.na, cur.nb, dt);
      int j = dt - i;
      // i <= na and j <= nb: a read one past a window stays in the stage
      S x = wa[i];
      S y = wb[j];
#pragma unroll
      for (int e = 0; e < kItems; ++e) {
        if (e < mine) {
          const bool take_a =
              j >= cur.nb || (i < cur.na && a_first<TR, DESC>(x, y));
          k[e] = take_a ? x : y;
          v[e] = take_a ? wva + i : wvb + j;
          if (take_a) {
            x = wa[++i];
          } else {
            y = wb[++j];
          }
        }
      }
      if (KV) {
        const int* pw = reinterpret_cast<const int*>(vst);
#pragma unroll
        for (int e = 0; e < kItems; ++e) {
          if (e < mine) v[e] = pw[v[e]];
        }
      }
    }
    __syncthreads();    // every window read: the stage takes the outputs

    if (mine > 0) {
      S* ko = reinterpret_cast<S*>(st);
      const int h = ho + dt;
#pragma unroll
      for (int e = 0; e < kItems; ++e) {
        if (e < mine) ko[padded<E>(h + e)] = k[e];
      }
      if (KV) {
        int* vo = reinterpret_cast<int*>(vst);
        const int hv = hvo + dt;
#pragma unroll
        for (int e = 0; e < kItems; ++e) {
          if (e < mine) vo[padded<4>(hv + e)] = v[e];
        }
      }
    }
    __syncthreads();
    if (cur.count > 0) {
      const Spans<S> so = spans<S, KV>(p, cur);
      store_tile<E>(st, cur.count, so.out);
      if (KV) store_tile<4>(vst, cur.count, so.vout);
    }
    __syncthreads();    // the stage is free for the tile kStages on

    issue<S, KV>(p, tile_at(p, g + kStages * step, c_after), st);
    cp_async_commit();
#pragma unroll
    for (int q = 0; q + 1 < kStages; ++q) cq[q] = cq[q + 1];
    cq[kStages - 1] = c_after;
    s = s + 1 == kStages ? 0 : s + 1;
  }
}

template <typename TR, bool DESC>
__global__ void __launch_bounds__(kThreads)
merge_partition_kernel(const typename TR::S* __restrict__ a, long long sa,
                       const typename TR::S* __restrict__ b, long long sb,
                       int* __restrict__ cuts, long long n_cuts, int L,
                       int tpr) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n_cuts) return;
  const long long row = i / (tpr + 1);
  const int t = static_cast<int>(i - row * (tpr + 1));
  const int d = static_cast<int>(
      min(static_cast<long long>(t) * kTile, 2LL * L));
  cuts[i] = diag_search<TR, DESC>(a + row * sa, b + row * sb, L, L, d);
}

template <typename TR, bool DESC>
int launch_partition(const void* a, long long sa, const void* b,
                     long long sb, int* cuts, long long rows, int L,
                     cudaStream_t stream) {
  typedef typename TR::S S;
  const int tpr = static_cast<int>((2LL * L + kTile - 1) / kTile);
  const long long n_cuts = rows * (tpr + 1);
  const long long grid = (n_cuts + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  merge_partition_kernel<TR, DESC><<<static_cast<unsigned>(grid), kThreads,
                                     0, stream>>>(
      static_cast<const S*>(a), sa, static_cast<const S*>(b), sb, cuts,
      n_cuts, L, tpr);
  return static_cast<int>(cudaGetLastError());
}

template <typename TR, bool KV, bool DESC>
int launch_merge(const Args<typename TR::S>& p, cudaStream_t stream) {
  typedef typename TR::S S;
  constexpr int smem = kStages * stage_bytes<S, KV>();
  auto kernel = merge_path_kernel<TR, KV, DESC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent: as many CTAs as the card holds at once, at most a tile each
  const long long ntiles = p.rows * p.tpr;
  const long long cap = static_cast<long long>(per_sm > 1 ? per_sm : 1) * sms;
  const long long grid = ntiles < cap ? ntiles : cap;
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename TR, bool KV>
int launch(const Args<typename TR::S>& p, int descending,
           cudaStream_t stream) {
  return descending ? launch_merge<TR, KV, true>(p, stream)
                    : launch_merge<TR, KV, false>(p, stream);
}

template <typename TR>
Args<typename TR::S> args(const void* a, long long sa, const void* b,
                          long long sb, const void* va, long long sva,
                          const void* vb, long long svb, void* out,
                          void* vout, const int* cuts, long long rows,
                          int L) {
  typedef typename TR::S S;
  Args<S> p;
  p.a = static_cast<const S*>(a);
  p.sa = sa;
  p.b = static_cast<const S*>(b);
  p.sb = sb;
  p.va = static_cast<const int*>(va);
  p.sva = sva;
  p.vb = static_cast<const int*>(vb);
  p.svb = svb;
  p.out = static_cast<S*>(out);
  p.vout = static_cast<int*>(vout);
  p.cuts = cuts;
  p.rows = rows;
  p.L = L;
  p.tpr = static_cast<int>((2LL * L + kTile - 1) / kTile);
  return p;
}

}  // namespace

// cuts[r * (tiles + 1) + t] = the number of a-elements among the first
// min(t * tile, 2L) outputs of merge(a[r], b[r]), tiles = ceil(2L / tile),
// for rows r of a (row stride sa elements) and b (stride sb), both of
// length L and sorted in the merge's direction; `tile` must be the merge
// kernel's.  Returns the cudaError_t of the launch.
extern "C" int merge_path_partition(int code, const void* a, long long sa,
                                    const void* b, long long sb, int* cuts,
                                    long long rows, int L, int tile,
                                    int descending, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile != kTile || L < 1 || rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (descending) {
    KEY_DISPATCH(code, TR,
                 return launch_partition<TR, true>(a, sa, b, sb, cuts, rows,
                                                   L, s))
  }
  KEY_DISPATCH(code, TR,
               return launch_partition<TR, false>(a, sa, b, sb, cuts, rows,
                                                  L, s))
}

// Merge row r of a (row stride sa elements) with row r of b (stride sb),
// both of length L and sorted ascending (descending when `descending`),
// into row r of the contiguous (rows, 2L) output, a first on ties, along
// the cuts of merge_path_partition.  With va/vb non-null the int32
// payloads (row strides sva/svb) follow their keys into vout.  Returns the
// cudaError_t of the launch.
extern "C" int merge_pairs_blocks(int code, const void* a, long long sa,
                                  const void* b, long long sb, const void* va,
                                  long long sva, const void* vb,
                                  long long svb, void* out, void* vout,
                                  const int* cuts, long long rows, int L,
                                  int tile, int descending, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile != kTile || L < 1 || rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (va != nullptr) {
    KEY_DISPATCH(code, TR,
                 return launch<TR, true>(
                     args<TR>(a, sa, b, sb, va, sva, vb, svb, out, vout, cuts,
                              rows, L),
                     descending, s))
  }
  KEY_DISPATCH(code, TR,
               return launch<TR, false>(
                   args<TR>(a, sa, b, sb, va, sva, vb, svb, out, vout, cuts,
                            rows, L),
                   descending, s))
}
