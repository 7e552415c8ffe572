// K2: stable merge-path merge of row-sorted run pairs.
//
// Replaces the Pallas kernel of src/repro/kernels/merge_path.py: _merge_impl
// (pallas_call at :182; entries merge_pairs_blocks :137 and
// merge_pairs_kv_blocks :146; bodies _merge_chunk_kernel /
// _merge_chunk_kv_kernel :76-90 with _window_ranks :47-65), together with the
// diagonal search (_diag_search :97-117) and window gather (:120-125) that
// the reference runs outside the kernel.
//
// Bound on the H100: each input element read once and each output written
// once, 2 * rows * 2L * (key bytes [+ 4 payload bytes]) over 3.35 TB/s;
// e.g. one 2^28-key float32 merge level moves 2 GiB, 0.64 ms.
//
// Design: a CTA of 256 threads owns 2048 consecutive outputs of one row.
// Two threads binary-search the merge path at the tile's first and last
// diagonal in device memory; the CTA then loads exactly the a- and b-windows
// those cuts bound (together 2048 elements) into shared memory with coalesced
// reads.  Each thread searches its own sub-diagonal inside shared memory and
// merges 8 outputs sequentially; the tile is written back coalesced.  The
// reference's C x C rank matrix and one-hot placement are vector-unit idioms
// and are not carried over.
//
// Semantics: ascending, `a` wins ties (a[i] <= b[j] takes a[i]), so merging
// two stable runs is stable.  Validity comes from the window counts, never
// from key sentinels: the engine's runs end in sentinels that can equal
// genuine keys.
#include "keys.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;

// number of a-elements among the first d outputs of merge(a, b)
template <typename TR>
__device__ int diag_search(const typename TR::S* a, const typename TR::S* b,
                           int la, int lb, int d) {
  int lo = max(0, d - lb);
  int hi = min(d, la);
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (!key_lt<TR>(b[d - mid], a[mid - 1])) {   // a[mid-1] <= b[d-mid]
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

template <typename TR, bool KV>
__global__ void __launch_bounds__(kThreads)
merge_path_kernel(const typename TR::S* __restrict__ a, long long sa,
                  const typename TR::S* __restrict__ b, long long sb,
                  const int* __restrict__ va, long long sva,
                  const int* __restrict__ vb, long long svb,
                  typename TR::S* __restrict__ out, int* __restrict__ vout,
                  int L, int tiles_per_row) {
  typedef typename TR::S S;
  __shared__ S s_in[kTile];
  __shared__ S s_out[kTile];
  __shared__ int sv_in[KV ? kTile : 1];
  __shared__ int sv_out[KV ? kTile : 1];
  __shared__ int split[2];

  const long long row = blockIdx.x / tiles_per_row;
  const int tile = blockIdx.x % tiles_per_row;
  const S* ar = a + row * sa;
  const S* br = b + row * sb;
  const int total = 2 * L;
  const int d0 = tile * kTile;
  const int d1 = min(d0 + kTile, total);
  if (threadIdx.x < 2) {
    split[threadIdx.x] =
        diag_search<TR>(ar, br, L, L, threadIdx.x == 0 ? d0 : d1);
  }
  __syncthreads();
  const int a0 = split[0], b0 = d0 - a0;
  const int na = split[1] - a0, nb = (d1 - split[1]) - b0;
  for (int i = threadIdx.x; i < na; i += kThreads) {
    s_in[i] = ar[a0 + i];
    if (KV) sv_in[i] = va[row * sva + a0 + i];
  }
  for (int i = threadIdx.x; i < nb; i += kThreads) {
    s_in[na + i] = br[b0 + i];
    if (KV) sv_in[na + i] = vb[row * svb + b0 + i];
  }
  __syncthreads();

  const S* wa = s_in;
  const S* wb = s_in + na;
  const int count = d1 - d0;
  const int dt = threadIdx.x * kItems;
  if (dt < count) {
    int i = diag_search<TR>(wa, wb, na, nb, dt);
    int j = dt - i;
    for (int e = 0; e < kItems && dt + e < count; ++e) {
      const bool take_a = j >= nb || (i < na && !key_lt<TR>(wb[j], wa[i]));
      if (take_a) {
        s_out[dt + e] = wa[i];
        if (KV) sv_out[dt + e] = sv_in[i];
        ++i;
      } else {
        s_out[dt + e] = wb[j];
        if (KV) sv_out[dt + e] = sv_in[na + j];
        ++j;
      }
    }
  }
  __syncthreads();

  const long long obase = row * total + d0;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    out[obase + i] = s_out[i];
    if (KV) vout[obase + i] = sv_out[i];
  }
}

template <typename TR, bool KV>
int launch(const void* a, long long sa, const void* b, long long sb,
           const void* va, long long sva, const void* vb, long long svb,
           void* out, void* vout, long long rows, int L,
           cudaStream_t stream) {
  typedef typename TR::S S;
  const int tiles_per_row = (2 * L + kTile - 1) / kTile;
  const long long grid = rows * tiles_per_row;
  merge_path_kernel<TR, KV><<<static_cast<unsigned>(grid), kThreads, 0,
                              stream>>>(
      static_cast<const S*>(a), sa, static_cast<const S*>(b), sb,
      static_cast<const int*>(va), sva, static_cast<const int*>(vb), svb,
      static_cast<S*>(out), static_cast<int*>(vout), L, tiles_per_row);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Merge row r of a (row stride sa elements) with row r of b (stride sb),
// both ascending and of length L, into row r of the contiguous (rows, 2L)
// output.  With va/vb non-null the int32 payloads (row strides sva/svb)
// follow their keys into vout.  Returns the cudaError_t of the launch.
extern "C" int merge_pairs_blocks(int code, const void* a, long long sa,
                                  const void* b, long long sb, const void* va,
                                  long long sva, const void* vb,
                                  long long svb, void* out, void* vout,
                                  long long rows, int L, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (va != nullptr) {
    KEY_DISPATCH(code, TR,
                 return launch<TR, true>(a, sa, b, sb, va, sva, vb, svb, out,
                                         vout, rows, L, s))
  }
  KEY_DISPATCH(code, TR,
               return launch<TR, false>(a, sa, b, sb, va, sva, vb, svb, out,
                                        vout, rows, L, s))
}
