// K5: per-row top-k by the descending key-value bitonic network.
//
// Replaces the Pallas kernel of src/repro/kernels/bitonic_topk.py:
// topk_blocks (pallas_call at :47, body _topk_kernel :27-33).
//
// Bound on the H100: the function must read each row once and write k keys
// and k int32 indices, rows * (n * key bytes + k * (key bytes + 4)) over
// 3.35 TB/s; e.g. MoE routing, 16384 rows x 64 experts float32 at k = 8,
// moves 5.2 MB, 1.6 us -- a single launch is bound by its own latency.  The
// n/2 * log2(n) * (log2(n) + 1) / 2 compare-exchanges per row run out of
// shared memory and registers.
//
// Design: K1's CTA layout and network (bitonic_net.cuh), with the lane
// index of every element as its payload: one CTA of 1024 threads owns
// max(n, 2048) elements -- one row, or 2048 / n short rows (32 router rows
// of 64 experts).  The key-value comparator (key descending, index
// ascending on ties) makes the network's result the unique top-k order of
// jax.lax.top_k's tie rule under numeric comparison (-0.0 == +0.0); only the
// first k keys and indices of each row are written.
#include "bitonic_net.cuh"

namespace {

constexpr int kMinElems = 2048;   // elements a CTA owns at the least

template <typename TR>
__global__ void __launch_bounds__(kBitonicThreads)
topk_kernel(const typename TR::S* __restrict__ kin,
            typename TR::S* __restrict__ kout, int* __restrict__ iout,
            long long rows, int log_n, int rows_per_cta, int k) {
  typedef typename TR::S S;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = 1 << log_n;
  const int elems = rows_per_cta << log_n;
  S* sk = reinterpret_cast<S*>(smem);
  int* sv = reinterpret_cast<int*>(
      smem + ((static_cast<size_t>(elems) * sizeof(S) + 15) / 16) * 16);

  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_cta;
  const int nrows = static_cast<int>(
      min(static_cast<long long>(rows_per_cta), rows - row0));
  const int valid = nrows << log_n;
  const long long off = row0 << log_n;

  for (int i = threadIdx.x; i < elems; i += kBitonicThreads) {
    sk[i] = i < valid ? kin[off + i] : S(0);   // rows past the end: never
    sv[i] = i & (n - 1);                       // stored
  }
  __syncthreads();

  bitonic_network<TR, true>(sk, sv, elems, log_n, /*descending=*/1);

  const long long out = row0 * k;
  for (int i = threadIdx.x; i < nrows * k; i += kBitonicThreads) {
    const int r = i / k, c = i - r * k;
    kout[out + i] = sk[(r << log_n) + c];
    iout[out + i] = sv[(r << log_n) + c];
  }
}

template <typename TR>
int launch(const void* kin, void* kout, void* iout, long long rows,
           int log_n, int k, cudaStream_t stream) {
  typedef typename TR::S S;
  const int n = 1 << log_n;
  const int rows_per_cta = n >= kMinElems ? 1 : kMinElems / n;
  const size_t smem = bitonic_smem_bytes<S, true>(
      static_cast<size_t>(rows_per_cta) * n);
  cudaError_t err = cudaFuncSetAttribute(
      topk_kernel<TR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = (rows + rows_per_cta - 1) / rows_per_cta;
  topk_kernel<TR><<<static_cast<unsigned>(grid), kBitonicThreads, smem,
                    stream>>>(static_cast<const S*>(kin),
                              static_cast<S*>(kout), static_cast<int*>(iout),
                              rows, log_n, rows_per_cta, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Top-k of each row of a contiguous (rows, 2^log_n) key array into
// contiguous (rows, k) keys and int32 lane indices, descending, the lower
// index first among equal keys; 1 <= k <= 2^log_n.  Returns the cudaError_t
// of the launch.
extern "C" int bitonic_topk_blocks(int code, const void* kin, void* kout,
                                   void* iout, long long rows, int log_n,
                                   int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  KEY_DISPATCH(code, TR,
               return launch<TR>(kin, kout, iout, rows, log_n, k, s))
}
