// K5: per-row top-k by the descending key-value bitonic network.
//
// Replaces the Pallas kernel of src/repro/kernels/bitonic_topk.py:
// topk_blocks (pallas_call at :47, body _topk_kernel :27-33).
//
// Bound on the H100: the function must read each row once and write k keys
// and k int32 indices, rows * (n * key bytes + k * (key bytes + 4)) over
// 3.35 TB/s; e.g. MoE routing, 16384 rows x 64 experts float32 at k = 8,
// moves 5.2 MB, 1.6 us -- a single launch is bound by its own latency.  The
// n/2 * log2(n) * (log2(n) + 1) / 2 compare-exchanges per row run in
// registers.
//
// Design: K1's CTA layout and network (bitonic_reg.cuh), with the lane
// index of every element as its payload: one CTA of max(n, 2048) / E
// threads owns max(n, 2048) elements -- one row, or 2048 / n short rows (32
// router rows of 64 experts), E = 16 consecutive ones a thread (32 for rows
// of 16384).  The key-value
// comparator (key descending, index ascending on ties) makes the network's
// result the unique top-k order of jax.lax.top_k's tie rule under numeric
// comparison (-0.0 == +0.0); only the first k keys and indices of each row
// are written.
#include "bitonic_reg.cuh"

namespace {

constexpr int kMinElems = 2048;   // elements a CTA owns at the least

template <typename TR, int E>
__global__ void __launch_bounds__(512, 1)
topk_kernel(const typename TR::S* __restrict__ kin,
            typename TR::S* __restrict__ kout, int* __restrict__ iout,
            long long rows, int log_n, int rows_per_cta, int k, int vec) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int n = 1 << log_n;
  const int elems = rows_per_cta << log_n;
  uint32_t* sk = smem;
  int* sv = reinterpret_cast<int*>(smem + elems + elems / 32);

  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_cta;
  const int valid = static_cast<int>(
      min(static_cast<long long>(rows_per_cta), rows - row0) << log_n);
  const int base = threadIdx.x * E;

  BitonicLane<TR, true, E> lane;
  lane.desc = true;
  lane.load(kin + (row0 << log_n), nullptr, base, valid, vec != 0);
#pragma unroll
  for (int e = 0; e < E; ++e) lane.v[e] = (base + e) & (n - 1);
  lane.pack_payloads();
  lane.sort(log_n, threadIdx.x, blockDim.x, sk, sv);

  // rows past the end were sorted, never stored; the row's place again,
  // not held in registers through the network
  const long long row1 =
      static_cast<long long>(opaque(blockIdx.x)) * rows_per_cta;
  const int base1 = opaque(threadIdx.x) * E;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = base1 + e, c = i & (n - 1);
    if (c < k && i < valid) {
      const long long o = (row1 + (i >> log_n)) * k + c;
      kout[o] = lane.out_key(e);
      iout[o] = lane.payload(e);
    }
  }
}

template <typename TR, int E>
int launch(const void* kin, void* kout, void* iout, long long rows,
           int log_n, int k, cudaStream_t stream) {
  typedef typename TR::S S;
  const int n = 1 << log_n;
  const int rows_per_cta = n >= kMinElems ? 1 : kMinElems / n;
  const int elems = rows_per_cta * n;
  const size_t smem = bitonic_smem_bytes(elems, log_n, E, true);
  cudaError_t err = cudaFuncSetAttribute(
      topk_kernel<TR, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = (rows + rows_per_cta - 1) / rows_per_cta;
  topk_kernel<TR, E><<<static_cast<unsigned>(grid), elems / E, smem,
                       stream>>>(static_cast<const S*>(kin),
                              static_cast<S*>(kout), static_cast<int*>(iout),
                              rows, log_n, rows_per_cta, k,
                              bitonic_vec_ok(kin, nullptr, nullptr, nullptr));
  return static_cast<int>(cudaGetLastError());
}

template <typename TR>
int launch(const void* kin, void* kout, void* iout, long long rows,
           int log_n, int k, cudaStream_t stream) {
  return bitonic_shape(true, log_n) == kPairs32x512
             ? launch<TR, 32>(kin, kout, iout, rows, log_n, k, stream)
             : launch<TR, 16>(kin, kout, iout, rows, log_n, k, stream);
}

}  // namespace

// Top-k of each row of a contiguous (rows, 2^log_n) key array, 2^log_n <=
// 16384, into contiguous (rows, k) keys and int32 lane indices, descending,
// the lower index first among equal keys; 1 <= k <= 2^log_n.  Returns the
// cudaError_t of the launch.
extern "C" int bitonic_topk_blocks(int code, const void* kin, void* kout,
                                   void* iout, long long rows, int log_n,
                                   int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (log_n < 0 || log_n > 14) return static_cast<int>(cudaErrorInvalidValue);
  KEY_DISPATCH(code, TR,
               return launch<TR>(kin, kout, iout, rows, log_n, k, s))
}
