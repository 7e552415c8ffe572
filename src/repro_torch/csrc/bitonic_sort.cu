// K1: whole-row Batcher bitonic sort in shared memory.
//
// Replaces the Pallas kernels of src/repro/kernels/bitonic_sort.py:
// sort_blocks (pallas_call at :144, body _apply_network :55-68) and
// sort_kv_blocks (pallas_call at :172, body _apply_network_kv :71-100).
//
// Bound on the H100: the function must read each row once and write it once,
// 2 * rows * n * (key bytes [+ 4 payload bytes]) over 3.35 TB/s of device
// memory; e.g. 65536 rows x 4096 float32 keys = 2 GiB moved, 0.64 ms.  The
// n/2 * log2(n) * (log2(n) + 1) / 2 compare-exchanges per row run out of
// shared memory and registers, off the device-memory path.
//
// Design: one CTA of 1024 threads owns max(n, 2048) elements -- one row, or
// 2048 / n short rows -- loaded once into shared memory and stored once.
// The cap on n comes from shared memory (227 KB a block): with a 4-byte key
// and a 4-byte payload 16384 elements fill 128 KB.
//
// The network itself, and its bit-for-bit semantics, are in bitonic_net.cuh
// (shared with K5's top-k).
#include "bitonic_net.cuh"

namespace {

constexpr int kMinElems = 2048;   // elements a CTA owns at the least

template <typename TR, bool KV>
__global__ void __launch_bounds__(kBitonicThreads)
bitonic_kernel(const typename TR::S* __restrict__ kin,
               const int* __restrict__ vin, typename TR::S* __restrict__ kout,
               int* __restrict__ vout, long long rows, int log_n,
               int rows_per_cta, int descending) {
  typedef typename TR::S S;
  extern __shared__ __align__(16) unsigned char smem[];
  const int elems = rows_per_cta << log_n;
  S* sk = reinterpret_cast<S*>(smem);
  int* sv = reinterpret_cast<int*>(
      smem + ((static_cast<size_t>(elems) * sizeof(S) + 15) / 16) * 16);

  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_cta;
  const long long nrows = min(static_cast<long long>(rows_per_cta),
                              rows - row0);
  const int valid = static_cast<int>(nrows << log_n);
  const long long off = row0 << log_n;

  for (int i = threadIdx.x; i < elems; i += kBitonicThreads) {
    if (i < valid) {
      sk[i] = kin[off + i];
      if (KV) sv[i] = vin[off + i];
    } else {            // rows past the end: sorted, never stored
      sk[i] = S(0);
      if (KV) sv[i] = 0;
    }
  }
  __syncthreads();

  bitonic_network<TR, KV>(sk, sv, elems, log_n, descending);

  for (int i = threadIdx.x; i < valid; i += kBitonicThreads) {
    kout[off + i] = sk[i];
    if (KV) vout[off + i] = sv[i];
  }
}

template <typename TR, bool KV>
int launch(const void* kin, const void* vin, void* kout, void* vout,
           long long rows, int log_n, int descending, cudaStream_t stream) {
  typedef typename TR::S S;
  const int n = 1 << log_n;
  const int rows_per_cta = n >= kMinElems ? 1 : kMinElems / n;
  const size_t elems = static_cast<size_t>(rows_per_cta) * n;
  const size_t smem = bitonic_smem_bytes<S, KV>(elems);
  cudaError_t err = cudaFuncSetAttribute(
      bitonic_kernel<TR, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = (rows + rows_per_cta - 1) / rows_per_cta;
  bitonic_kernel<TR, KV><<<static_cast<unsigned>(grid), kBitonicThreads, smem,
                           stream>>>(
      static_cast<const S*>(kin), static_cast<const int*>(vin),
      static_cast<S*>(kout), static_cast<int*>(vout), rows, log_n,
      rows_per_cta, descending);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Sort each row of a contiguous (rows, 2^log_n) key array; with vin/vout
// non-null the int32 payload rides the composite comparator.  Returns the
// cudaError_t of the launch.
extern "C" int bitonic_sort_blocks(int code, const void* kin, const void* vin,
                                   void* kout, void* vout, long long rows,
                                   int log_n, int descending, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vin != nullptr) {
    KEY_DISPATCH(code, TR,
                 return launch<TR, true>(kin, vin, kout, vout, rows, log_n,
                                         descending, s))
  }
  KEY_DISPATCH(code, TR,
               return launch<TR, false>(kin, vin, kout, vout, rows, log_n,
                                        descending, s))
}
