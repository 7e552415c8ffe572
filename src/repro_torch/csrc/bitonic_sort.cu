// K1: whole-row Batcher bitonic sort, the row in registers.
//
// Replaces the Pallas kernels of src/repro/kernels/bitonic_sort.py:
// sort_blocks (pallas_call at :144, body _apply_network :55-68) and
// sort_kv_blocks (pallas_call at :172, body _apply_network_kv :71-100).
//
// Bound on the H100: the function must read each row once and write it once,
// 2 * rows * n * (key bytes [+ 4 payload bytes]) over 3.35 TB/s of device
// memory; e.g. 65536 rows x 4096 float32 keys = 2 GiB moved, 0.64 ms.  The
// n/2 * log2(n) * (log2(n) + 1) / 2 compare-exchanges a row are the other
// bound: at 4096 keys 78 a key, each a few integer instructions, so the
// ALU pipe bounds a wide sort as much as the bytes do.
//
// Design: one CTA of max(n, 2048) / E threads owns max(n, 2048) elements
// -- one row, or 2048 / n short rows -- E = 16 consecutive elements a
// thread (32 for key-value rows of 16384), loaded and stored once as
// 16-byte vectors; the network runs in registers, in warp shuffles and,
// for partner distances of 512 and more, in a few shared-memory round
// trips (bitonic_reg.cuh, shared with K5's top-k).  The cap on n comes from
// the 1024 threads a CTA may have: 16384 elements.
#include "bitonic_reg.cuh"

namespace {

constexpr int kMinElems = 2048;   // elements a CTA owns at the least

template <typename TR, bool KV, int E, int T>
__global__ void __launch_bounds__(T, 1)
bitonic_kernel(const typename TR::S* __restrict__ kin,
               const int* __restrict__ vin, typename TR::S* __restrict__ kout,
               int* __restrict__ vout, long long rows, int log_n,
               int rows_per_cta, int descending, int vec) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int elems = rows_per_cta << log_n;
  uint32_t* sk = smem;
  int* sv = reinterpret_cast<int*>(smem + elems + elems / 32);

  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_cta;
  const int valid = static_cast<int>(
      min(static_cast<long long>(rows_per_cta), rows - row0) << log_n);
  const long long off = row0 << log_n;
  const int base = threadIdx.x * E;

  BitonicLane<TR, KV, E> lane;
  lane.desc = descending != 0;
  lane.load(kin + off, KV ? vin + off : nullptr, base, valid, vec != 0);
  lane.sort(log_n, threadIdx.x, blockDim.x, sk, sv);
  // the row's place again, not held in registers through the network
  const long long row1 =
      static_cast<long long>(opaque(blockIdx.x)) * rows_per_cta;
  const long long off1 = row1 << log_n;
  const int valid1 = static_cast<int>(
      min(static_cast<long long>(rows_per_cta), rows - row1) << log_n);
  lane.store(kout + off1, KV ? vout + off1 : nullptr,
             opaque(threadIdx.x) * E, valid1, vec != 0);
}

template <typename TR, bool KV, int E, int T>
int launch(const void* kin, const void* vin, void* kout, void* vout,
           long long rows, int log_n, int descending, cudaStream_t stream) {
  typedef typename TR::S S;
  const int n = 1 << log_n;
  const int rows_per_cta = n >= kMinElems ? 1 : kMinElems / n;
  const int elems = rows_per_cta * n;
  const size_t smem = bitonic_smem_bytes(elems, log_n, E, KV);
  cudaError_t err = cudaFuncSetAttribute(
      bitonic_kernel<TR, KV, E, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = (rows + rows_per_cta - 1) / rows_per_cta;
  bitonic_kernel<TR, KV, E, T><<<static_cast<unsigned>(grid), elems / E,
                                 smem, stream>>>(
      static_cast<const S*>(kin), static_cast<const int*>(vin),
      static_cast<S*>(kout), static_cast<int*>(vout), rows, log_n,
      rows_per_cta, descending, bitonic_vec_ok(kin, vin, kout, vout));
  return static_cast<int>(cudaGetLastError());
}

// the shapes of bitonic_shape, and no other instantiated
template <typename TR, bool KV>
int launch(const void* kin, const void* vin, void* kout, void* vout,
           long long rows, int log_n, int descending, cudaStream_t stream) {
  if constexpr (!KV)
    return launch<TR, false, 16, 1024>(kin, vin, kout, vout, rows, log_n,
                                       descending, stream);
  else if (bitonic_shape(true, log_n) == kPairs16x512)
    return launch<TR, true, 16, 512>(kin, vin, kout, vout, rows, log_n,
                                     descending, stream);
  else
    return launch<TR, true, 32, 512>(kin, vin, kout, vout, rows, log_n,
                                     descending, stream);
}

}  // namespace

// Sort each row of a contiguous (rows, 2^log_n) key array, 2^log_n <=
// 16384; with vin/vout non-null the int32 payload rides the composite
// comparator.  Returns the cudaError_t of the launch.
extern "C" int bitonic_sort_blocks(int code, const void* kin, const void* vin,
                                   void* kout, void* vout, long long rows,
                                   int log_n, int descending, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (log_n < 0 || log_n > 14) return static_cast<int>(cudaErrorInvalidValue);
  if (vin != nullptr) {
    KEY_DISPATCH(code, TR,
                 return launch<TR, true>(kin, vin, kout, vout, rows, log_n,
                                         descending, s))
  }
  KEY_DISPATCH(code, TR,
               return launch<TR, false>(kin, vin, kout, vout, rows, log_n,
                                        descending, s))
}
