// The bitonic network of K1, shared by the whole-row sort (bitonic_sort.cu)
// and the top-k (bitonic_topk.cu).
//
// One CTA of kBitonicThreads threads sorts `elems` keys (and int32 payloads
// when KV) held in shared memory: elems / 2^log_n rows of 2^log_n each.
// Substages with partner distance j >= 32 exchange through shared memory,
// one pair per thread per step; the substages with j < 32 of every stage run
// in registers with warp shuffles (a warp holds 32 consecutive elements).
//
// Semantics are those of the reference network, bit for bit:
//  * key-only: a chunk flagged descending takes (max, min), else (min, max),
//    with XLA's min/max on floats (the minimum of -0.0 and +0.0 is -0.0);
//  * key-value: the comparator is the composite (key in the requested
//    direction, payload ascending on ties); the requested direction lives in
//    the comparator and the chunk direction is XOR'd in.
// The caller synchronises after filling shared memory; the network ends
// with a barrier, so the caller may read the result straight away.
#pragma once

#include "keys.cuh"

constexpr int kBitonicThreads = 1024;

template <typename TR, bool KV>
__device__ __forceinline__ void bitonic_network(typename TR::S* sk, int* sv,
                                                int elems, int log_n,
                                                int descending) {
  typedef typename TR::S S;
  const int n = 1 << log_n;
  for (int k = 2; k <= n; k <<= 1) {
    int j = k >> 1;
    for (; j >= 32; j >>= 1) {
      for (int p = threadIdx.x; p < (elems >> 1); p += kBitonicThreads) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const bool rev = ((i & (n - 1)) & k) != 0;
        S a = sk[i], b = sk[i + j];
        if (KV) {
          const int va = sv[i], vb = sv[i + j];
          const bool kf = descending ? key_lt<TR>(b, a) : key_lt<TR>(a, b);
          const bool tie = !key_lt<TR>(a, b) && !key_lt<TR>(b, a);
          const bool a_first = (kf || (tie && va < vb)) != rev;
          if (!a_first) {
            sk[i] = b; sk[i + j] = a;
            sv[i] = vb; sv[i + j] = va;
          }
        } else {
          const bool d = rev != (descending != 0);
          sk[i] = d ? key_max<TR>(a, b) : key_min<TR>(a, b);
          sk[i + j] = d ? key_min<TR>(a, b) : key_max<TR>(a, b);
        }
      }
      __syncthreads();
    }
    // substages j < 32: the partner e ^ jj sits in the same warp
    for (int e = threadIdx.x; e < elems; e += kBitonicThreads) {
      S key = sk[e];
      int val = KV ? sv[e] : 0;
      const bool rev = ((e & (n - 1)) & k) != 0;
      for (int jj = j; jj >= 1; jj >>= 1) {
        const S pk = shfl_xor(key, jj);
        const int pv = KV ? __shfl_xor_sync(0xffffffffu, val, jj) : 0;
        const bool lower = (e & jj) == 0;
        const S a = lower ? key : pk, b = lower ? pk : key;
        if (KV) {
          const int va = lower ? val : pv, vb = lower ? pv : val;
          const bool kf = descending ? key_lt<TR>(b, a) : key_lt<TR>(a, b);
          const bool tie = !key_lt<TR>(a, b) && !key_lt<TR>(b, a);
          const bool a_first = (kf || (tie && va < vb)) != rev;
          // the lower slot takes the first element, the upper the second
          const bool take_a = a_first == lower;
          key = take_a ? a : b;
          val = take_a ? va : vb;
        } else {
          const bool d = rev != (descending != 0);
          const S first = d ? key_max<TR>(a, b) : key_min<TR>(a, b);
          const S second = d ? key_min<TR>(a, b) : key_max<TR>(a, b);
          key = lower ? first : second;
        }
      }
      sk[e] = key;
      if (KV) sv[e] = val;
    }
    __syncthreads();
  }
}

// Dynamic shared memory of a CTA holding `elems` keys of S (16-byte
// aligned) followed, when KV, by as many int32 payloads.
template <typename S, bool KV>
inline size_t bitonic_smem_bytes(size_t elems) {
  return ((elems * sizeof(S) + 15) / 16) * 16 + (KV ? elems * sizeof(int) : 0);
}
