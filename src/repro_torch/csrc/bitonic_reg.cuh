// The bitonic network of K1, held in registers; shared by the whole-row
// sort (bitonic_sort.cu) and the top-k (bitonic_topk.cu).
//
// A CTA of elems / E threads sorts `elems` keys (and int32 payloads when
// KV): elems / 2^log_n rows of 2^log_n each.  Thread t holds the E
// consecutive elements t E .. t E + E - 1 in registers, loaded and stored
// as 16-byte vectors: E = 16, but 32 for key-value rows of 16384, whose
// 16 keys and 16 payloads a thread would not fit the 64 registers of a
// 1024-thread CTA (bitonic_shape).  Of the substages of stage k (partner
// distance j = k/2 .. 1):
//   * j < E runs inside the thread, unrolled, with no shuffle or barrier;
//   * E <= j < 32 E runs through warp shuffles (the partner element sits
//     at the same register of lane t ^ j / E), at E = 16;
//   * the longer ones (at E = 32 every j >= E: its shuffles would not fit
//     128 registers) go through shared memory, up to log2(E) substages a
//     round trip: each thread gathers groups of 2^r elements closed under r
//     consecutive substages, runs them in registers and scatters them back.
//     Shared words are padded (one word every 32), so both the home layout
//     (E consecutive words a thread) and the groups (consecutive lanes on
//     consecutive words) are free of bank conflicts.
// A row of 4096 keys takes 3 such rounds (9 barriers), 16384 keys 6 (13 for
// key-value rows, E = 32).
//
// Semantics are those of the reference network, bit for bit:
//  * key-only: a chunk flagged descending takes (max, min), else (min,
//    max), with XLA's min/max on floats (the minimum of -0.0 and +0.0 is
//    -0.0).  Keys are held as order-preserving signed codes (-0.0 just
//    below +0.0; complemented for a descending sort), so XLA's min/max is
//    the integer min/max;
//  * key-value: the comparator is the composite (key in the requested
//    direction, payload ascending on ties), keys compared by value (-0.0
//    == +0.0); the requested direction lives in the comparator and the
//    chunk direction is XOR'd in.  Integer keys and their payloads ride
//    as one unsigned 64-bit value (the key's code, complemented for
//    descending, above the payload), whose order is the composite's and
//    whose equal values are equal bits, so a compare-exchange is a 64-bit
//    min and max.
#pragma once

#include <type_traits>

#include "keys.cuh"

// The kernel shapes: E elements a thread, at most T threads a CTA, so
// 65536 / T registers a thread, given as __launch_bounds__(T, 1) (without
// the 1 ptxas aims at two CTAs an SM, and spills).  Key-only rows: 16
// keys in at most 1024 threads (64 registers); key-value rows up to 8192:
// 16 in at most 512 (128 registers); key-value rows of 16384: 32 in 512.
enum BitonicShape { kKeys16x1024, kPairs16x512, kPairs32x512 };
inline BitonicShape bitonic_shape(bool kv, int log_n) {
  return !kv ? kKeys16x1024 : log_n >= 14 ? kPairs32x512 : kPairs16x512;
}

// log2 of E, and of the shortest partner distance that goes through shared
// memory (at E = 16 the 32 x 16 elements of a warp shuffle among
// themselves; at E = 32 nothing is shuffled)
template <int E>
struct Span {
  static constexpr int kLogE = E == 32 ? 5 : 4;
  static constexpr int kLogWarp = E == 32 ? 5 : 9;
};

// shared word of element i: one pad word every 32
__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

// Shared memory of a CTA of `elems` elements, E a thread: none while every
// substage stays in a warp, else the padded keys (and payloads) as 32-bit
// words.
inline size_t bitonic_smem_bytes(int elems, int log_n, int e, bool kv) {
  if (log_n <= (e == 32 ? 5 : 9)) return 0;
  return static_cast<size_t>(elems + elems / 32) * 4 * (kv ? 2 : 1);
}

// the same value, unknown to the compiler: an address recomputed from it
// is not kept live from an earlier use
__device__ __forceinline__ int opaque(int x) {
  asm volatile("mov.b32 %0, %0;" : "+r"(x));
  return x;
}

// The register key of a source key, and back.
template <typename TR, bool KV>
struct RegKey;

// key-only: the order-preserving signed code, complemented for descending
template <typename TR>
struct RegKey<TR, false> {
  typedef typename TR::S S;
  typedef int32_t R;
  static constexpr int kBits = 8 * static_cast<int>(sizeof(S));
  static constexpr int32_t kMag = kBits == 32 ? 0x7fffffff : 0x7fff;
  static __device__ __forceinline__ R in(S s, bool desc) {
    int32_t x;
    if (TR::kFloat) {
      uint32_t u = 0;
      memcpy(&u, &s, sizeof(S));
      x = kBits == 32 ? static_cast<int32_t>(u)
                      : static_cast<int32_t>(static_cast<int16_t>(u));
      x ^= (x >> 31) & kMag;         // negative: magnitude reversed
    } else if (std::is_same<S, uint32_t>::value) {
      x = static_cast<int32_t>(static_cast<uint32_t>(s) ^ 0x80000000u);
    } else {
      x = static_cast<int32_t>(s);
    }
    return desc ? ~x : x;
  }
  static __device__ __forceinline__ S out(R x, bool desc) {
    if (desc) x = ~x;
    S s;
    if (TR::kFloat) {
      x ^= (x >> 31) & kMag;
      const uint32_t u = static_cast<uint32_t>(x);
      memcpy(&s, &u, sizeof(S));
    } else if (std::is_same<S, uint32_t>::value) {
      s = static_cast<S>(static_cast<uint32_t>(x) ^ 0x80000000u);
    } else {
      s = static_cast<S>(x);
    }
    return s;
  }
};

// key-value: the key's value (float for the float types, exact for bf16
// and fp16 and their signed zeros), int32 or uint32 for the integers
template <typename TR>
struct RegKey<TR, true> {
  typedef typename TR::S S;
  typedef typename std::conditional<
      TR::kFloat, float,
      typename std::conditional<std::is_same<S, uint32_t>::value, uint32_t,
                                int32_t>::type>::type R;
  static __device__ __forceinline__ R in(S s, bool) {
    return static_cast<R>(TR::v(s));
  }
  static __device__ __forceinline__ S out(R r, bool) {
    if constexpr (std::is_same<TR, KBF16>::value)
      return static_cast<S>(__float_as_uint(r) >> 16);
    else if constexpr (std::is_same<TR, KF16>::value)
      return __half_as_ushort(__float2half_rn(r));
    else
      return static_cast<S>(r);
  }
};

template <typename R>
__device__ __forceinline__ uint32_t to_word(R r) {
  uint32_t u;
  memcpy(&u, &r, 4);
  return u;
}
template <typename R>
__device__ __forceinline__ R from_word(uint32_t u) {
  R r;
  memcpy(&r, &u, 4);
  return r;
}

// composite order: does (a, va) come first in direction `desc`?
template <typename R>
__device__ __forceinline__ bool kv_first(R a, R b, int va, int vb,
                                         bool desc) {
  const bool tie = !(a < b) && !(b < a);
  return tie ? va < vb : (a < b) != desc;
}

// The E elements of one thread and the network over them.
template <typename TR, bool KV, int E>
struct BitonicLane {
  typedef typename TR::S S;
  static constexpr bool kPacked = KV && !TR::kFloat;
  typedef typename std::conditional<kPacked, uint64_t,
                                    typename RegKey<TR, KV>::R>::type R;
  static constexpr int kE = E;
  static constexpr int kLogE = Span<E>::kLogE;
  static constexpr int kLogWarpSpan = Span<E>::kLogWarp;
  static constexpr int kPer = 4 / static_cast<int>(sizeof(S));  // a word
  static constexpr int kWords = kE / kPer;     // 32-bit words of kE keys
  R k[kE];
  int v[kE];
  bool desc;

  // compare-exchange of registers a < b; rev: the pair's chunk runs reversed
  __device__ __forceinline__ void cx(int a, int b, bool rev) {
    if constexpr (KV && !kPacked) {
      const bool sw = kv_first(k[a], k[b], v[a], v[b], desc) == rev;
      const R ka = k[a];
      const int va = v[a];
      k[a] = sw ? k[b] : ka;
      k[b] = sw ? ka : k[b];
      v[a] = sw ? v[b] : va;
      v[b] = sw ? va : v[b];
    } else if constexpr (kPacked) {
      const bool sw = (k[b] < k[a]) != rev;
      const R ka = k[a];
      k[a] = sw ? k[b] : ka;
      k[b] = sw ? ka : k[b];
    } else {
      const R lo = min(k[a], k[b]), hi = max(k[a], k[b]);
      k[a] = rev ? hi : lo;
      k[b] = rev ? lo : hi;
    }
  }

  // the shared words of element p <- register e, and back: the key's word
  // in sk and the payload (a composite's low half) in sv
  __device__ __forceinline__ void put(uint32_t* sk, int* sv, int p,
                                      int e) const {
    if constexpr (kPacked) {
      sk[p] = static_cast<uint32_t>(k[e] >> 32);
      sv[p] = static_cast<int>(static_cast<uint32_t>(k[e]));
    } else {
      sk[p] = to_word(k[e]);
      if constexpr (KV) sv[p] = v[e];
    }
  }
  __device__ __forceinline__ void get(const uint32_t* sk, const int* sv,
                                      int p, int e) {
    if constexpr (kPacked) {
      k[e] = (static_cast<uint64_t>(sk[p]) << 32) |
             static_cast<uint32_t>(sv[p]);
    } else {
      k[e] = from_word<R>(sk[p]);
      if constexpr (KV) v[e] = sv[p];
    }
  }

  // a composite's halves: the key's code as unsigned order (complemented
  // for descending) above the payload's as unsigned order
  __device__ __forceinline__ R in_key(S x) const {
    if constexpr (kPacked)
      return static_cast<uint64_t>(
                 static_cast<uint32_t>(RegKey<TR, false>::in(x, desc)) ^
                 0x80000000u) << 32;
    else
      return RegKey<TR, KV>::in(x, desc);
  }
  // fold the payloads v into the composites (after load, or after the
  // caller set v)
  __device__ __forceinline__ void pack_payloads() {
    if constexpr (kPacked) {
#pragma unroll
      for (int e = 0; e < kE; ++e)
        k[e] |= static_cast<uint32_t>(v[e]) ^ 0x80000000u;
    }
  }
  __device__ __forceinline__ S out_key(int e) const {
    if constexpr (kPacked)
      return RegKey<TR, false>::out(
          static_cast<int32_t>(static_cast<uint32_t>(k[e] >> 32) ^
                               0x80000000u),
          desc);
    else
      return RegKey<TR, KV>::out(k[e], desc);
  }
  __device__ __forceinline__ int payload(int e) const {
    if constexpr (kPacked)
      return static_cast<int>(static_cast<uint32_t>(k[e]) ^ 0x80000000u);
    else
      return v[e];
  }

  // the substages of distance D/2 .. 1 inside a group of D registers from
  // `first`, all in direction rev
  template <int D>
  __device__ __forceinline__ void merge(int first, bool rev) {
#pragma unroll
    for (int d = D / 2; d >= 1; d /= 2) {
#pragma unroll
      for (int e = 0; e < D; ++e)
        if ((e & d) == 0) cx(first + e, first + (e | d), rev);
    }
  }

  // substage of partner lane tid ^ m (distance m kE), direction rev
  __device__ __forceinline__ void warp_substage(int m, int tid, bool rev) {
    const bool lower = (tid & m) == 0;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const R pk = __shfl_xor_sync(0xffffffffu, k[e], m);
      if constexpr (KV && !kPacked) {
        const int pv = __shfl_xor_sync(0xffffffffu, v[e], m);
        const R a = lower ? k[e] : pk, b = lower ? pk : k[e];
        const int va = lower ? v[e] : pv, vb = lower ? pv : v[e];
        // the lower slot takes the first element, the upper the second
        const bool take_a = (kv_first(a, b, va, vb, desc) != rev) == lower;
        k[e] = take_a ? a : b;
        v[e] = take_a ? va : vb;
      } else if constexpr (kPacked) {
        k[e] = ((lower != rev) == (k[e] < pk)) ? k[e] : pk;
      } else {
        k[e] = lower != rev ? min(k[e], pk) : max(k[e], pk);
      }
    }
  }

  // shared-memory round of R_ substages over index bits lo .. lo + R_ - 1
  // (distances 2^(lo + R_ - 1) .. 2^lo) at stage k: group q (of 2^R_
  // elements) is q with R_ zero bits inserted at bit lo; this thread takes
  // groups g * nthreads + tid, one after the other.  The registers are
  // scratch here: the thread's own elements wait in shared memory.  Since
  // lo >= 5, element e of a group lies e * stride padded words after its
  // first; the scatter recomputes those addresses rather than keep them.
  template <int R_>
  __device__ __forceinline__ void shared_round(uint32_t* sk, int* sv, int lo,
                                               int k_, int n, int tid,
                                               int nthreads) {
    constexpr int G = 1 << R_;
    const int stride = (1 << lo) + (1 << (lo - 5));
#pragma unroll
    for (int g = 0; g < kE / G; ++g) {
      const int q = g * nthreads + tid;
      const int i0 = ((q >> lo) << (lo + R_)) | (q & ((1 << lo) - 1));
      const int p0 = padded(i0);
#pragma unroll
      for (int e = 0; e < G; ++e) get(sk, sv, p0 + e * stride, e);
      merge<G>(0, k_ < n && (i0 & k_) != 0);
      const int p1 = opaque(p0), s1 = opaque(stride);
#pragma unroll
      for (int e = 0; e < G; ++e) put(sk, sv, p1 + e * s1, e);
    }
  }

  // the whole network over the CTA's elems = nthreads * kE elements;
  // thread tid holds elements tid kE ..; sk / sv: padded shared words
  __device__ __forceinline__ void sort(int log_n, int tid, int nthreads,
                                       uint32_t* sk, int* sv) {
    const int n = 1 << log_n;
    const int first = tid * kE;
    // stages k = 2 .. kE: inside the thread
#pragma unroll
    for (int lk = 1; lk <= kLogE; ++lk) {
      if (lk <= log_n) {
        const int k_ = 1 << lk;
#pragma unroll
        for (int lj = lk - 1; lj >= 0; --lj) {
          const int j = 1 << lj;
#pragma unroll
          for (int e = 0; e < kE; ++e)
            if ((e & j) == 0) cx(e, e | j, k_ < n && ((first + e) & k_) != 0);
        }
      }
    }
    // stages k = 2 kE .. n: one direction a thread; the thread's first
    // element recomputed each stage, not held live through it
    for (int lk = kLogE + 1; lk <= log_n; ++lk) {
      const int k_ = 1 << lk;
      const int base = opaque(tid) * kE;
      const bool rev = k_ < n && (base & k_) != 0;
      int lj = lk - 1;
      if (lj >= kLogWarpSpan) {
        __syncthreads();               // the last stage's reads are done
#pragma unroll
        for (int e = 0; e < kE; ++e) put(sk, sv, padded(base + e), e);
        __syncthreads();
        while (lj >= kLogWarpSpan) {
          const int r = min(kLogE, lj - kLogWarpSpan + 1);
          const int lo = lj - r + 1;
          switch (r) {
            case 1: shared_round<1>(sk, sv, lo, k_, n, tid, nthreads); break;
            case 2: shared_round<2>(sk, sv, lo, k_, n, tid, nthreads); break;
            case 3: shared_round<3>(sk, sv, lo, k_, n, tid, nthreads); break;
            case 4: shared_round<4>(sk, sv, lo, k_, n, tid, nthreads); break;
            default:
              if constexpr (kLogE >= 5)
                shared_round<5>(sk, sv, lo, k_, n, tid, nthreads);
          }
          __syncthreads();
          lj -= r;
        }
        const int home = padded(opaque(tid) * kE);
#pragma unroll
        for (int e = 0; e < kE; ++e) get(sk, sv, home + e, e);
      }
      if constexpr (kLogWarpSpan > kLogE) {
        for (; lj >= kLogE; --lj) warp_substage(1 << (lj - kLogE), tid, rev);
      }
      merge<kE>(0, rev);
    }
  }

  // this thread's elements of a CTA whose first `valid` elements exist
  // (the rest are rows past the end: sorted, never stored); 16-byte
  // vectors where every pointer allows them.  No vin: the caller sets the
  // payloads.
  __device__ __forceinline__ void load(const S* kin, const int* vin,
                                       int base, int valid, bool vec) {
    if (vec && base + kE <= valid) {
#pragma unroll
      for (int c = 0; c < kWords / 4; ++c) {
        const uint4 w = reinterpret_cast<const uint4*>(kin + base)[c];
        const uint32_t word[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int b = 0; b < kPer; ++b) {
            const uint32_t bits = word[i] >> (8 * sizeof(S) * b);
            S x;
            memcpy(&x, &bits, sizeof(S));
            k[(4 * c + i) * kPer + b] = in_key(x);
          }
        }
      }
      if constexpr (KV) {
        if (vin == nullptr) return;
#pragma unroll
        for (int c = 0; c < kE / 4; ++c) {
          const int4 w = reinterpret_cast<const int4*>(vin + base)[c];
          v[4 * c] = w.x;
          v[4 * c + 1] = w.y;
          v[4 * c + 2] = w.z;
          v[4 * c + 3] = w.w;
        }
        pack_payloads();
      }
    } else {
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const bool ok = base + e < valid;
        k[e] = in_key(ok ? kin[base + e] : S(0));
        if constexpr (KV) {
          if (vin != nullptr) v[e] = ok ? vin[base + e] : 0;
        }
      }
      if (vin != nullptr) pack_payloads();
    }
  }

  __device__ __forceinline__ void store(S* kout, int* vout, int base,
                                        int valid, bool vec) const {
    if (vec && base + kE <= valid) {
#pragma unroll
      for (int c = 0; c < kWords / 4; ++c) {
        uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int b = 0; b < kPer; ++b) {
            const S x = out_key((4 * c + i) * kPer + b);
            uint32_t bits = 0;
            memcpy(&bits, &x, sizeof(S));
            word[i] |= bits << (8 * sizeof(S) * b);
          }
        }
        reinterpret_cast<uint4*>(kout + base)[c] =
            make_uint4(word[0], word[1], word[2], word[3]);
      }
      if constexpr (KV) {
#pragma unroll
        for (int c = 0; c < kE / 4; ++c)
          reinterpret_cast<int4*>(vout + base)[c] =
              make_int4(payload(4 * c), payload(4 * c + 1),
                        payload(4 * c + 2), payload(4 * c + 3));
      }
    } else {
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        if (base + e < valid) {
          kout[base + e] = out_key(e);
          if constexpr (KV) vout[base + e] = payload(e);
        }
      }
    }
  }
};

// 16-byte vectors are safe when every row pointer is 16-byte aligned (a
// thread's first element then is: E elements are a multiple of 16 bytes)
inline bool bitonic_vec_ok(const void* a, const void* b, const void* c,
                           const void* d) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d)) &
          15) == 0;
}
