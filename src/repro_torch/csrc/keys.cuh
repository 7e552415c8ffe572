// Key types shared by the sorting kernels.
//
// Every key dtype the comparison kernels take is described by a traits
// struct: its storage type S (what the tensor holds), its comparison value
// v(s), and whether it is a float (whose -0.0 / +0.0 pair compares equal but
// must still come out of min/max with XLA's bits: the minimum of a mixed
// pair is -0.0, the maximum +0.0).  bfloat16 and float16 are compared as
// float32, which holds every value of both exactly.  Keys are NaN-free.
//
// The Python wrappers pass a dtype code; KEY_DISPATCH maps it to a traits
// struct.  The codes are the order of KEY_CODES in kernels/_build.py.
#pragma once

#include <cstdint>
#include <cstring>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

struct KF32 {
  typedef float S;
  static constexpr bool kFloat = true;
  static __device__ __forceinline__ float v(S s) { return s; }
  static __device__ __forceinline__ bool neg(S s) {
    return (__float_as_uint(s) >> 31) != 0;
  }
};

struct KBF16 {
  typedef uint16_t S;
  static constexpr bool kFloat = true;
  static __device__ __forceinline__ float v(S s) {
    return __uint_as_float(static_cast<uint32_t>(s) << 16);
  }
  static __device__ __forceinline__ bool neg(S s) { return (s >> 15) != 0; }
};

struct KF16 {
  typedef uint16_t S;
  static constexpr bool kFloat = true;
  static __device__ __forceinline__ float v(S s) {
    return __half2float(__ushort_as_half(s));
  }
  static __device__ __forceinline__ bool neg(S s) { return (s >> 15) != 0; }
};

template <typename T>
struct KInt {
  typedef T S;
  static constexpr bool kFloat = false;
  static __device__ __forceinline__ T v(S s) { return s; }
  static __device__ __forceinline__ bool neg(S) { return false; }
};

#define KEY_CASE(CODE, TYPE, TR, ...) \
  case CODE: {                        \
    typedef TYPE TR;                  \
    __VA_ARGS__;                      \
  }

// Expands the body once per key type; an unknown code is an invalid value.
#define KEY_DISPATCH(code, TR, ...)                        \
  switch (code) {                                          \
    KEY_CASE(0, KF32, TR, __VA_ARGS__)                     \
    KEY_CASE(1, KBF16, TR, __VA_ARGS__)                    \
    KEY_CASE(2, KF16, TR, __VA_ARGS__)                     \
    KEY_CASE(3, KInt<int8_t>, TR, __VA_ARGS__)             \
    KEY_CASE(4, KInt<uint8_t>, TR, __VA_ARGS__)            \
    KEY_CASE(5, KInt<int16_t>, TR, __VA_ARGS__)            \
    KEY_CASE(6, KInt<uint16_t>, TR, __VA_ARGS__)           \
    KEY_CASE(7, KInt<int32_t>, TR, __VA_ARGS__)            \
    KEY_CASE(8, KInt<uint32_t>, TR, __VA_ARGS__)           \
    default:                                               \
      return static_cast<int>(cudaErrorInvalidValue);      \
  }

// a < b and a <= b in the key order (numeric; -0.0 == +0.0)
template <typename TR>
__device__ __forceinline__ bool key_lt(typename TR::S a, typename TR::S b) {
  return TR::v(a) < TR::v(b);
}

// XLA's minimum / maximum: the lesser / greater value, and on a tie of a
// float -0.0 with +0.0 the -0.0 / the +0.0 (whatever the operand order).
template <typename TR>
__device__ __forceinline__ typename TR::S key_min(typename TR::S a,
                                                  typename TR::S b) {
  if (key_lt<TR>(a, b)) return a;
  if (key_lt<TR>(b, a)) return b;
  if (TR::kFloat) return TR::neg(a) ? a : b;
  return a;
}

template <typename TR>
__device__ __forceinline__ typename TR::S key_max(typename TR::S a,
                                                  typename TR::S b) {
  if (key_lt<TR>(b, a)) return a;
  if (key_lt<TR>(a, b)) return b;
  if (TR::kFloat) return TR::neg(a) ? b : a;
  return a;
}

// butterfly exchange of a 1-, 2- or 4-byte value within a warp
template <typename S>
__device__ __forceinline__ S shfl_xor(S v, int mask) {
  uint32_t u = 0;
  memcpy(&u, &v, sizeof(S));
  u = __shfl_xor_sync(0xffffffffu, u, mask);
  S r;
  memcpy(&r, &u, sizeof(S));
  return r;
}

// The key codec of core/keycodec.py in registers: the b-bit unsigned key
// (b = 8 * sizeof(S), zero-extended) whose unsigned order is the source
// order.  Signed ints flip the sign bit; floats flip every bit of a negative
// value and only the sign bit of a non-negative one (so -0.0 encodes below
// +0.0); unsigned ints are their own key.  XOR the result with 2^b - 1 for
// the descending code.
template <typename TR>
__device__ __forceinline__ uint32_t encode_key(typename TR::S s) {
  typedef typename TR::S S;
  constexpr int kBits = 8 * static_cast<int>(sizeof(S));
  constexpr uint32_t kSign = 1u << (kBits - 1);
  constexpr uint32_t kAll = kBits == 32 ? 0xffffffffu : (1u << kBits) - 1u;
  uint32_t u = 0;
  memcpy(&u, &s, sizeof(S));
  if (TR::kFloat) return u ^ ((u & kSign) ? kAll : kSign);
  if (static_cast<S>(-1) < static_cast<S>(0)) return u ^ kSign;
  return u;
}
