// K5: per-row top-k.
//
// Replaces the Pallas kernel of src/repro/kernels/bitonic_topk.py:
// topk_blocks (pallas_call at :47, body _topk_kernel :27-33), and with it
// the chunk-then-merge composition of src/repro/kernels/ops.py:111
// (_topk_impl).  The function: the top k of each row, descending, the
// lower index first among equal keys, keys compared numerically (-0.0 ==
// +0.0).  Indices are unique, so that order is strict and the answer is
// unique.
//
// Bound on the H100: the function must read each row once and write k keys
// and k int32 indices, rows * (n * key bytes + k * (key bytes + 4)) over
// 3.35 TB/s: MoE routing, 16384 rows x 64 experts float32 at k = 8, moves
// 5.2 MB (1.6 us); vocabulary sampling, 64 x 128256 float32 at k = 50,
// 32.9 MB (9.8 us).
//
// Two routes, chosen by the wrapper (kernels/bitonic_topk.py, `plan`):
//
// * k <= 256: one pass over rows of any length n >= k (topk_rows_short,
//   topk_rows_stream, topk_rows_merge below).  Every (key, index) pair is
//   one unsigned 64-bit composite: the key's order-preserving code with
//   -0.0 folded onto +0.0 in the high 32 bits, then 2^31 - 1 - index, then
//   one bit that remembers a -0.0 (it never decides: indices differ).  Key
//   descending, index ascending is then a plain descending compare, the
//   admission test included, and 0 is a placeholder below every genuine
//   pair (the minimum key at index 2^31 - 2 still packs to 2).
//   - short rows (n <= 512, k <= 16), topk_rows_short: P = 1..32 lanes a
//     row, 16 consecutive keys a lane in registers.  A lane sorts runs of
//     K' = next_pow2(k) and merges them and halves (the pairwise maximum of
//     run A and reversed run B is a bitonic run holding the top K' of both,
//     rebuilt in log K' steps; Shanbhag, Pirk and Madden, SIGMOD 2018)
//     down to one run, then log2 P rounds of the same with lane l ^ t by
//     shuffles: no shared memory, no barrier.
//   - longer rows, topk_rows_stream: a warp streams a stripe of its row
//     in 16-byte loads, two steps in flight, and keeps its best N =
//     max(32, K') pairs sorted across its lanes (entry j * 32 + lane in
//     register j).  A pair is queued (in shared memory) only if it beats
//     the admission bound, the k-th best pair the warp -- or any warp of
//     its CTA, through a shared atomicMax -- has seen, and a step whose
//     keys all fall below the bound's key costs one compare a key; a queue
//     fuller than a run is sorted and merged into the run ("WarpSelect" of
//     Johnson, Douze and Jegou, 2017, with a bitonic merge-and-halve).
//     The first bound comes before anything is queued, from each lane's
//     best R = N / 32 pairs of its first step, merged over the CTA.  A CTA
//     of 8 warps either takes 8 rows, a warp each, or 8 warp stripes of a
//     row; then its warps' runs merge in shared memory.  A row of G > 1
//     CTAs writes G partial runs, and topk_rows_merge (one CTA a row)
//     merges them: two launches.
//   Nothing is padded or copied; a row's unaligned head and tail are read
//   by scalar loads.
// * k > 256 (topk_blocks): K1's descending key-value network
//   (bitonic_reg.cuh) over power-of-two rows of up to 16384, with the lane
//   index of every element as its payload, writing the first k columns;
//   ops.py chunks longer rows and orders the candidates.
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

// ---------------------------------------------------------------------------
// One-pass row top-k, k <= 256
// ---------------------------------------------------------------------------

typedef unsigned long long u64;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;           // warps a CTA of topk_rows_stream
constexpr int kShortKeys = 16;      // keys a lane of topk_rows_short

// (key, index) -> the composite: larger is better
template <typename TR>
__device__ __forceinline__ u64 pack(typename TR::S s, long long index) {
  typedef typename TR::S S;
  constexpr uint32_t kSign = 1u << (8 * sizeof(S) - 1);
  uint32_t u = 0;
  memcpy(&u, &s, sizeof(S));
  uint32_t neg_zero = 0;
  if (TR::kFloat && (u & (kSign - 1)) == 0) {   // +-0.0 -> +0.0
    neg_zero = u != 0;
    u = 0;
  }
  S folded;
  memcpy(&folded, &u, sizeof(S));
  const uint32_t lo = (0x7fffffffu - static_cast<uint32_t>(index)) << 1;
  return (static_cast<u64>(encode_key<TR>(folded)) << 32) | lo | neg_zero;
}

// composite -> key bits (inverse of encode_key; a remembered -0.0 back)
template <typename TR>
__device__ __forceinline__ typename TR::S unpack_key(u64 c) {
  typedef typename TR::S S;
  constexpr int kBits = 8 * static_cast<int>(sizeof(S));
  constexpr uint32_t kSign = 1u << (kBits - 1);
  constexpr uint32_t kAll = kBits == 32 ? 0xffffffffu : (1u << kBits) - 1u;
  const uint32_t e = static_cast<uint32_t>(c >> 32);
  uint32_t u = e;
  if (TR::kFloat) {
    u = (e & kSign) ? e ^ kSign : e ^ kAll;
    if ((c & 1) && u == 0) u = kSign;
  } else if (static_cast<S>(-1) < static_cast<S>(0)) {
    u = e ^ kSign;
  }
  S s;
  memcpy(&s, &u, sizeof(S));
  return s;
}

__device__ __forceinline__ int unpack_index(u64 c) {
  return static_cast<int>(0x7fffffffu - (static_cast<uint32_t>(c) >> 1));
}

__device__ __forceinline__ u64 max64(u64 a, u64 b) { return a > b ? a : b; }

// In-register compare-exchange: a keeps the larger when `desc`.
__device__ __forceinline__ void cas(u64& a, u64& b, bool desc) {
  const u64 hi = max64(a, b), lo = a > b ? b : a;
  a = desc ? hi : lo;
  b = desc ? lo : hi;
}

// A warp's run of N = 32 R composites, entry j * 32 + lane in v[j].  One
// substage of the bitonic network: entry e meets e ^ D, and blocks of K
// entries run descending where e & K == 0 (all of them at K = N).
template <int R, int K, int D>
__device__ __forceinline__ void substage(u64 (&v)[R], int lane) {
  if constexpr (D >= 32) {
    constexpr int dj = D >> 5;
#pragma unroll
    for (int j = 0; j < R; ++j)
      if ((j & dj) == 0) cas(v[j], v[j + dj], ((j << 5) & K) == 0);
  } else {
    const bool lower = (lane & D) == 0;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const bool desc = K >= 32 ? ((j << 5) & K) == 0 : (lane & K) == 0;
      const u64 p = __shfl_xor_sync(kFull, v[j], D);
      v[j] = ((v[j] > p) == (lower == desc)) ? v[j] : p;
    }
  }
}

// the substages D, D / 2, .., 1 of stage K
template <int R, int K, int D>
__device__ __forceinline__ void stage(u64 (&v)[R], int lane) {
  substage<R, K, D>(v, lane);
  if constexpr (D > 1) stage<R, K, D / 2>(v, lane);
}

// sorts a warp's run descending: stages K = 2, 4, .., N
template <int R, int K = 2>
__device__ __forceinline__ void sort_run(u64 (&v)[R], int lane) {
  stage<R, K, K / 2>(v, lane);
  if constexpr (K < 32 * R) sort_run<R, 2 * K>(v, lane);
}

// v and o sorted descending -> v: the first N of both, sorted descending
// (the maximum of v and reversed o is bitonic; entry N - 1 - e is register
// R - 1 - j of lane 31 - lane)
template <int R>
__device__ __forceinline__ void merge_halve(u64 (&v)[R], const u64 (&o)[R],
                                            int lane) {
#pragma unroll
  for (int j = 0; j < R; ++j)
    v[j] = max64(v[j], __shfl_xor_sync(kFull, o[R - 1 - j], 31));
  stage<R, 32 * R, 16 * R>(v, lane);
}

// The first k entries of a run to the row's outputs.
template <typename TR, int R>
__device__ __forceinline__ void store_run(const u64 (&v)[R], int k,
                                          long long row, int lane,
                                          typename TR::S* __restrict__ kout,
                                          int* __restrict__ iout) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int e = j * 32 + lane;
    if (e < k) {
      kout[row * k + e] = unpack_key<TR>(v[j]);
      iout[row * k + e] = unpack_index(v[j]);
    }
  }
}

// keys a lane takes a step of topk_rows_stream (two steps' loads in flight:
// 32 keys a step where the run leaves the registers, at k <= 64, but for
// uint32 keys, which ptxas spills there), and the queue's room: a step may
// queue 32 * step_keys pairs on top of a run's
template <typename S, int R>
__host__ __device__ constexpr int step_keys() {
  return R <= 2 && !std::is_same<S, uint32_t>::value ? 32 : 16;
}
template <typename S, int R>
__host__ __device__ constexpr int queue_room() {
  return 32 * R + 32 * step_keys<S, R>();
}

// the lowest key value of a key type (compared as TR::v gives it)
template <typename TR>
__device__ __forceinline__ auto lowest_value() {
  typedef typename TR::S S;
  if constexpr (TR::kFloat) {
    return __int_as_float(0xff800000);     // -inf
  } else if constexpr (static_cast<S>(-1) < static_cast<S>(0)) {
    return static_cast<S>(1u << (8 * sizeof(S) - 1));
  } else {
    return static_cast<S>(0);
  }
}

// entry e of a warp's run, in every lane (picked by masks: a select by
// index is turned into an indexed load, and the run into local memory)
template <int R>
__device__ __forceinline__ u64 run_entry(const u64 (&v)[R], int e) {
  u64 x = 0;
#pragma unroll
  for (int j = 0; j < R; ++j)
    x |= v[j] & (0ull - static_cast<u64>(j == (e >> 5)));
  return __shfl_sync(kFull, x, e & 31);
}

// One warp's selection state over the pairs it is offered.
template <typename TR, int R>
struct WarpSelect {
  typedef typename TR::S S;
  typedef decltype(TR::v(S())) V;
  static constexpr int kN = 32 * R;
  u64 run[R];     // the best kN pairs admitted so far, descending
  u64 bound;      // admission bound: no pair below it is in the top k
  V floor;        // the bound's key: a key below it cannot pass
  int queued;     // pairs waiting in the queue
  u64* queue;     // queue_room<S, R>() composites in shared memory
  u64* shared_bound;   // the CTA's bound for this row, or null
  int lane, k;

  __device__ __forceinline__ void init(u64* q, u64* sb, int lane_, int k_) {
#pragma unroll
    for (int j = 0; j < R; ++j) run[j] = 0;
    bound = 0;
    floor = lowest_value<TR>();
    queued = 0;
    queue = q;
    shared_bound = sb;
    lane = lane_;
    k = k_;
  }

  // a key that may pass: not below the bound's key (its index decides).
  // Written as !(key < floor) so a NaN key (whose code ranks above every
  // number) is never filtered out here: the composite compare decides it
  __device__ __forceinline__ bool may_pass(S key) const {
    return !(TR::v(key) < floor);
  }

  // a warp-wide step: each lane with `has` queues (key, index) if it beats
  // the bound; the caller keeps the room
  __device__ __forceinline__ void admit(bool has, S key, long long index) {
    const u64 c = pack<TR>(key, index);
    const bool pass = has && c > bound;
    const unsigned ballot = __ballot_sync(kFull, pass);
    if (ballot == 0) return;
    if (pass) queue[queued + __popc(ballot & ((1u << lane) - 1u))] = c;
    queued += __popc(ballot);
  }

  // the bound raised to b (a warp-uniform valid bound), and to the CTA's
  __device__ __forceinline__ void raise(u64 b) {
    if (shared_bound != nullptr) {
      u64 seen = 0;
      if (lane == 0) seen = atomicMax(shared_bound, b);
      b = max64(b, __shfl_sync(kFull, seen, 0));
    }
    if (b > bound) {
      bound = b;
      floor = TR::v(unpack_key<TR>(b));
    }
  }

  // the queue, a run's worth at a time, sorted and merged into the run;
  // the bound raised to the run's k-th pair
  __device__ __forceinline__ void flush() {
    __syncwarp();
    for (int q0 = 0; q0 < queued; q0 += kN) {
      u64 o[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int e = q0 + j * 32 + lane;
        o[j] = e < queued ? queue[e] : 0;
      }
      sort_run<R>(o, lane);
      merge_halve<R>(run, o, lane);
    }
    __syncwarp();
    queued = 0;
    raise(run_entry<R>(run, k - 1));
  }

  // the CTA's bound, if another warp raised it
  __device__ __forceinline__ void refresh() {
    if (shared_bound != nullptr) {
      const u64 b = *static_cast<volatile u64*>(shared_bound);
      if (b > bound) {
        bound = b;
        floor = TR::v(unpack_key<TR>(b));
      }
    }
  }
};

// one key of a 16-byte vector
template <typename S>
__device__ __forceinline__ S key_at(const uint4& v, int e) {
  S s;
  memcpy(&s, reinterpret_cast<const char*>(&v) + e * sizeof(S), sizeof(S));
  return s;
}

// The warps' runs (each warp's v, through its kN slots at `mine`, kRoom
// apart) merge pairwise in shared memory, log2(kWarps) rounds: warp 0
// ends with the CTA's best kN.  Every warp of the CTA calls it.
template <int R, int kRoom>
__device__ __forceinline__ void cta_merge(u64 (&v)[R], u64* mine, int warp,
                                          int lane) {
#pragma unroll
  for (int j = 0; j < R; ++j) mine[j * 32 + lane] = v[j];
  __syncthreads();
#pragma unroll
  for (int s = 1; s < kWarps; s *= 2) {
    if ((warp & (2 * s - 1)) == 0) {
      const u64* other = mine + s * kRoom;
      u64 o[R];
#pragma unroll
      for (int j = 0; j < R; ++j) o[j] = other[j * 32 + lane];
      merge_halve<R>(v, o, lane);
#pragma unroll
      for (int j = 0; j < R; ++j) mine[j * 32 + lane] = v[j];
    }
    __syncthreads();
  }
}

// A CTA of kWarps warps.  warps_per_row == 1: warp w takes row
// blockIdx.x * kWarps + w whole.  warps_per_row == kWarps: CTA g of row r
// (blockIdx.x = r * ctas + g) takes the kWarps stripes of `stripe` keys
// from (g * kWarps) * stripe, merges its warps' runs, and writes them as
// partial run g of the row, or, with ctas == 1, the row's top k.  Dynamic
// shared memory: kWarps queues of queue_room<S, R>() composites.
template <typename TR, int R>
__global__ void __launch_bounds__(kWarps * 32, 2)
topk_stream_kernel(const typename TR::S* __restrict__ kin,
                   typename TR::S* __restrict__ kout, int* __restrict__ iout,
                   u64* __restrict__ partial, long long rows, long long n,
                   int k, long long stripe, int warps_per_row, int ctas) {
  typedef typename TR::S S;
  constexpr int kV = 16 / sizeof(S);      // keys a 16-byte vector
  constexpr int kU = step_keys<S, R>() / kV;  // vectors a lane a step
  extern __shared__ u64 s_queues[];
  __shared__ u64 s_bound;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_bound = 0;
  __syncthreads();

  const bool whole = warps_per_row == 1;
  const long long row = whole
      ? static_cast<long long>(blockIdx.x) * kWarps + warp
      : blockIdx.x / ctas;
  const int g = whole ? 0 : blockIdx.x % ctas;
  if (whole && row >= rows) return;     // no barrier follows in this mode
  const long long s0 = whole ? 0
      : min(n, (static_cast<long long>(g) * kWarps + warp) * stripe);
  const long long s1 = whole ? n : min(n, s0 + stripe);

  WarpSelect<TR, R> ws;
  u64* queue = s_queues + warp * queue_room<S, R>();
  ws.init(queue, whole ? nullptr : &s_bound, lane, k);
  const S* x = kin + row * n;
  // the scalar head up to the first 16-byte boundary, the vectors (a
  // step of kU a lane, flushed when the queue holds more than a run), the
  // scalar tail
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x + s0);
  const long long a = min(s1, s0 + static_cast<long long>(
      ((16 - (addr & 15)) & 15) / sizeof(S)));
  const long long nvec = (s1 - a) / kV;
  const uint4* xv = reinterpret_cast<const uint4*>(x + a);

  {
    // a first bound before anything is queued: each lane's best R pairs
    // of the first step are distinct pairs of the row, so the k-th best of
    // them -- over the CTA's warps when they share a row -- is at most
    // the row's k-th pair
    u64 top[R];
#pragma unroll
    for (int j = 0; j < R; ++j) top[j] = 0;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const long long vi = u * 32 + lane;
      const uint4 v = vi < nvec ? __ldg(xv + vi) : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        u64 c = vi < nvec ? pack<TR>(key_at<S>(v, e), a + vi * kV + e) : 0;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const u64 hi = max64(c, top[j]);
          c = c > top[j] ? top[j] : c;
          top[j] = hi;
        }
      }
    }
    sort_run<R>(top, lane);
    if (!whole) {
      cta_merge<R, queue_room<S, R>()>(top, queue, warp, lane);
      if (warp == 0) {
        const u64 kth = run_entry<R>(top, k - 1);
        if (lane == 0 && kth > 1) s_bound = kth - 1;
      }
      __syncthreads();
      ws.refresh();
    } else {
      const u64 kth = run_entry<R>(top, k - 1);
      if (kth > 1) ws.raise(kth - 1);
    }
  }

  ws.admit(s0 + lane < a, s0 + lane < a ? x[s0 + lane] : S(), s0 + lane);
  // the next step's vectors load while this step's are examined
  uint4 next[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const long long vi = u * 32 + lane;
    next[u] = vi < nvec ? __ldg(xv + vi) : make_uint4(0, 0, 0, 0);
  }
  for (long long base = 0; base < nvec; base += 32 * kU) {
    uint4 buf[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      buf[u] = next[u];
      const long long vi = base + (kU + u) * 32 + lane;
      next[u] = vi < nvec ? __ldg(xv + vi) : make_uint4(0, 0, 0, 0);
    }
    ws.refresh();
    // the common step: no key of the warp's step reaches the bound's key;
    // else each slot that some lane's key may pass
    bool any = false;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const bool live = base + u * 32 + lane < nvec;
#pragma unroll
      for (int e = 0; e < kV; ++e)
        any |= live && ws.may_pass(key_at<S>(buf[u], e));
    }
    if (__any_sync(kFull, any)) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const long long vi = base + u * 32 + lane;
#pragma unroll
        for (int e = 0; e < kV; ++e) {
          const S key = key_at<S>(buf[u], e);
          if (__any_sync(kFull, vi < nvec && ws.may_pass(key)))
            ws.admit(vi < nvec, key, a + vi * kV + e);
        }
      }
      if (ws.queued > ws.kN) ws.flush();
    }
  }
  const long long t0 = a + nvec * kV;
  ws.admit(t0 + lane < s1, t0 + lane < s1 ? x[t0 + lane] : S(), t0 + lane);
  if (ws.queued > 0) ws.flush();

  if (!whole) {
    cta_merge<R, queue_room<S, R>()>(ws.run, queue, warp, lane);
    if (warp != 0) return;
    if (ctas > 1) {
      u64* out = partial + static_cast<long long>(blockIdx.x) * ws.kN;
#pragma unroll
      for (int j = 0; j < R; ++j) out[j * 32 + lane] = ws.run[j];
      return;
    }
  }
  store_run<TR, R>(ws.run, k, row, lane, kout, iout);
}

// runs g0, g0 + warps, .. (kB of them; zeros past the row's `ctas`)
template <int R, int kB>
__device__ __forceinline__ void load_runs(u64 (&o)[kB][R],
                                          const u64* __restrict__ p, int g0,
                                          int warps, int ctas, int lane) {
#pragma unroll
  for (int b = 0; b < kB; ++b) {
    const int g = g0 + b * warps;
#pragma unroll
    for (int j = 0; j < R; ++j)
      o[b][j] = g < ctas ? p[static_cast<long long>(g) * 32 * R + j * 32 + lane]
                         : 0;
  }
}

// One CTA a row merges the row's `ctas` partial runs: warp w merges runs
// w, w + warps, .., kB at a time (8 composites a lane) while the next kB
// load, then the warps' runs merge pairwise in shared memory.
template <typename TR, int R>
__global__ void __launch_bounds__(512, 1)
topk_merge_kernel(const u64* __restrict__ partial,
                  typename TR::S* __restrict__ kout, int* __restrict__ iout,
                  int ctas, int k) {
  constexpr int kN = 32 * R;
  constexpr int kB = 8 / R;
  extern __shared__ u64 s_runs[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const long long row = blockIdx.x;
  const u64* p = partial + row * ctas * kN;
  u64 run[R], next[kB][R];
#pragma unroll
  for (int j = 0; j < R; ++j) run[j] = 0;
  load_runs<R, kB>(next, p, warp, warps, ctas, lane);
  for (int g0 = warp; g0 < ctas; g0 += warps * kB) {
    u64 o[kB][R];
#pragma unroll
    for (int b = 0; b < kB; ++b)
#pragma unroll
      for (int j = 0; j < R; ++j) o[b][j] = next[b][j];
    load_runs<R, kB>(next, p, g0 + warps * kB, warps, ctas, lane);
#pragma unroll
    for (int b = 0; b < kB; ++b)
      if (g0 + b * warps < ctas) merge_halve<R>(run, o[b], lane);
  }
  u64* mine = s_runs + warp * kN;
#pragma unroll
  for (int j = 0; j < R; ++j) mine[j * 32 + lane] = run[j];
  __syncthreads();
  for (int s = 1; s < warps; s *= 2) {
    if ((warp & (2 * s - 1)) == 0 && warp + s < warps) {
      u64 o[R];
#pragma unroll
      for (int j = 0; j < R; ++j) o[j] = mine[s * kN + j * 32 + lane];
      merge_halve<R>(run, o, lane);
#pragma unroll
      for (int j = 0; j < R; ++j) mine[j * 32 + lane] = run[j];
    }
    __syncthreads();
  }
  if (warp == 0) store_run<TR, R>(run, k, row, lane, kout, iout);
}

// Rows of n <= 32 * C at k <= KP = next_pow2(k) <= C = kShortKeys: 2^log_p
// lanes a row, C consecutive keys a lane (16-byte loads where the lane's
// keys lie whole and aligned).
template <typename TR, int KP>
__global__ void __launch_bounds__(256)
topk_short_kernel(const typename TR::S* __restrict__ kin,
                  typename TR::S* __restrict__ kout, int* __restrict__ iout,
                  long long rows, int n, int k, int log_p) {
  typedef typename TR::S S;
  constexpr int C = kShortKeys;
  constexpr int kVecs = C * sizeof(S) / 16;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long row = t >> log_p;
  const int p = static_cast<int>(t & ((1 << log_p) - 1));
  const bool live = row < rows;
  const S* x = kin + (live ? row : 0) * n;
  const int i0 = p * C;
  u64 c[C];
  if (live && i0 + C <= n &&
      (reinterpret_cast<uintptr_t>(x + i0) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < kVecs; ++q) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(x + i0) + q);
#pragma unroll
      for (int e = 0; e < 16 / static_cast<int>(sizeof(S)); ++e) {
        const int m = q * (16 / static_cast<int>(sizeof(S))) + e;
        c[m] = pack<TR>(key_at<S>(v, e), i0 + m);
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < C; ++e)
      c[e] = live && i0 + e < n ? pack<TR>(x[i0 + e], i0 + e) : 0;
  }

  // runs of KP sorted descending (the last stage of each run descending)
  constexpr int kLogK = KP == 1 ? 0 : KP == 2 ? 1 : KP == 4 ? 2
                        : KP == 8 ? 3 : 4;
#pragma unroll
  for (int lk = 1; lk <= kLogK; ++lk)
#pragma unroll
    for (int ld = lk - 1; ld >= 0; --ld)
#pragma unroll
      for (int e = 0; e < C; ++e)
        if ((e & (1 << ld)) == 0)
          cas(c[e], c[e | (1 << ld)], lk == kLogK || (e & (1 << lk)) == 0);
  // merge-and-halve the lane's runs down to one, in c[0 .. KP)
#pragma unroll
  for (int s = KP; s < C; s *= 2) {
#pragma unroll
    for (int r = 0; r < C; r += 2 * s) {
#pragma unroll
      for (int i = 0; i < KP; ++i)
        c[r + i] = max64(c[r + i], c[r + s + KP - 1 - i]);
#pragma unroll
      for (int ld = kLogK - 1; ld >= 0; --ld)
#pragma unroll
        for (int i = 0; i < KP; ++i)
          if ((i & (1 << ld)) == 0) cas(c[r + i], c[r + (i | (1 << ld))], true);
    }
  }
  // and with the row's other lanes, by shuffles
  for (int s = 1; s < (1 << log_p); s *= 2) {
    u64 o[KP];
#pragma unroll
    for (int i = 0; i < KP; ++i)
      o[i] = __shfl_xor_sync(kFull, c[KP - 1 - i], s);
#pragma unroll
    for (int i = 0; i < KP; ++i) c[i] = max64(c[i], o[i]);
#pragma unroll
    for (int ld = kLogK - 1; ld >= 0; --ld)
#pragma unroll
      for (int i = 0; i < KP; ++i)
        if ((i & (1 << ld)) == 0) cas(c[i], c[i | (1 << ld)], true);
  }
  // every lane of the row holds its top KP: lane p writes entries p, p + P..
#pragma unroll
  for (int i = 0; i < KP; ++i) {
    if (live && i < k && (i & ((1 << log_p) - 1)) == p) {
      kout[row * k + i] = unpack_key<TR>(c[i]);
      iout[row * k + i] = unpack_index(c[i]);
    }
  }
}

template <typename TR, int KP>
int launch_short(const void* kin, void* kout, void* iout, long long rows,
                 int n, int k, int log_p, cudaStream_t stream) {
  typedef typename TR::S S;
  const long long threads = rows << log_p;
  const long long grid = (threads + 255) / 256;
  topk_short_kernel<TR, KP><<<static_cast<unsigned>(grid), 256, 0,
                              stream>>>(
      static_cast<const S*>(kin), static_cast<S*>(kout),
      static_cast<int*>(iout), rows, n, k, log_p);
  return static_cast<int>(cudaGetLastError());
}

template <typename TR, int R>
int launch_stream(const void* kin, void* kout, void* iout, void* partial,
                  long long rows, long long n, int k, long long stripe,
                  int warps_per_row, int ctas, cudaStream_t stream) {
  typedef typename TR::S S;
  const size_t smem = static_cast<size_t>(kWarps) * queue_room<S, R>() *
                      sizeof(u64);
  cudaError_t err = cudaFuncSetAttribute(
      topk_stream_kernel<TR, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = warps_per_row == 1 ? (rows + kWarps - 1) / kWarps
                                            : rows * ctas;
  topk_stream_kernel<TR, R><<<static_cast<unsigned>(grid), kWarps * 32, smem,
                              stream>>>(
      static_cast<const S*>(kin), static_cast<S*>(kout),
      static_cast<int*>(iout), static_cast<u64*>(partial), rows, n, k,
      stripe, warps_per_row, ctas);
  return static_cast<int>(cudaGetLastError());
}

template <typename TR, int R>
int launch_merge(const void* partial, void* kout, void* iout, long long rows,
                 int ctas, int warps, int k, cudaStream_t stream) {
  typedef typename TR::S S;
  const size_t smem = static_cast<size_t>(warps) * 32 * R * sizeof(u64);
  cudaError_t err = cudaFuncSetAttribute(
      topk_merge_kernel<TR, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_merge_kernel<TR, R><<<static_cast<unsigned>(rows), warps * 32, smem,
                             stream>>>(
      static_cast<const u64*>(partial), static_cast<S*>(kout),
      static_cast<int*>(iout), ctas, k);
  return static_cast<int>(cudaGetLastError());
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

// Top-k (k <= 16) of each row of a contiguous (rows, n) key array, n <= 512,
// 2^log_p >= n / 16 lanes a row, into contiguous (rows, k) keys and int32
// indices.  Returns the cudaError_t of the launch.
extern "C" int topk_rows_short(int code, const void* kin, void* kout,
                               void* iout, long long rows, int n, int k,
                               int log_p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > 16 || k > n || n > 32 * kShortKeys || log_p < 0 ||
      log_p > 5 || (n + kShortKeys - 1) / kShortKeys > (1 << log_p))
    return static_cast<int>(cudaErrorInvalidValue);
  const int kp = k <= 1 ? 1 : k <= 2 ? 2 : k <= 4 ? 4 : k <= 8 ? 8 : 16;
  KEY_DISPATCH(code, TR, switch (kp) {
    case 1:
      return launch_short<TR, 1>(kin, kout, iout, rows, n, k, log_p, s);
    case 2:
      return launch_short<TR, 2>(kin, kout, iout, rows, n, k, log_p, s);
    case 4:
      return launch_short<TR, 4>(kin, kout, iout, rows, n, k, log_p, s);
    case 8:
      return launch_short<TR, 8>(kin, kout, iout, rows, n, k, log_p, s);
    default:
      return launch_short<TR, 16>(kin, kout, iout, rows, n, k, log_p, s);
  })
}

// Top-k (k <= 256) of each row of a contiguous (rows, n) key array: with
// warps_per_row == 1 a warp a row, else `ctas` CTAs a row of 8 warps, a
// stripe of `stripe` keys a warp.  ctas == 1 writes contiguous (rows, k)
// keys and int32 indices; ctas > 1 writes each CTA's run of N = max(32,
// next_pow2(k)) composites to `partial` (rows, ctas, N), for
// topk_rows_merge.  Returns the cudaError_t of the launch.
extern "C" int topk_rows_stream(int code, const void* kin, void* kout,
                                void* iout, void* partial, long long rows,
                                long long n, int k, long long stripe,
                                int warps_per_row, int ctas, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > 256 || k > n || n > 0x7fffffffLL || ctas < 1 ||
      (warps_per_row != 1 && warps_per_row != kWarps) ||
      (warps_per_row == 1 && ctas != 1) ||
      (warps_per_row == kWarps &&
       (stripe < 1 || stripe * kWarps * ctas < n)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int r = k <= 32 ? 1 : k <= 64 ? 2 : k <= 128 ? 4 : 8;
  KEY_DISPATCH(code, TR, switch (r) {
    case 1: return launch_stream<TR, 1>(kin, kout, iout, partial, rows, n, k,
                                        stripe, warps_per_row, ctas, s);
    case 2: return launch_stream<TR, 2>(kin, kout, iout, partial, rows, n, k,
                                        stripe, warps_per_row, ctas, s);
    case 4: return launch_stream<TR, 4>(kin, kout, iout, partial, rows, n, k,
                                        stripe, warps_per_row, ctas, s);
    default:
      return launch_stream<TR, 8>(kin, kout, iout, partial, rows, n, k,
                                  stripe, warps_per_row, ctas, s);
  })
}

// The top k of each row's `ctas` partial runs (rows, ctas, N) written by
// topk_rows_stream, into contiguous (rows, k) keys and int32 indices; a CTA
// of `warps` <= 16 warps a row.  Returns the cudaError_t of the launch.
extern "C" int topk_rows_merge(int code, const void* partial, void* kout,
                               void* iout, long long rows, int ctas,
                               int warps, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > 256 || ctas < 1 || warps < 1 || warps > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int r = k <= 32 ? 1 : k <= 64 ? 2 : k <= 128 ? 4 : 8;
  KEY_DISPATCH(code, TR, switch (r) {
    case 1: return launch_merge<TR, 1>(partial, kout, iout, rows, ctas,
                                       warps, k, s);
    case 2: return launch_merge<TR, 2>(partial, kout, iout, rows, ctas,
                                       warps, k, s);
    case 4: return launch_merge<TR, 4>(partial, kout, iout, rows, ctas,
                                       warps, k, s);
    default:
      return launch_merge<TR, 8>(partial, kout, iout, rows, ctas, warps, k,
                                 s);
  })
}
