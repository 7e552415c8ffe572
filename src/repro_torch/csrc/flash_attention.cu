// K6: flash attention, forward: causal / windowed softmax attention with the
// online-softmax recurrence, blocked GQA and an absolute query offset.
//
// Replaces the Pallas kernel of src/repro/kernels/flash_attention.py:
// flash_rows (pallas_call at :101, body _flash_kernel :32-78).
//
// Bound on the H100: a causal prefill does 2 * 2 * S^2 / 2 * H operations a
// query row (QK^T and PV, half the square visible) against (2 S + 2 T) * H
// elements of q/o/k/v; at minitron-4b's serve shapes (S = T = 1024, H =
// 128, bf16) that is 268 Mflop against 1 MB a row, ~270 flop a byte, just
// under the ridge of 989 Tflop/s over 3.35 TB/s: both bounds are close, and
// at S = 32768 the tensor cores bound it by far.  What the kernel must keep
// out of device memory is the S x T score matrix: scores, probabilities,
// the running max m, the normaliser l and the accumulator live in registers.
//
// Blocks: every kernel visits, for the queries of a 128-query block
// (kQBlock), the 128-key slots (kKBlock) below the block's causal bound
// (kpos < min(T, block start + q_offset + 128)); kernels with smaller tiles
// walk the same key slots.  Masking uses -1e30 as the reference does (not
// -inf), so a query that sees no key in those slots averages their values
// (keys past T count as zero vectors), as there.
//
// Which kernel serves which head dim H:
//
// bf16 / fp16 at every H (16, 32, 64, 128, 192 and 256), designed for
// Hopper: one CTA of three warpgroups a (query row, 128-query block), the
// heaviest causal blocks first.  Warpgroup 2 is the producer: one thread
// issues TMA loads (descriptors from cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint, so no libcuda link) of the Q tile once
// and of K/V tiles into a ring, swizzled (128-byte regions of 64 columns
// from H = 64; at 32 and 16 a row of 64 / 32 bytes is one region in 64- /
// 32-byte swizzle, which TMA and the wgmma descriptors both name), guarded
// by mbarriers (K landed, V landed, stage free); it gives its registers up
// with setmaxnreg.  Warpgroups 0 and 1 each own 64 queries: S = Q K^T runs
// as wgmma m64nKk16 (K keys a tile) from shared memory; the softmax stays
// in registers, exp2 (one MUFU.EX2) with scale * log2(e) folded into one
// FFMA; P is rounded to the input type in registers and is the register A
// operand of the PV wgmma, m64nHk16 (V read transposed from its swizzled
// tile); O accumulates in float32 registers.  S of tile c + 1 and PV of
// tile c go to the tensor cores together, and the softmax of tile c + 1
// runs while PV of tile c still does; the two warpgroups take turns (named
// barriers), so one's products also run while the other's softmax does.
// The mask is evaluated only on tiles that need it (the diagonal, the
// window's lower edge, the tile past T).  The ring's shape is set by the
// 227 KB of shared memory a CTA may have (WsLayout):
//   H = 16, 32: a visible score costs 4 H = 64 / 128 tensor flops beside
//     one exp2, and the exponent unit (16 MUFU.EX2 a clock an SM) bounds
//     the work, not the products or the bytes; what the kernel meets is
//     latency (a tile's S, softmax and PV form one chain a warpgroup), so
//     two CTAs run on an SM, each with tiles of 64 keys in 4 stages (a
//     consumer's O, S and P fit the 104 registers that leaves);
//   H = 64, 128: tiles of 128 keys, 3 stages: 32 + 3 x 64 = 224 KB at 128;
//   H = 192: one 128-key stage is 96 KB beside a 48 KB Q tile, so tiles of
//     64 keys (two a slot), 3 stages: 48 + 3 x 48 = 192 KB;
//   H = 256: a 128-key stage is 128 KB beside 64 KB of Q: 64-key tiles, 2
//     stages: 64 + 2 x 64 = 192 KB.
// A slot's 64-key tile wholly past T is not loaded (its keys' share of l
// is added at the end).  Registers (setmaxnreg: 40 the producer's, 232 a
// consumer's; 24 and 104 at two CTAs an SM): a consumer thread holds O (H
// / 2 floats), S (K / 2) and P (K / 4 words) while PV of a tile and S of
// the next run, 128 + 32 + 16 at H = 256, 16 + 32 + 16 at H = 32.
//
// The first version's mma.sync kernel (one CTA of 4 warps per (query row,
// 64-query tile), K/V tiles of 64 keys double-buffered with cp.async, rows
// padded by 16 bytes, mma.sync m16n8k16, Q's fragments read from shared
// memory a k-step at a time) served bf16 / fp16 at H = 16 and 32 until
// the wgmma kernel took them; no route reaches it now.  It stays as the
// baseline of scripts/k6_ablation.py's mma_sync variant.
//
// float32 at every H: the same 64-row tiles as mma.sync with plain FMA, q
// scaled in float32 first, the score and probability tile in shared memory
// (TF32 tensor cores would miss its 1e-4 limit); the V tile is staged into
// the K tile's buffer once the scores are formed, so at H = 256 the kernel
// needs 214 KB (K and V side by side would need 280 KB, over the 227 KB a
// CTA may have).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kQBlock = 128;          // queries of a block (Q_BLOCK)
constexpr int kKBlock = 128;          // keys of a slot (K_BLOCK)
constexpr int kTile = 64;             // the mma.sync / float32 kernels' tiles
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void run(float c[4], const uint32_t a[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void run(float c[4], const uint32_t a[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// a (64, H) tile of rows [row0, row0 + 64) of a (n, H) matrix into shared
// memory with row stride LD elements; rows >= n are zero-filled
template <typename T, int H, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int n) {
  constexpr int kChunks = H * static_cast<int>(sizeof(T)) / 16;
  constexpr int kElems = 16 / static_cast<int>(sizeof(T));
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i - r * kChunks;
    const bool ok = row0 + r < n;
    const T* s = ok ? src + (static_cast<size_t>(row0 + r) * H + c * kElems)
                    : src;
    cp_async16(dst + r * LD + c * kElems, s, ok);
  }
}

__device__ __forceinline__ bool visible(int kpos, int qpos, int t_len,
                                        int causal, int window) {
  bool ok = kpos < t_len;
  if (causal) ok = ok && kpos <= qpos;
  if (window) ok = ok && kpos > qpos - window;
  return ok;
}

struct Args {
  int s, t, g, q_offset, causal, window;
  float scale;
};

// 64-key tiles a 64-query tile at q0 visits: every key slot below its
// 128-query block's causal bound, rounded up to whole 128-key tiles (the
// tiles past T are zero-filled and masked)
__device__ __forceinline__ int visited_tiles(int q0, const Args& a) {
  const int block_start = q0 / kQBlock * kQBlock + a.q_offset;
  const int hi = a.causal ? min(a.t, block_start + kQBlock) : a.t;
  return hi > 0 ? (hi + kKBlock - 1) / kKBlock * (kKBlock / kTile) : 0;
}

// ---------------------------------------------------------------------------
// bf16 / fp16, the first version: mma.sync (no route; the ablation's
// baseline)
// ---------------------------------------------------------------------------

template <typename T, int H>
__global__ void __launch_bounds__(kThreads)
flash_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Args a) {
  constexpr int LD = H + 8;              // +16 bytes: conflict-free rows
  constexpr int KT = H / 16;             // k-steps of QK^T
  constexpr int NT = H / 8;              // n-tiles of PV
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + kTile * LD;             // 2 buffers
  T* vs = ks + 2 * kTile * LD;         // 2 buffers

  const int row = blockIdx.x;
  const int j = gridDim.y - 1 - blockIdx.y;       // heaviest blocks first
  const int kv_row = row / a.g;
  const T* qg = q + static_cast<size_t>(row) * a.s * H;
  const T* kg = k + static_cast<size_t>(kv_row) * a.t * H;
  const T* vg = v + static_cast<size_t>(kv_row) * a.t * H;
  T* og = o + static_cast<size_t>(row) * a.s * H;

  const int q0 = j * kTile;
  const int q_start = q0 + a.q_offset;
  const int n_kv = visited_tiles(q0, a);

  load_tile<T, H, LD>(qs, qg, q0, a.s);
  if (n_kv > 0) {
    load_tile<T, H, LD>(ks, kg, 0, a.t);
    load_tile<T, H, LD>(vs, vg, 0, a.t);
  }
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int qr = warp * 16 + gid;        // this thread's rows: qr, qr + 8
  const int qpos[2] = {q_start + qr, q_start + qr + 8};

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int d = 0; d < NT; ++d)
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  for (int c = 0; c < n_kv; ++c) {
    const int buf = c & 1;
    if (c + 1 < n_kv) {
      load_tile<T, H, LD>(ks + (buf ^ 1) * kTile * LD, kg,
                          (c + 1) * kTile, a.t);
      load_tile<T, H, LD>(vs + (buf ^ 1) * kTile * LD, vg,
                          (c + 1) * kTile, a.t);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kb = ks + buf * kTile * LD;
    const T* vb = vs + buf * kTile * LD;

    // S = Q K^T: 8 n-tiles of 8 keys, a k-step of Q's fragment at a time
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t qf[4];
      const T* pq = qs + qr * LD + kk * 16 + 2 * tig;
      qf[0] = *reinterpret_cast<const uint32_t*>(pq);
      qf[1] = *reinterpret_cast<const uint32_t*>(pq + 8 * LD);
      qf[2] = *reinterpret_cast<const uint32_t*>(pq + 8);
      qf[3] = *reinterpret_cast<const uint32_t*>(pq + 8 * LD + 8);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const T* p = kb + (nt * 8 + gid) * LD + kk * 16 + 2 * tig;
        Mma<T>::run(s[nt], qf, *reinterpret_cast<const uint32_t*>(p),
                    *reinterpret_cast<const uint32_t*>(p + 8));
      }
    }

    // scale, mask, row max over the quad that shares a row
    const int k0 = c * kTile;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + nt * 8 + 2 * tig + (e & 1);
        const float x = visible(kpos, qpos[e >> 1], a.t, a.causal, a.window)
                            ? s[nt][e] * a.scale
                            : kNegInf;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        rs[e >> 1] += p;
      }
    }
    // l stays per thread (this thread's columns) until the end
    l[0] = l[0] * corr[0] + rs[0];
    l[1] = l[1] * corr[1] + rs[1];
#pragma unroll
    for (int d = 0; d < NT; ++d) {
      acc[d][0] *= corr[0];
      acc[d][1] *= corr[0];
      acc[d][2] *= corr[1];
      acc[d][3] *= corr[1];
    }

    // O += P V: P's accumulator layout is the A fragment of the next mma
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int d2 = 0; d2 < H / 16; ++d2) {
        uint32_t b[4];
        const T* p = vb + key * LD + d2 * 16 + (lane >> 4) * 8;
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
            "{%0,%1,%2,%3}, [%4];\n"
            : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
            : "r"(smem_addr(p)));
        Mma<T>::run(acc[2 * d2], pa, b[0], b[1]);
        Mma<T>::run(acc[2 * d2 + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();         // the buffer is refilled next iteration
  }
  if (n_kv == 0) cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-20f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + qr + 8 * r;
    if (qi >= a.s) continue;
    T* dst = og + static_cast<size_t>(qi) * H + 2 * tig;
#pragma unroll
    for (int d = 0; d < NT; ++d)
      *reinterpret_cast<uint32_t*>(dst + d * 8) = Mma<T>::pack(
          acc[d][2 * r] / l[r], acc[d][2 * r + 1] / l[r]);
  }
}

// ---------------------------------------------------------------------------
// float32: the same tiles with plain FMA
// ---------------------------------------------------------------------------

template <int H>
__global__ void __launch_bounds__(kThreads)
flash_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  Args a) {
  constexpr int LDK = H + 1;             // K rows read across a warp
  constexpr int LDP = kTile + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);   // (64, H), pre-scaled
  float* ks = qs + kTile * H;                  // (64, LDK): K, then V
  float* ps = ks + kTile * LDK;                // (64, LDP)
  float* os = ps + kTile * LDP;                // (64, H)
  float* ms = os + kTile * H;                  // (64,)
  float* ls = ms + kTile;                      // (64,)
  float* cs = ls + kTile;                      // (64,)

  const int row = blockIdx.x;
  const int j = gridDim.y - 1 - blockIdx.y;
  const int kv_row = row / a.g;
  const float* qg = q + static_cast<size_t>(row) * a.s * H;
  const float* kg = k + static_cast<size_t>(kv_row) * a.t * H;
  const float* vg = v + static_cast<size_t>(kv_row) * a.t * H;
  float* og = o + static_cast<size_t>(row) * a.s * H;
  const int q0 = j * kTile;
  const int q_start = q0 + a.q_offset;
  const int n_kv = visited_tiles(q0, a);
  const int tid = threadIdx.x;

  for (int i = tid; i < kTile * H; i += kThreads) {
    const int r = i / H;
    qs[i] = q0 + r < a.s ? qg[static_cast<size_t>(q0) * H + i] * a.scale
                         : 0.f;
    os[i] = 0.f;
  }
  if (tid < kTile) {
    ms[tid] = kNegInf;
    ls[tid] = 0.f;
  }
  for (int c = 0; c < n_kv; ++c) {
    const int k0 = c * kTile;
    __syncthreads();
    for (int i = tid; i < kTile * H; i += kThreads) {
      const int r = i / H, d = i - r * H;
      ks[r * LDK + d] =
          k0 + r < a.t ? kg[static_cast<size_t>(k0) * H + i] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < kTile * kTile; i += kThreads) {
      const int r = i / kTile, kc = i - r * kTile;
      float x = 0.f;
#pragma unroll 8
      for (int d = 0; d < H; ++d) x = fmaf(qs[r * H + d], ks[kc * LDK + d], x);
      ps[r * LDP + kc] =
          visible(k0 + kc, q_start + r, a.t, a.causal, a.window) ? x
                                                                 : kNegInf;
    }
    __syncthreads();
    for (int i = tid; i < kTile * H; i += kThreads) {  // K is read: V
      const int r = i / H, d = i - r * H;              // takes its buffer
      ks[r * LDK + d] =
          k0 + r < a.t ? vg[static_cast<size_t>(k0) * H + i] : 0.f;
    }
    if (tid < kTile) {
      float* pr = ps + tid * LDP;
      float mx = ms[tid];
      for (int kc = 0; kc < kTile; ++kc) mx = fmaxf(mx, pr[kc]);
      float sum = 0.f;
      for (int kc = 0; kc < kTile; ++kc) {
        const float p = expf(pr[kc] - mx);
        pr[kc] = p;
        sum += p;
      }
      const float corr = expf(ms[tid] - mx);
      cs[tid] = corr;
      ls[tid] = ls[tid] * corr + sum;
      ms[tid] = mx;
    }
    __syncthreads();
    for (int i = tid; i < kTile * H; i += kThreads) {
      const int r = i / H, d = i - r * H;
      const float* pr = ps + r * LDP;
      float x = 0.f;
#pragma unroll 8
      for (int kc = 0; kc < kTile; ++kc) x = fmaf(pr[kc], ks[kc * LDK + d], x);
      os[i] = os[i] * cs[r] + x;
    }
  }
  __syncthreads();
  for (int i = tid; i < kTile * H; i += kThreads) {
    const int r = i / H;
    if (q0 + r < a.s)
      og[static_cast<size_t>(q0) * H + i] = os[i] / fmaxf(ls[r], 1e-20f);
  }
}

// ---------------------------------------------------------------------------
// bf16 / fp16 at every H: warp-specialised, TMA + wgmma
// ---------------------------------------------------------------------------

constexpr int kConsumers = 2;          // warpgroups of 64 queries
constexpr int kWsThreads = (kConsumers + 1) * 128;

// The ring's shape by head dim.  At H = 64 and 128: tiles of 128 keys (one
// 128-key slot each) in 3 stages, 224 KB at 128.  At 192 and 256 one
// stage of 128-key K and V tiles alone is 96 / 128 KB beside a 48 / 64 KB
// Q tile, so the tiles hold 64 keys (two a slot), in 3 stages at 192 and 2
// at 256: 48 + 144 = 64 + 128 = 192 KB.  At 16 and 32 latency, not room,
// sets the shape: two CTAs an SM (four consumer warpgroups to overlap one
// CTA's loads, barriers and turns with another's softmax), whose registers
// hold O, S and P of 64-key tiles, in 4 stages (40 / 72 KB).  setmaxnreg
// moves registers only within a CTA's launch allocation (kLaunchRegs a
// thread: 168 at one CTA an SM, 80 at two), so the producer's and the
// consumers' counts must fit it: 40 x 128 + 232 x 256 = 384 x 168 at one
// CTA, 24 x 128 + 104 x 256 <= 384 x 80 at two (more would block the
// consumers' setmaxnreg.inc for ever).
// Shared memory from a 1024-byte aligned base: the Q tile, kStages x (K
// tile, V tile), the barriers (K full[kStages], V full[kStages],
// empty[kStages], q).  A tile of R rows and H columns is kRegions regions
// of R rows x kRow bytes, each as TMA writes it in kRow-byte swizzle:
// H / 64 regions of 128 bytes from H = 64, one of 2 H bytes (64-byte
// swizzle at H = 32, 32-byte at 16) below.
template <int H>
struct WsLayout {
  static constexpr int kKTile = H == 64 || H == 128 ? kKBlock : 64;  // keys
  static constexpr int kCtas = H <= 32 ? 2 : 1;          // CTAs an SM
  static constexpr int kStages = H == 256 ? 2 : H <= 32 ? 4 : 3;
  static constexpr int kLaunchRegs = 65536 / (kWsThreads * kCtas) / 8 * 8;
  static constexpr int kProducerRegs = kCtas == 2 ? 24 : 40;
  static constexpr int kConsumerRegs = kCtas == 2 ? 104 : 232;
  static constexpr int kRow = H >= 64 ? 128 : 2 * H;    // bytes: swizzle
  static constexpr int kBox = kRow / 2;                 // columns a region
  static constexpr int kRegions = H / kBox;
  static constexpr int kQRegion = kQBlock * kRow;
  static constexpr int kKRegion = kKTile * kRow;
  static constexpr int kQBytes = kRegions * kQRegion;
  static constexpr int kKVBytes = kRegions * kKRegion;
  static constexpr int kBars = kQBytes + 2 * kStages * kKVBytes;
  static constexpr size_t kSmem = 1024 + kBars + 8 * (3 * kStages + 1);
  static_assert(kSmem * kCtas <= 232448, "over the 227 KB of an SM");
  static_assert(128 * (kProducerRegs + 2 * kConsumerRegs) <=
                    kWsThreads * kLaunchRegs,
                "setmaxnreg past the CTA's launch registers");
  static_assert(kKBlock % kKTile == 0, "tiles split the 128-key slots");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// spin until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// TMA: the (columns, rows, 1) box at (col, row, mat) of a 3-d map into
// shared memory at dst; completes `bar`'s transaction bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int col, int row, int mat,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(mat),
      "r"(bar)
      : "memory");
}
// wgmma shared-memory descriptor of an operand in W-byte swizzle (W =
// 128, 64 or 32: layout 1, 2 or 3): start address, leading and stride byte
// offsets (16-byte units)
template <int W>
__device__ __forceinline__ uint64_t sw_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  constexpr uint64_t layout = W == 128 ? 1 : W == 64 ? 2 : 3;
  static_assert(W == 128 || W == 64 || W == 32, "a swizzle of 32-128 B");
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// 2^x as the one MUFU.EX2 instruction (exp2f adds three an element for
// results below 2^-126, which a probability in [0, 1] can lose)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// named barriers 1 and 2 (0 is __syncthreads) between the two consumer
// warpgroups: each waits for its turn on the tensor cores, then hands it on
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}
// after a wait: the accumulators changed under the compiler's feet
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma m64nNk16 with float32 accumulators d.  QK^T reads A (Q) and B (K)
// from shared memory, both K-major; PV takes A (P) from registers and B
// (V) transposed, MN-major.  scale_d = 0 overwrites d.
#define WG_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_D32(i)                                                          \
  WG_D4(i), WG_D4(i + 4), WG_D4(i + 8), WG_D4(i + 12), WG_D4(i + 16),      \
      WG_D4(i + 20), WG_D4(i + 24), WG_D4(i + 28)
#define WG_R8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define WG_R16 WG_R8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define WG_R32                                                             \
  WG_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31"
#define WG_R64                                                             \
  WG_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63"
#define WG_R96                                                             \
  WG_R64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, "  \
  "%76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "  \
  "%90, %91, %92, %93, %94, %95"
#define WG_R128                                                            \
  WG_R96 ", %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, " \
  "%107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "      \
  "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
// S = Q K^T step: m64nNk16 over N keys, d[N / 2]; RN: d's operands, DA /
// DB / SC: the numbers of da, db and scale_d
#define WGMMA_SS(N, RN, DA, DB, SC, TY, ...)                               \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" SC ", 0;\n"            \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY \
               " {" RN "}, %" DA ", %" DB ", p, 1, 1, 0, 0;\n}\n"          \
               : __VA_ARGS__                                               \
               : "l"(da), "l"(db), "r"(scale_d))
// O += P V step: m64nHk16 over H columns, d[H / 2]; A0: the number of
// a[0], then a[1..3], db and scale_d
#define WGMMA_RS(N, RN, A0, A1, A2, A3, DB, SC, TY, ...)                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" SC ", 0;\n"            \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY \
               " {" RN "}, {%" A0 ", %" A1 ", %" A2 ", %" A3 "}, %" DB     \
               ", p, 1, 1, 1;\n}\n"                                        \
               : __VA_ARGS__                                               \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),      \
                 "r"(scale_d))

template <typename T>
struct Wgmma;

#define WGMMA_TYPE(T, TY)                                                  \
  template <>                                                              \
  struct Wgmma<T> {                                                        \
    static __device__ __forceinline__ void qk(float (&d)[64], uint64_t da, \
                                              uint64_t db, int scale_d) {  \
      WGMMA_SS(128, WG_R64, "64", "65", "66", TY, WG_D32(0), WG_D32(32));  \
    }                                                                      \
    static __device__ __forceinline__ void qk(float (&d)[32], uint64_t da, \
                                              uint64_t db, int scale_d) {  \
      WGMMA_SS(64, WG_R32, "32", "33", "34", TY, WG_D32(0));               \
    }                                                                      \
    static __device__ __forceinline__ void pv(float (&d)[8],               \
                                              const uint32_t (&a)[4],      \
                                              uint64_t db) {               \
      const int scale_d = 1;                                               \
      WGMMA_RS(16, WG_R8, "8", "9", "10", "11", "12", "13", TY, WG_D4(0),  \
               WG_D4(4));                                                  \
    }                                                                      \
    static __device__ __forceinline__ void pv(float (&d)[16],              \
                                              const uint32_t (&a)[4],      \
                                              uint64_t db) {               \
      const int scale_d = 1;                                               \
      WGMMA_RS(32, WG_R16, "16", "17", "18", "19", "20", "21", TY,         \
               WG_D4(0), WG_D4(4), WG_D4(8), WG_D4(12));                   \
    }                                                                      \
    static __device__ __forceinline__ void pv(float (&d)[32],              \
                                              const uint32_t (&a)[4],      \
                                              uint64_t db) {               \
      const int scale_d = 1;                                               \
      WGMMA_RS(64, WG_R32, "32", "33", "34", "35", "36", "37", TY,         \
               WG_D32(0));                                                 \
    }                                                                      \
    static __device__ __forceinline__ void pv(float (&d)[64],              \
                                              const uint32_t (&a)[4],      \
                                              uint64_t db) {               \
      const int scale_d = 1;                                               \
      WGMMA_RS(128, WG_R64, "64", "65", "66", "67", "68", "69", TY,        \
               WG_D32(0), WG_D32(32));                                     \
    }                                                                      \
    static __device__ __forceinline__ void pv(float (&d)[96],              \
                                              const uint32_t (&a)[4],      \
                                              uint64_t db) {               \
      const int scale_d = 1;                                               \
      WGMMA_RS(192, WG_R96, "96", "97", "98", "99", "100", "101", TY,      \
               WG_D32(0), WG_D32(32), WG_D32(64));                         \
    }                                                                      \
    static __device__ __forceinline__ void pv(float (&d)[128],             \
                                              const uint32_t (&a)[4],      \
                                              uint64_t db) {               \
      const int scale_d = 1;                                               \
      WGMMA_RS(256, WG_R128, "128", "129", "130", "131", "132", "133", TY, \
               WG_D32(0), WG_D32(32), WG_D32(64), WG_D32(96));             \
    }                                                                      \
  };
WGMMA_TYPE(__nv_bfloat16, "bf16")
WGMMA_TYPE(__half, "f16")

// S (64 queries x KT keys) = Q K^T over H in k-steps of 16 columns (32
// bytes): step kk reads region 32 kk / R of both tiles at byte 32 kk % R
// of each row (R = kRow bytes a region's row); 8-row groups 8 R apart
template <typename T, int H, int KT>
__device__ __forceinline__ void issue_qk(float (&s)[KT / 2], uint32_t qa,
                                         uint32_t ka) {
  constexpr int R = WsLayout<H>::kRow;
#pragma unroll
  for (int kk = 0; kk < H / 16; ++kk) {
    const uint32_t off = kk * 32 / R * (kQBlock * R) + kk * 32 % R;
    const uint32_t koff = kk * 32 / R * (KT * R) + kk * 32 % R;
    Wgmma<T>::qk(s, sw_desc<R>(qa + off, 16, 8 * R),
           sw_desc<R>(ka + koff, 16, 8 * R), kk > 0);
  }
}

// O (64 x H) += P (64 x KT keys) V in k-steps of 16 keys: V's rows
// 16 kk .. 16 kk + 15 (16 R bytes a step), its regions KT R apart
template <typename T, int H, int KT>
__device__ __forceinline__ void issue_pv(float (&acc)[H / 2],
                                         const uint32_t (&pa)[KT / 16][4],
                                         uint32_t va) {
  constexpr int R = WsLayout<H>::kRow;
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk)
    Wgmma<T>::pv(acc, pa[kk],
           sw_desc<R>(va + kk * 16 * R, KT * R, 8 * R));
}

template <typename T, int H>
__global__ void __launch_bounds__(kWsThreads, WsLayout<H>::kCtas)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   T* __restrict__ o, Args a) {
  typedef WsLayout<H> L;
  constexpr int kStages = L::kStages, kKTile = L::kKTile;
  constexpr int kS = kKTile / 2;              // S's floats a thread
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t qs = base;
  const uint32_t kv0 = base + L::kQBytes;        // stage st: K, then V
  const uint32_t full0 = base + L::kBars;           // K of stage st landed
  const uint32_t vfull0 = full0 + 8 * kStages;      // V of stage st landed
  const uint32_t empty0 = vfull0 + 8 * kStages;
  const uint32_t qbar = empty0 + 8 * kStages;

  const int row = blockIdx.x;
  const int j = gridDim.y - 1 - blockIdx.y;       // heaviest blocks first
  const int kv_row = row / a.g;
  const int q0 = j * kQBlock;
  const int q_start = q0 + a.q_offset;
  const int hi = a.causal ? min(a.t, q_start + kQBlock) : a.t;
  // tiles of the 128-key slots below the bound, but those wholly past T
  // (see the end)
  const int n_kv = hi > 0 ? (hi + kKTile - 1) / kKTile : 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(vfull0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, kConsumers * 128);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == kConsumers) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        L::kProducerRegs));
    if (threadIdx.x == kConsumers * 128 && n_kv > 0) {
      mbar_expect_tx(qbar, L::kQBytes);
      for (int r = 0; r < L::kRegions; ++r)
        tma_load(qs + r * L::kQRegion, &tq, L::kBox * r, q0, row, qbar);
      for (int c = 0; c < n_kv; ++c) {
        const int st = c % kStages;
        if (c >= kStages) mbar_wait(empty0 + 8 * st, (c / kStages - 1) & 1);
        const uint32_t full = full0 + 8 * st, vfull = vfull0 + 8 * st;
        const uint32_t kst = kv0 + st * 2 * L::kKVBytes;
        mbar_expect_tx(full, L::kKVBytes);        // K first: S needs it a
        for (int r = 0; r < L::kRegions; ++r)     // tile before PV needs V
          tma_load(kst + r * L::kKRegion, &tk, L::kBox * r, c * kKTile,
                   kv_row, full);
        mbar_expect_tx(vfull, L::kKVBytes);
        for (int r = 0; r < L::kRegions; ++r)
          tma_load(kst + L::kKVBytes + r * L::kKRegion, &tv, L::kBox * r,
                   c * kKTile, kv_row, vfull);
      }
    }
  } else {
    // consumer warpgroup wg: queries q0 + 64 wg .. q0 + 64 wg + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        L::kConsumerRegs));
    const int tid = threadIdx.x & 127, lane = tid & 31;
    const int r0 = wg * 64 + (tid >> 5) * 16 + (lane >> 2);  // rows r0, r0+8
    const int col = 2 * (lane & 3);
    const int lo_pos = q_start + wg * 64, hi_pos = lo_pos + 63;
    const float sl2 = a.scale * kLog2e;       // scores to log2 units
    const uint32_t qa = qs + wg * 64 * L::kRow;
    float acc[H / 2];
#pragma unroll
    for (int i = 0; i < H / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float s[kS], corr[2];
    uint32_t pa[kKTile / 16][4];

    // the online softmax of tile k0's scores, in place: s becomes
    // 2^(s * sl2 - m) with the running max m (log2 units) raised to the
    // tile's, l takes the tile's sum, corr the factor for the earlier O.
    // Only a tile with a key past T, above a query or below a window
    // evaluates the mask.
    auto softmax = [&](int k0) {
      const bool edge = k0 + kKTile > a.t ||
                        (a.causal && k0 + kKTile - 1 > lo_pos) ||
                        (a.window && k0 <= hi_pos - a.window);
      float mx[2] = {kNegInf, kNegInf};
      if (edge) {
#pragma unroll
        for (int i = 0; i < kS; ++i) {
          const int kpos = k0 + (i >> 2) * 8 + col + (i & 1);
          const int qpos = q_start + r0 + ((i >> 1) & 1) * 8;
          const float x = visible(kpos, qpos, a.t, a.causal, a.window)
                              ? s[i] * sl2
                              : kNegInf;
          s[i] = x;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          mx[r] = fmaxf(m[r], mx[r]);
          corr[r] = ex2(m[r] - mx[r]);
          m[r] = mx[r];
        }
#pragma unroll
        for (int i = 0; i < kS; ++i) s[i] = ex2(s[i] - m[(i >> 1) & 1]);
      } else {
#pragma unroll
        for (int i = 0; i < kS; ++i)
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          mx[r] = fmaxf(m[r], mx[r] * sl2);
          corr[r] = ex2(m[r] - mx[r]);
          m[r] = mx[r];
        }
#pragma unroll
        for (int i = 0; i < kS; ++i)
          s[i] = ex2(fmaf(s[i], sl2, -m[(i >> 1) & 1]));
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kS; ++i) rs[(i >> 1) & 1] += s[i];
      // l stays per thread (this thread's columns) until the end
      l[0] = l[0] * corr[0] + rs[0];
      l[1] = l[1] * corr[1] + rs[1];
    };
    // P's accumulator layout is the A fragment of the PV product
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < kKTile / 16; ++kk) {
        pa[kk][0] = Mma<T>::pack(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = Mma<T>::pack(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = Mma<T>::pack(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = Mma<T>::pack(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };

    // The two warpgroups take turns on the tensor cores: burst b of
    // warpgroup 1 follows burst b of warpgroup 0, burst b + 1 of 0 follows
    // burst b of 1.  Burst c + 1 issues S of tile c + 1 and PV of tile c;
    // the softmax of tile c + 1 then runs while PV of tile c still does.
    // Every wait comes before the wgmma.fence and the products follow it
    // with no branch between (the last burst's S repeats tile c's and is
    // dropped): a branch or a spin loop there makes ptxas insert its own
    // fence on that path and serialise every wgmma of the kernel.
    const int my_turn = 1 + wg, other_turn = 2 - wg;
    if (n_kv > 0) {
      if (wg == 1) turn_pass(1);      // warpgroup 0 goes first
      mbar_wait(qbar, 0);
      mbar_wait(full0, 0);
      turn_wait(my_turn);
      wgmma_fence();
      issue_qk<T, H, kKTile>(s, qa, kv0);
      wgmma_commit();
      turn_pass(other_turn);
      wgmma_wait<0>();
      fence_regs(s);
      softmax(0);
      pack_p();
    }
    for (int c = 0; c < n_kv; ++c) {
      const int st = c % kStages;
      const bool next = c + 1 < n_kv;
      const int nst = next ? (c + 1) % kStages : st;
      if (next) mbar_wait(full0 + 8 * nst, ((c + 1) / kStages) & 1);
      mbar_wait(vfull0 + 8 * st, (c / kStages) & 1);
      turn_wait(my_turn);
      wgmma_fence();
      issue_qk<T, H, kKTile>(s, qa, kv0 + nst * 2 * L::kKVBytes);
      wgmma_commit();
      issue_pv<T, H, kKTile>(acc, pa,
                             kv0 + st * 2 * L::kKVBytes + L::kKVBytes);
      wgmma_commit();
      if (wg == 0 || next) turn_pass(other_turn);   // none unmatched
      wgmma_wait<1>();               // S of tile c + 1 is in
      fence_regs(s);
      if (next) softmax((c + 1) * kKTile);
      wgmma_wait<0>();               // and PV of tile c
      fence_regs(acc);
      mbar_arrive(empty0 + 8 * st);
      if (next) {
#pragma unroll
        for (int i = 0; i < H / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
        pack_p();
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if constexpr (kKTile < kKBlock) {
        // A slot's tile wholly past T (zero keys, all masked) changes
        // nothing where a query has seen a key; where one has not (m still
        // -1e30) each of its keys adds p = 1 to l and nothing to O, as on
        // the other kernels' walk: its kKTile / 4 keys a thread are added
        // here instead of loaded
        const int unwalked =
            hi > 0 ? (hi + kKBlock - 1) / kKBlock * (kKBlock / kKTile) - n_kv
                   : 0;
        if (m[r] == kNegInf)
          l[r] += static_cast<float>(unwalked * kKTile / 4);
      }
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = 1.f / fmaxf(l[r], 1e-20f);
    }
    T* og = o + static_cast<size_t>(row) * a.s * H;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + r0 + 8 * r;
      if (qi >= a.s) continue;
      T* dst = og + static_cast<size_t>(qi) * H + col;
#pragma unroll
      for (int d = 0; d < H / 8; ++d)
        *reinterpret_cast<uint32_t*>(dst + d * 8) = Mma<T>::pack(
            acc[4 * d + 2 * r] * l[r], acc[4 * d + 2 * r + 1] * l[r]);
    }
  }
}

template <typename T, int H>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               long long rows, const Args& a, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kTile + 4 * kTile) * (H + 8) *
                      sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<T, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(rows),
                  static_cast<unsigned>((a.s + kTile - 1) / kTile));
  flash_mma_kernel<T, H><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), a);
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (no
// -lcuda); null where it cannot be found
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a contiguous (mats, len, H) tensor of 2-byte values as a 3-d map of
// (W / 2 columns, box_rows rows, 1) boxes in W-byte swizzle; rows past len
// load as zeros
template <int W>
bool tensor_map(EncodeTiled enc, CUtensorMap* map, CUtensorMapDataType dt,
                const void* p, long long mats, int len, int h,
                int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(mats)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(h) * 2,
                                 static_cast<cuuint64_t>(len) * h * 2};
  const cuuint32_t box[3] = {W / 2, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = W == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : W == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, dt, 3, const_cast<void*>(p), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int H>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 long long rows, const Args& a, cudaStream_t stream) {
  typedef WsLayout<H> L;
  const CUtensorMapDataType dt = std::is_same<T, __nv_bfloat16>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  memset(&tk, 0, sizeof(tk));
  memset(&tv, 0, sizeof(tv));
  if (!tensor_map<L::kRow>(enc, &tq, dt, q, rows, a.s, H, kQBlock))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.t > 0 &&      // t == 0: no block visits a tile, the maps go unread
      (!tensor_map<L::kRow>(enc, &tk, dt, k, rows / a.g, a.t, H,
                            L::kKTile) ||
       !tensor_map<L::kRow>(enc, &tv, dt, v, rows / a.g, a.t, H,
                            L::kKTile)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<T, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(rows),
                  static_cast<unsigned>((a.s + kQBlock - 1) / kQBlock));
  flash_wgmma_kernel<T, H><<<grid, kWsThreads, L::kSmem, stream>>>(
      tq, tk, tv, static_cast<T*>(o), a);
  return static_cast<int>(cudaGetLastError());
}

template <int H>
int launch_fp32(const void* q, const void* k, const void* v, void* o,
                long long rows, const Args& a, cudaStream_t stream) {
  // q, o, the K-then-V tile, the score tile and m / l / corr
  const size_t smem =
      (static_cast<size_t>(kTile) * H * 2 + kTile * (H + 1) +
       kTile * (kTile + 1) + 3 * kTile) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fp32_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(rows),
                  static_cast<unsigned>((a.s + kTile - 1) / kTile));
  flash_fp32_kernel<H><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), a);
  return static_cast<int>(cudaGetLastError());
}

// bf16 / fp16 at every H run on the wgmma kernel; the mma.sync kernel is
// reached from no route here (scripts/k6_ablation.py's mma_sync variant
// routes widths back to it as its baseline)
template <int H>
constexpr bool kOnWgmma = true;

template <int H>
int launch(int code, const void* q, const void* k, const void* v, void* o,
           long long rows, const Args& a, cudaStream_t stream) {
  switch (code) {
    case 0: return launch_fp32<H>(q, k, v, o, rows, a, stream);
    case 1:
      if constexpr (kOnWgmma<H>)
        return launch_wgmma<__nv_bfloat16, H>(q, k, v, o, rows, a, stream);
      else
        return launch_mma<__nv_bfloat16, H>(q, k, v, o, rows, a, stream);
    case 2:
      if constexpr (kOnWgmma<H>)
        return launch_wgmma<__half, H>(q, k, v, o, rows, a, stream);
      else
        return launch_mma<__half, H>(q, k, v, o, rows, a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Forward attention over rows: q (rows, s, H), k/v (rows / g, t, H), all
// contiguous, 16-byte aligned, of one dtype (code 0 float32, 1 bfloat16,
// 2 float16), H in {16, 32, 64, 128, 192, 256}; o (rows, s, H) of the same
// dtype.
// Query i of a row sits at position i + q_offset; causal keeps keys at or
// before it, window > 0 keeps the last `window` of those.  Returns the
// cudaError_t of the launch.
extern "C" int flash_attention_fwd(int code, int head_dim, const void* q,
                                   const void* k, const void* v, void* o,
                                   long long rows, int s, int t, int g,
                                   int q_offset, int causal, int window,
                                   float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{s, t, g, q_offset, causal, window, scale};
  switch (head_dim) {
    case 16: return launch<16>(code, q, k, v, o, rows, a, st);
    case 32: return launch<32>(code, q, k, v, o, rows, a, st);
    case 64: return launch<64>(code, q, k, v, o, rows, a, st);
    case 128: return launch<128>(code, q, k, v, o, rows, a, st);
    case 192: return launch<192>(code, q, k, v, o, rows, a, st);
    case 256: return launch<256>(code, q, k, v, o, rows, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
