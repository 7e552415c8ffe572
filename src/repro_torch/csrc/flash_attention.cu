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
// Design (first version; wgmma, TMA and warp specialisation are later
// work): one CTA of 4 warps per (query row, 64-query block); the heaviest
// causal blocks are scheduled first.  K/V tiles of 64 keys stream through
// shared memory, double-buffered with cp.async (zero-filled past T); rows
// are padded by 16 bytes so the fragment loads hit 32 distinct banks.
// bf16/fp16: each warp owns 16 queries; QK^T and PV run on the tensor cores
// as mma.sync m16n8k16 with float32 accumulation (Q's fragments stay in
// registers, V's come in with ldmatrix.trans), the scores are scaled by
// 1/sqrt(H) in float32 after the product, P is rounded to the input type
// for the PV product.  float32: the same tiles with plain FMA, q scaled in
// float32 first, the score and probability tile in shared memory.
// Masking uses -1e30 as the reference does (not -inf), so a query that sees
// no key in the tiles it visits averages those tiles' values, as there.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQBlock = 64;
constexpr int kKBlock = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

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
  for (int i = threadIdx.x; i < kKBlock * kChunks; i += kThreads) {
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

// ---------------------------------------------------------------------------
// bf16 / fp16: tensor cores
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
  T* ks = qs + kQBlock * LD;             // 2 buffers
  T* vs = ks + 2 * kKBlock * LD;         // 2 buffers

  const int row = blockIdx.x;
  const int j = gridDim.y - 1 - blockIdx.y;       // heaviest blocks first
  const int kv_row = row / a.g;
  const T* qg = q + static_cast<size_t>(row) * a.s * H;
  const T* kg = k + static_cast<size_t>(kv_row) * a.t * H;
  const T* vg = v + static_cast<size_t>(kv_row) * a.t * H;
  T* og = o + static_cast<size_t>(row) * a.s * H;

  const int q0 = j * kQBlock;
  const int q_start = q0 + a.q_offset;
  const int hi = a.causal ? min(a.t, q_start + kQBlock) : a.t;
  const int n_kv = hi > 0 ? (hi + kKBlock - 1) / kKBlock : 0;

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

  uint32_t qf[KT][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int d = 0; d < NT; ++d)
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  for (int c = 0; c < n_kv; ++c) {
    const int buf = c & 1;
    if (c + 1 < n_kv) {
      load_tile<T, H, LD>(ks + (buf ^ 1) * kKBlock * LD, kg,
                          (c + 1) * kKBlock, a.t);
      load_tile<T, H, LD>(vs + (buf ^ 1) * kKBlock * LD, vg,
                          (c + 1) * kKBlock, a.t);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (c == 0) {
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        const T* p = qs + qr * LD + kk * 16 + 2 * tig;
        qf[kk][0] = *reinterpret_cast<const uint32_t*>(p);
        qf[kk][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
        qf[kk][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        qf[kk][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
      }
    }
    const T* kb = ks + buf * kKBlock * LD;
    const T* vb = vs + buf * kKBlock * LD;

    // S = Q K^T: 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        const T* p = kb + (nt * 8 + gid) * LD + kk * 16 + 2 * tig;
        Mma<T>::run(s[nt], qf[kk], *reinterpret_cast<const uint32_t*>(p),
                    *reinterpret_cast<const uint32_t*>(p + 8));
      }
    }

    // scale, mask, row max over the quad that shares a row
    const int k0 = c * kKBlock;
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
    for (int kk = 0; kk < kKBlock / 16; ++kk) {
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
  constexpr int LDP = kKBlock + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);   // (64, H), pre-scaled
  float* ks = qs + kQBlock * H;                  // (64, LDK)
  float* vs = ks + kKBlock * LDK;                // (64, H)
  float* ps = vs + kKBlock * H;                  // (64, LDP)
  float* os = ps + kQBlock * LDP;                // (64, H)
  float* ms = os + kQBlock * H;                  // (64,)
  float* ls = ms + kQBlock;                      // (64,)
  float* cs = ls + kQBlock;                      // (64,)

  const int row = blockIdx.x;
  const int j = gridDim.y - 1 - blockIdx.y;
  const int kv_row = row / a.g;
  const float* qg = q + static_cast<size_t>(row) * a.s * H;
  const float* kg = k + static_cast<size_t>(kv_row) * a.t * H;
  const float* vg = v + static_cast<size_t>(kv_row) * a.t * H;
  float* og = o + static_cast<size_t>(row) * a.s * H;
  const int q0 = j * kQBlock;
  const int q_start = q0 + a.q_offset;
  const int hi = a.causal ? min(a.t, q_start + kQBlock) : a.t;
  const int n_kv = hi > 0 ? (hi + kKBlock - 1) / kKBlock : 0;
  const int tid = threadIdx.x;

  for (int i = tid; i < kQBlock * H; i += kThreads) {
    const int r = i / H;
    qs[i] = q0 + r < a.s ? qg[static_cast<size_t>(q0) * H + i] * a.scale
                         : 0.f;
    os[i] = 0.f;
  }
  if (tid < kQBlock) {
    ms[tid] = kNegInf;
    ls[tid] = 0.f;
  }
  for (int c = 0; c < n_kv; ++c) {
    const int k0 = c * kKBlock;
    __syncthreads();
    for (int i = tid; i < kKBlock * H; i += kThreads) {
      const int r = i / H, d = i - r * H;
      const bool ok = k0 + r < a.t;
      const size_t gi = static_cast<size_t>(k0) * H + i;
      ks[r * LDK + d] = ok ? kg[gi] : 0.f;
      vs[i] = ok ? vg[gi] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < kQBlock * kKBlock; i += kThreads) {
      const int r = i / kKBlock, kc = i - r * kKBlock;
      float x = 0.f;
#pragma unroll 8
      for (int d = 0; d < H; ++d) x = fmaf(qs[r * H + d], ks[kc * LDK + d], x);
      ps[r * LDP + kc] =
          visible(k0 + kc, q_start + r, a.t, a.causal, a.window) ? x
                                                                 : kNegInf;
    }
    __syncthreads();
    if (tid < kQBlock) {
      float* pr = ps + tid * LDP;
      float mx = ms[tid];
      for (int kc = 0; kc < kKBlock; ++kc) mx = fmaxf(mx, pr[kc]);
      float sum = 0.f;
      for (int kc = 0; kc < kKBlock; ++kc) {
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
    for (int i = tid; i < kQBlock * H; i += kThreads) {
      const int r = i / H, d = i - r * H;
      const float* pr = ps + r * LDP;
      float x = 0.f;
#pragma unroll 8
      for (int kc = 0; kc < kKBlock; ++kc) x = fmaf(pr[kc], vs[kc * H + d], x);
      os[i] = os[i] * cs[r] + x;
    }
  }
  __syncthreads();
  for (int i = tid; i < kQBlock * H; i += kThreads) {
    const int r = i / H;
    if (q0 + r < a.s)
      og[static_cast<size_t>(q0) * H + i] = os[i] / fmaxf(ls[r], 1e-20f);
  }
}

template <typename T, int H>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               long long rows, const Args& a, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kQBlock + 4 * kKBlock) * (H + 8) *
                      sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<T, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(rows),
                  static_cast<unsigned>((a.s + kQBlock - 1) / kQBlock));
  flash_mma_kernel<T, H><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), a);
  return static_cast<int>(cudaGetLastError());
}

template <int H>
int launch_fp32(const void* q, const void* k, const void* v, void* o,
                long long rows, const Args& a, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(kQBlock) * H * 2 + kKBlock * (H + 1) +
       kKBlock * H + kQBlock * (kKBlock + 1) + 3 * kQBlock) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fp32_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(rows),
                  static_cast<unsigned>((a.s + kQBlock - 1) / kQBlock));
  flash_fp32_kernel<H><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), a);
  return static_cast<int>(cudaGetLastError());
}

template <int H>
int launch(int code, const void* q, const void* k, const void* v, void* o,
           long long rows, const Args& a, cudaStream_t stream) {
  switch (code) {
    case 0: return launch_fp32<H>(q, k, v, o, rows, a, stream);
    case 1: return launch_mma<__nv_bfloat16, H>(q, k, v, o, rows, a, stream);
    case 2: return launch_mma<__half, H>(q, k, v, o, rows, a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Forward attention over rows: q (rows, s, H), k/v (rows / g, t, H), all
// contiguous, 16-byte aligned, of one dtype (code 0 float32, 1 bfloat16,
// 2 float16), H in {16, 32, 64, 128}; o (rows, s, H) of the same dtype.
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
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
