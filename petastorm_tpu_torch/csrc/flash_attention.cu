// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV, hand-written.
//
// Replaces the Pallas TPU kernels of petastorm_tpu/ops/flash_attention.py:
//   flash_fwd  <- _flash_kernel     (launched by _flash_bhtd, :115 / :179)
//   flash_dq   <- _flash_dq_kernel  (launched by _flash_bwd_bhtd, :232 / :316)
//   flash_dkv  <- _flash_dkv_kernel (launched by _flash_bwd_bhtd, :270 / :316)
//
// Every tensor is [BH, T_pad, D] row-major (lse and D are [BH, T_pad] f32).
// The arithmetic is the TPU kernels', step for step: scores are the f32
// product of the native-type operands times 1/sqrt(D); masked scores are
// NEG_INF = -1e30 (finite); P is cast to V's type before P V, dS to K's and
// Q's type, P to dO's type; every product is formed on its own and then
// combined with its accumulator (acc * correction + P V, acc += scale dS K),
// as the Pallas bodies do; fully masked rows get l = 1; keys are masked by
// seq_len, not by T_pad.
//
// What bounds them on an H100: at the LM slice's shape ([8, 1024, 8, 64]
// bf16, causal) each kernel does 2, 3 or 4 products of 2 BH T^2 D / 2 flops
// for 34-51 MB read and written once, 250-340 flops a byte, about the
// card's balance point (~295): flash_fwd's least time is set by its bytes
// by a hair, flash_dq's and flash_dkv's by tensor-core operations. The
// design (simple first):
//  - The TPU grid (bh, q-block, kv-block) ran in order and carried the
//    online-softmax state in VMEM scratch across its last axis. Here that
//    axis is a loop inside one block: flash_fwd and flash_dq take one block
//    per (bh, q tile) and loop over kv tiles up to the causal diagonal;
//    flash_dkv takes one block per (bh, kv tile) and loops over q tiles from
//    the diagonal. The same two-pass backward as the TPU's: no atomics.
//  - Tiles live in shared memory (dynamic, with the attribute set): 64x64
//    for bf16 and 32x32 for f32, D padded with zeros to a multiple of 16,
//    at most 128. The largest case, flash_dkv in bf16 at D = 128, takes
//    219.5 KB of the 227 KB a block may use; at the LM path's D = 64
//    flash_fwd, flash_dq and flash_dkv take 88, 113.5 and 139.5 KB.
//    The TPU's 512x1024 VMEM blocks do not fit an SM.
//  - bf16 products run on the tensor cores through WMMA (16x16x16, f32
//    accumulate); f32 products are plain FMA loops, exact f32 (they serve
//    the checks). wgmma, TMA and warp specialisation are later work.
//  - Causal tiles wholly above the diagonal and kv tiles wholly past
//    seq_len are skipped: their contribution is exactly zero.
//
// Entry points have a plain C interface (loaded with ctypes) and return
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NT = 256;             // threads per block (8 warps)
constexpr int NWARPS = NT / 32;
constexpr int MAX_D = 128;
constexpr size_t MAX_SMEM = 232448; // 227 KB, the most a block may use

using bf16 = __nv_bfloat16;

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

// Carves one shared-memory buffer after another, each 128-byte aligned.
// With base == nullptr it only counts the bytes (the host's use).
struct Carver {
  uintptr_t base;
  size_t off = 0;
  __host__ __device__ explicit Carver(char *b) : base(reinterpret_cast<uintptr_t>(b)) {}
  template <typename U> __host__ __device__ U *take(size_t n) {
    off = (off + 127) & ~size_t(127);
    U *p = reinterpret_cast<U *>(base + off);
    off += n * sizeof(U);
    return p;
  }
};

__host__ __device__ inline int pad16(int d) { return (d + 15) / 16 * 16; }

// C[M][N] (f32, row-major, ld ldc) = A[M][K] @ B[K][N].
// A_ROW: A(i,k) = A[i*lda + k], else A[k*lda + i].
// B_ROW: B(k,j) = B[k*ldb + j], else B[j*ldb + k].
// M, N, K are multiples of 16. Ends with no barrier: the caller syncs.
template <typename T, bool A_ROW, bool B_ROW>
__device__ void tile_mm(const T *A, int lda, const T *B, int ldb, float *C, int ldc,
                        int M, int N, int K) {
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    using ALayout = typename std::conditional<A_ROW, wmma::row_major, wmma::col_major>::type;
    using BLayout = typename std::conditional<B_ROW, wmma::row_major, wmma::col_major>::type;
    const int warp = threadIdx.x / 32;
    const int nj = N / 16;
    for (int f = warp; f < (M / 16) * nj; f += NWARPS) {
      const int i0 = (f / nj) * 16, j0 = (f % nj) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.0f);
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b;
        wmma::load_matrix_sync(a, A_ROW ? A + i0 * lda + k0 : A + k0 * lda + i0, lda);
        wmma::load_matrix_sync(b, B_ROW ? B + k0 * ldb + j0 : B + j0 * ldb + k0, ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(C + i0 * ldc + j0, c, ldc, wmma::mem_row_major);
    }
  } else {
    for (int idx = threadIdx.x; idx < M * N; idx += NT) {
      const int i = idx / N, j = idx % N;
      float sum = 0.0f;
      for (int k = 0; k < K; ++k) {
        const float a = A_ROW ? A[i * lda + k] : A[k * lda + i];
        const float b = B_ROW ? B[k * ldb + j] : B[j * ldb + k];
        sum = fmaf(a, b, sum);
      }
      C[i * ldc + j] = sum;
    }
  }
}

// rows [r0, r0 + R) of a [*, t_pad, d] slab -> tile[R][ld], zero past t_pad and d.
template <typename T>
__device__ void load_tile(T *tile, int ld, const T *src, int r0, int R, int t_pad, int d, int dp) {
  for (int idx = threadIdx.x; idx < R * dp; idx += NT) {
    const int r = idx / dp, c = idx % dp;
    T val = from_f32<T>(0.0f);
    if (r0 + r < t_pad && c < d) val = src[(size_t)(r0 + r) * d + c];
    tile[r * ld + c] = val;
  }
}

// rows [r0, r0 + R) of a [t_pad] f32 row vector -> vec[R], zero past t_pad.
__device__ void load_rows(float *vec, const float *src, int r0, int R, int t_pad) {
  for (int r = threadIdx.x; r < R; r += NT) vec[r] = r0 + r < t_pad ? src[r0 + r] : 0.0f;
}

// f32 tile[R][ld] -> rows [r0, r0 + R) of a [*, t_pad, d] slab.
template <typename T>
__device__ void store_tile(T *dst, const float *tile, int ld, int r0, int R, int t_pad, int d) {
  for (int idx = threadIdx.x; idx < R * d; idx += NT) {
    const int r = idx / d, c = idx % d;
    if (r0 + r < t_pad) dst[(size_t)(r0 + r) * d + c] = from_f32<T>(tile[r * ld + c]);
  }
}

__device__ __forceinline__ bool visible(int q_pos, int k_pos, int seq_len, int causal) {
  return k_pos < seq_len && (!causal || q_pos >= k_pos);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int BQ, int BK> struct FwdSmem {
  T *q, *k, *v, *p;
  float *s, *pv, *acc, *m, *l, *corr;
  __host__ __device__ size_t carve(char *base, int dp) {
    Carver c(base);
    const int ldt = dp + 8, ldf = dp + 4;
    q = c.take<T>(BQ * ldt);
    k = c.take<T>(BK * ldt);
    v = c.take<T>(BK * ldt);
    p = c.take<T>(BQ * (BK + 8));
    s = c.take<float>(BQ * (BK + 4));
    pv = c.take<float>(BQ * ldf);
    acc = c.take<float>(BQ * ldf);
    m = c.take<float>(BQ);
    l = c.take<float>(BQ);
    corr = c.take<float>(BQ);
    return c.off;
  }
};

template <typename T, int BQ, int BK>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T *__restrict__ q, const T *__restrict__ k, const T *__restrict__ v,
                 T *__restrict__ out, float *__restrict__ lse, int n_qt, int t_pad, int d,
                 int seq_len, int causal, float scale) {
  extern __shared__ __align__(128) char smem_raw[];
  const int dp = pad16(d), ldt = dp + 8, ldf = dp + 4, lds = BK + 4, ldp = BK + 8;
  FwdSmem<T, BQ, BK> sm;
  sm.carve(smem_raw, dp);
  // Later q tiles do more work under the causal mask: schedule them first.
  const int bh = blockIdx.x / n_qt;
  const int q0 = (n_qt - 1 - blockIdx.x % n_qt) * BQ;
  const size_t slab = (size_t)bh * t_pad * d;

  load_tile(sm.q, ldt, q + slab, q0, BQ, t_pad, d, dp);
  for (int idx = threadIdx.x; idx < BQ * dp; idx += NT) sm.acc[(idx / dp) * ldf + idx % dp] = 0.0f;
  for (int r = threadIdx.x; r < BQ; r += NT) {
    sm.m[r] = NEG_INF;
    sm.l[r] = 0.0f;
  }
  int n_kt = (seq_len + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile(sm.k, ldt, k + slab, k0, BK, t_pad, d, dp);
    load_tile(sm.v, ldt, v + slab, k0, BK, t_pad, d, dp);
    __syncthreads();
    tile_mm<T, true, false>(sm.q, ldt, sm.k, ldt, sm.s, lds, BQ, BK, dp);   // S = Q K^T
    __syncthreads();
    // Online softmax, one warp per row.
    for (int i = warp; i < BQ; i += NWARPS) {
      const int q_pos = q0 + i;
      float row_max = NEG_INF;
      for (int j = lane; j < BK; j += 32) {
        float s = sm.s[i * lds + j] * scale;
        if (!visible(q_pos, k0 + j, seq_len, causal)) s = NEG_INF;
        sm.s[i * lds + j] = s;
        row_max = fmaxf(row_max, s);
      }
      const float m_prev = sm.m[i];
      const float m_new = fmaxf(m_prev, warp_max(row_max));
      float row_sum = 0.0f;
      for (int j = lane; j < BK; j += 32) {
        float p = expf(sm.s[i * lds + j] - m_new);
        if (!visible(q_pos, k0 + j, seq_len, causal)) p = 0.0f;
        row_sum += p;
        sm.p[i * ldp + j] = from_f32<T>(p);            // P in V's type
      }
      row_sum = warp_sum(row_sum);
      if (lane == 0) {
        const float correction = expf(m_prev - m_new);
        sm.corr[i] = correction;
        sm.l[i] = sm.l[i] * correction + row_sum;
        sm.m[i] = m_new;
      }
    }
    __syncthreads();
    tile_mm<T, true, true>(sm.p, ldp, sm.v, ldt, sm.pv, ldf, BQ, dp, BK);   // P V
    __syncthreads();
    for (int idx = threadIdx.x; idx < BQ * dp; idx += NT) {
      const int i = idx / dp, c = idx % dp;
      sm.acc[i * ldf + c] = sm.acc[i * ldf + c] * sm.corr[i] + sm.pv[i * ldf + c];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BQ * d; idx += NT) {
    const int i = idx / d, c = idx % d;
    if (q0 + i >= t_pad) continue;
    const float l = sm.l[i] == 0.0f ? 1.0f : sm.l[i];   // fully masked rows
    out[slab + (size_t)(q0 + i) * d + c] = from_f32<T>(sm.acc[i * ldf + c] / l);
  }
  if (lse != nullptr) {
    for (int i = threadIdx.x; i < BQ; i += NT) {
      if (q0 + i >= t_pad) continue;
      const float l = sm.l[i] == 0.0f ? 1.0f : sm.l[i];
      lse[(size_t)bh * t_pad + q0 + i] = sm.m[i] + logf(l);
    }
  }
}

// ---------------------------------------------------------------------------
// backward: dQ
// ---------------------------------------------------------------------------

template <typename T, int BQ, int BK> struct DqSmem {
  T *q, *dout, *k, *v, *ds;
  float *s, *dp, *prod, *acc, *lse, *dd;
  __host__ __device__ size_t carve(char *base, int dpad) {
    Carver c(base);
    const int ldt = dpad + 8, ldf = dpad + 4;
    q = c.take<T>(BQ * ldt);
    dout = c.take<T>(BQ * ldt);
    k = c.take<T>(BK * ldt);
    v = c.take<T>(BK * ldt);
    ds = c.take<T>(BQ * (BK + 8));
    s = c.take<float>(BQ * (BK + 4));
    dp = c.take<float>(BQ * (BK + 4));
    prod = c.take<float>(BQ * ldf);
    acc = c.take<float>(BQ * ldf);
    lse = c.take<float>(BQ);
    dd = c.take<float>(BQ);
    return c.off;
  }
};

template <typename T, int BQ, int BK>
__global__ void __launch_bounds__(NT)
flash_dq_kernel(const T *__restrict__ q, const T *__restrict__ k, const T *__restrict__ v,
                const T *__restrict__ dout, const float *__restrict__ lse,
                const float *__restrict__ dd, T *__restrict__ dq, int n_qt, int t_pad, int d,
                int seq_len, int causal, float scale) {
  extern __shared__ __align__(128) char smem_raw[];
  const int dpad = pad16(d), ldt = dpad + 8, ldf = dpad + 4, lds = BK + 4, ldd = BK + 8;
  DqSmem<T, BQ, BK> sm;
  sm.carve(smem_raw, dpad);
  const int bh = blockIdx.x / n_qt;
  const int q0 = (n_qt - 1 - blockIdx.x % n_qt) * BQ;
  const size_t slab = (size_t)bh * t_pad * d;

  load_tile(sm.q, ldt, q + slab, q0, BQ, t_pad, d, dpad);
  load_tile(sm.dout, ldt, dout + slab, q0, BQ, t_pad, d, dpad);
  load_rows(sm.lse, lse + (size_t)bh * t_pad, q0, BQ, t_pad);
  load_rows(sm.dd, dd + (size_t)bh * t_pad, q0, BQ, t_pad);
  for (int idx = threadIdx.x; idx < BQ * dpad; idx += NT) sm.acc[(idx / dpad) * ldf + idx % dpad] = 0.0f;
  int n_kt = (seq_len + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile(sm.k, ldt, k + slab, k0, BK, t_pad, d, dpad);
    load_tile(sm.v, ldt, v + slab, k0, BK, t_pad, d, dpad);
    __syncthreads();
    tile_mm<T, true, false>(sm.q, ldt, sm.k, ldt, sm.s, lds, BQ, BK, dpad);      // Q K^T
    tile_mm<T, true, false>(sm.dout, ldt, sm.v, ldt, sm.dp, lds, BQ, BK, dpad);  // dO V^T
    __syncthreads();
    for (int idx = threadIdx.x; idx < BQ * BK; idx += NT) {
      const int i = idx / BK, j = idx % BK;
      float p = 0.0f;
      if (visible(q0 + i, k0 + j, seq_len, causal)) p = expf(sm.s[i * lds + j] * scale - sm.lse[i]);
      sm.ds[i * ldd + j] = from_f32<T>(p * (sm.dp[i * lds + j] - sm.dd[i]));   // dS in K's type
    }
    __syncthreads();
    tile_mm<T, true, true>(sm.ds, ldd, sm.k, ldt, sm.prod, ldf, BQ, dpad, BK);   // dS K
    __syncthreads();
    for (int idx = threadIdx.x; idx < BQ * dpad; idx += NT) {
      const int i = idx / dpad, c = idx % dpad;
      sm.acc[i * ldf + c] += scale * sm.prod[i * ldf + c];
    }
  }
  __syncthreads();
  store_tile(dq + slab, sm.acc, ldf, q0, BQ, t_pad, d);
}

// ---------------------------------------------------------------------------
// backward: dK and dV
// ---------------------------------------------------------------------------

template <typename T, int BQ, int BK> struct DkvSmem {
  T *k, *v, *q, *dout, *p, *ds;
  float *s, *dp, *prod, *dk, *dv, *lse, *dd;
  __host__ __device__ size_t carve(char *base, int dpad) {
    Carver c(base);
    const int ldt = dpad + 8, ldf = dpad + 4;
    k = c.take<T>(BK * ldt);
    v = c.take<T>(BK * ldt);
    q = c.take<T>(BQ * ldt);
    dout = c.take<T>(BQ * ldt);
    p = c.take<T>(BQ * (BK + 8));
    ds = c.take<T>(BQ * (BK + 8));
    s = c.take<float>(BQ * (BK + 4));
    dp = c.take<float>(BQ * (BK + 4));
    prod = c.take<float>(BK * ldf);
    dk = c.take<float>(BK * ldf);
    dv = c.take<float>(BK * ldf);
    lse = c.take<float>(BQ);
    dd = c.take<float>(BQ);
    return c.off;
  }
};

template <typename T, int BQ, int BK>
__global__ void __launch_bounds__(NT)
flash_dkv_kernel(const T *__restrict__ q, const T *__restrict__ k, const T *__restrict__ v,
                 const T *__restrict__ dout, const float *__restrict__ lse,
                 const float *__restrict__ dd, T *__restrict__ dk, T *__restrict__ dv, int n_kt,
                 int t_pad, int d, int seq_len, int causal, float scale) {
  extern __shared__ __align__(128) char smem_raw[];
  const int dpad = pad16(d), ldt = dpad + 8, ldf = dpad + 4, lds = BK + 4, ldh = BK + 8;
  DkvSmem<T, BQ, BK> sm;
  sm.carve(smem_raw, dpad);
  // Early kv tiles see more q tiles under the causal mask: schedule them first.
  const int bh = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x % n_kt) * BK;
  const size_t slab = (size_t)bh * t_pad * d;

  load_tile(sm.k, ldt, k + slab, k0, BK, t_pad, d, dpad);
  load_tile(sm.v, ldt, v + slab, k0, BK, t_pad, d, dpad);
  for (int idx = threadIdx.x; idx < BK * dpad; idx += NT) {
    sm.dk[(idx / dpad) * ldf + idx % dpad] = 0.0f;
    sm.dv[(idx / dpad) * ldf + idx % dpad] = 0.0f;
  }
  // A kv tile past seq_len sees nothing (all of P is 0): its loop is empty.
  const int qt_end = k0 < seq_len ? (seq_len + BQ - 1) / BQ : 0;
  const int qt_begin = causal ? k0 / BQ : 0;

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    load_tile(sm.q, ldt, q + slab, q0, BQ, t_pad, d, dpad);
    load_tile(sm.dout, ldt, dout + slab, q0, BQ, t_pad, d, dpad);
    load_rows(sm.lse, lse + (size_t)bh * t_pad, q0, BQ, t_pad);
    load_rows(sm.dd, dd + (size_t)bh * t_pad, q0, BQ, t_pad);
    __syncthreads();
    tile_mm<T, true, false>(sm.q, ldt, sm.k, ldt, sm.s, lds, BQ, BK, dpad);      // Q K^T
    tile_mm<T, true, false>(sm.dout, ldt, sm.v, ldt, sm.dp, lds, BQ, BK, dpad);  // dO V^T
    __syncthreads();
    for (int idx = threadIdx.x; idx < BQ * BK; idx += NT) {
      const int i = idx / BK, j = idx % BK;
      float p = 0.0f;
      if (visible(q0 + i, k0 + j, seq_len, causal)) p = expf(sm.s[i * lds + j] * scale - sm.lse[i]);
      sm.p[i * ldh + j] = from_f32<T>(p);                                     // P in dO's type
      sm.ds[i * ldh + j] = from_f32<T>(p * (sm.dp[i * lds + j] - sm.dd[i]));   // dS in Q's type
    }
    __syncthreads();
    tile_mm<T, false, true>(sm.p, ldh, sm.dout, ldt, sm.prod, ldf, BK, dpad, BQ);  // P^T dO
    __syncthreads();
    for (int idx = threadIdx.x; idx < BK * dpad; idx += NT) {
      const int r = idx / dpad, c = idx % dpad;
      sm.dv[r * ldf + c] += sm.prod[r * ldf + c];
    }
    __syncthreads();
    tile_mm<T, false, true>(sm.ds, ldh, sm.q, ldt, sm.prod, ldf, BK, dpad, BQ);    // dS^T Q
    __syncthreads();
    for (int idx = threadIdx.x; idx < BK * dpad; idx += NT) {
      const int r = idx / dpad, c = idx % dpad;
      sm.dk[r * ldf + c] += scale * sm.prod[r * ldf + c];
    }
  }
  __syncthreads();
  store_tile(dk + slab, sm.dk, ldf, k0, BK, t_pad, d);
  store_tile(dv + slab, sm.dv, ldf, k0, BK, t_pad, d);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T> struct Tiles;
template <> struct Tiles<bf16> { static constexpr int BQ = 64, BK = 64; };
template <> struct Tiles<float> { static constexpr int BQ = 32, BK = 32; };

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
int launch_fwd(const void *q, const void *k, const void *v, void *out, void *lse, int bh,
               int t_pad, int d, int seq_len, int causal, float scale, cudaStream_t stream) {
  constexpr int BQ = Tiles<T>::BQ, BK = Tiles<T>::BK;
  const size_t smem = FwdSmem<T, BQ, BK>().carve(nullptr, pad16(d));
  auto kernel = flash_fwd_kernel<T, BQ, BK>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (t_pad + BQ - 1) / BQ;
  kernel<<<(unsigned)bh * n_qt, NT, smem, stream>>>(
      (const T *)q, (const T *)k, (const T *)v, (T *)out, (float *)lse, n_qt, t_pad, d,
      seq_len, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dq(const void *q, const void *k, const void *v, const void *dout, const void *lse,
              const void *dd, void *dq, int bh, int t_pad, int d, int seq_len, int causal,
              float scale, cudaStream_t stream) {
  constexpr int BQ = Tiles<T>::BQ, BK = Tiles<T>::BK;
  const size_t smem = DqSmem<T, BQ, BK>().carve(nullptr, pad16(d));
  auto kernel = flash_dq_kernel<T, BQ, BK>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (t_pad + BQ - 1) / BQ;
  kernel<<<(unsigned)bh * n_qt, NT, smem, stream>>>(
      (const T *)q, (const T *)k, (const T *)v, (const T *)dout, (const float *)lse,
      (const float *)dd, (T *)dq, n_qt, t_pad, d, seq_len, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const void *q, const void *k, const void *v, const void *dout, const void *lse,
               const void *dd, void *dk, void *dv, int bh, int t_pad, int d, int seq_len,
               int causal, float scale, cudaStream_t stream) {
  constexpr int BQ = Tiles<T>::BQ, BK = Tiles<T>::BK;
  const size_t smem = DkvSmem<T, BQ, BK>().carve(nullptr, pad16(d));
  auto kernel = flash_dkv_kernel<T, BQ, BK>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_kt = (t_pad + BK - 1) / BK;
  kernel<<<(unsigned)bh * n_kt, NT, smem, stream>>>(
      (const T *)q, (const T *)k, (const T *)v, (const T *)dout, (const float *)lse,
      (const float *)dd, (T *)dk, (T *)dv, n_kt, t_pad, d, seq_len, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Pointers are device pointers; lse may
// be null in flash_fwd (inference: no logsumexp rows are written).
extern "C" {

int flash_fwd(int dtype, const void *q, const void *k, const void *v, void *out, void *lse,
              int bh, int t_pad, int d, int seq_len, int causal, float scale, void *stream) {
  if (d < 1 || d > MAX_D) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_fwd<float>(q, k, v, out, lse, bh, t_pad, d, seq_len, causal, scale, s);
  if (dtype == 1) return launch_fwd<bf16>(q, k, v, out, lse, bh, t_pad, d, seq_len, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

int flash_dq(int dtype, const void *q, const void *k, const void *v, const void *dout,
             const void *lse, const void *dd, void *dq, int bh, int t_pad, int d, int seq_len,
             int causal, float scale, void *stream) {
  if (d < 1 || d > MAX_D) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_dq<float>(q, k, v, dout, lse, dd, dq, bh, t_pad, d, seq_len, causal, scale, s);
  if (dtype == 1) return launch_dq<bf16>(q, k, v, dout, lse, dd, dq, bh, t_pad, d, seq_len, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

int flash_dkv(int dtype, const void *q, const void *k, const void *v, const void *dout,
              const void *lse, const void *dd, void *dk, void *dv, int bh, int t_pad, int d,
              int seq_len, int causal, float scale, void *stream) {
  if (d < 1 || d > MAX_D) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_dkv<float>(q, k, v, dout, lse, dd, dk, dv, bh, t_pad, d, seq_len, causal, scale, s);
  if (dtype == 1) return launch_dkv<bf16>(q, k, v, dout, lse, dd, dk, dv, bh, t_pad, d, seq_len, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
