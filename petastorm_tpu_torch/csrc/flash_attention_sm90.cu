// Flash attention for Hopper (sm_90a), redesigned around TMA, wgmma and
// register accumulators: the bf16 forward (K2), dQ (K3) and dK/dV (K4)
// kernels at head dim 64 or 128.
//
// Replaces, for bf16 inputs with D in {64, 128}, the Pallas TPU kernels of
// petastorm_tpu/ops/flash_attention.py:
//   flash_fwd_sm90 <- _flash_kernel     (launched by _flash_bhtd, :115 / :179)
//   flash_dq_sm90  <- _flash_dq_kernel  (launched by _flash_bwd_bhtd, :232 / :316)
//   flash_dkv_sm90 <- _flash_dkv_kernel (launched by _flash_bwd_bhtd, :270 / :316)
// flash_attention.cu keeps f32 and every other head dim.
//
// The function is the TPU bodies' (and flash_attention.cu's): every tensor
// is [BH, T_pad, D] row-major bf16, lse and D are [BH, T_pad] f32; keys are
// masked by seq_len; masked scores are the finite NEG_INF = -1e30; kv tiles
// wholly above the causal diagonal are skipped; fully masked rows get l = 1;
// P is cast to bf16 before P V, dS before its product; lse is the natural
// m + log l; no atomics. What differs is the order of the f32 sums: P V
// accumulates straight into the rescaled accumulator, the softmax runs in
// base 2 (exp2 with scale * log2 e folded in; lse is converted back), and
// dQ and dK are scaled once at the end.
//
// What bounds them on an H100: at the LM path's shape ([64, 1024, 64] bf16,
// causal) the forward does 2 causal products (8.6 GFLOP) for ~34 MB read
// and written once, and is bound by its bytes (10.1 us at 3.35 TB/s);
// dQ does 3 products (12.9 GFLOP) for ~34 MB and dK/dV 4 (17.2 GFLOP) for
// ~42 MB, both bound by the tensor cores (13.0 and 17.4 us at 989
// TFLOP/s). All sit near the card's balance point, so the design keeps the
// tensor cores fed and every intermediate on chip:
//  - One block per (bh, tile): a 128-row q tile in the forward and dQ, a
//    128-row kv tile in dK/dV, heaviest tiles first across the whole grid
//    (causal work grows with the q tile and shrinks with the kv tile).
//    384 threads: warpgroup 0 is the producer (one thread issues every
//    load; setmaxnreg lowers it to 24 registers), warpgroups 1 and 2 are
//    consumers of 64 rows each (setmaxnreg 240).
//  - Loads are TMA copies of 64-column boxes with the 128-byte swizzle
//    from 3-D tensor maps over [BH, T_pad, D] (rows past T_pad come back
//    as zeros), completed on mbarriers. The tiles the block owns (Q; Q and
//    dO with their lse and D rows from 2-D maps; or K and V) are loaded
//    once; the streamed tiles (K and V of 128 rows in the forward, of 64
//    rows in dQ; Q and dO of 64 rows with their lse and D rows in dK/dV)
//    pass through a 2-stage ring guarded by full/empty barriers, so the
//    next tile's copy overlaps this tile's products.
//  - Products are wgmma (m64nNk16, f32 accumulators in registers). Scores
//    (S = Q K^T and, in dQ, dP = dO V^T; in dK/dV, S^T = K Q^T and
//    dP^T = V dO^T) read both operands from shared memory, K-major. The
//    softmax is applied to the accumulator in registers; a row's max and
//    sum are reduced over the four threads that share it. P (and dS) are
//    converted to bf16 in registers, whose accumulator layout is the
//    A-operand layout of the next wgmma, so they never touch shared
//    memory: O += P V, dQ += dS K, dV += P^T dO and dK += dS^T Q take V, K,
//    dO and Q as B straight from their tiles, MN-major (transposed by the
//    descriptor).
//  - dQ keeps its accumulator in registers for the whole kv loop, and each
//    thread's two rows of lse and D in registers; dK/dV work in the
//    transposed frame (rows are keys), so both accumulators stay in
//    registers for the whole q loop.
//  - The causal mask and the seq_len / T_pad masks are applied only on the
//    tiles that cross them.
//  - Epilogue: each consumer warpgroup writes its rows (bf16) into a
//    padded shared buffer and copies them out with 16-byte stores.
// Later work (not done here): intra-warpgroup overlap of softmax and
// products (FA3's ping-pong), a persistent grid, TMA stores.
//
// Entry points have a plain C interface (loaded with ctypes) and return 0,
// a CUDA error (cudaGetLastError() after the launch), or a negative code
// for a failure on the host: -1 cuTensorMapEncodeTiled was not found in
// libcuda.so.1, -2 a tensor map could not be encoded, -3 a head dim other
// than 64 or 128, -4 (flash_sm90_smem_bytes only) an unknown kernel code.

#include <cuda.h>   // CUtensorMap and its enums; the encoder comes from libcuda.so.1 at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int NT = 384;               // producer warpgroup + two consumer warpgroups
constexpr int STAGES = 2;             // depth of the ring of streamed tiles
constexpr int BOX_COLS = 64;          // one swizzled 128-byte row of bf16
constexpr int ROW_BYTES = BOX_COLS * 2;
constexpr int CONSUMERS = 256;        // threads that release a stage

// ---------------------------------------------------------------------------
// PTX wrappers: shared addresses, mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void *p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t *bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t *bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t *bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the phase of parity `parity` has completed. A barrier that
// never completes (a fault in the pipeline) traps after ~2^34 cycles, some
// 9 s: the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t *bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_3d(void *dst, const CUtensorMap *map, uint64_t *bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void *dst, const CUtensorMap *map, uint64_t *bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void named_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1 =
// SWIZZLE_128B, the layout TMA writes with CU_TENSOR_MAP_SWIZZLE_128B.
//  K-major operand (rows of the M or N dimension, K contiguous): the
//    leading offset is unused; the stride offset is 1024 bytes, from one
//    group of 8 rows to the next. A k16 step is +32 bytes inside a
//    64-column block.
//  MN-major operand (rows of the K dimension, N contiguous): the leading
//    offset steps from one 64-column block to the next (rows * 128
//    bytes), the stride offset from one group of 8 K rows to the next
//    (1024 bytes). A k16 step is +16 rows = +2048 bytes.
__device__ __forceinline__ uint64_t smem_desc(const void *p, uint32_t lead_bytes) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lead_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x N] (+)= A[64 x 16] B[16 x N], bf16 in, f32 accumulators: d holds
// N / 2 floats a thread. Thread t of the warpgroup holds rows
// 16 (t / 32) + (t % 32) / 4 (+ 8) and, for each 8-column block j, the
// columns 8 j + 2 (t % 4) + {0, 1}: d[4j], d[4j+1] on the first row,
// d[4j+2], d[4j+3] on the second. wgmma_ss takes A and B from shared
// memory (both K-major), wgmma_rs takes A from registers and B MN-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t *>(&v);
}

// An f32 accumulator [64 x 16 KC] as KC bf16 A operands of m64k16: the
// accumulator's layout is the A operand's, two 8-column blocks a chunk.
template <int KC>
__device__ __forceinline__ void to_operands(const float (&d)[KC * 8], uint32_t (&a)[KC][4]) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    a[kc][0] = pack_bf16(d[8 * kc + 0], d[8 * kc + 1]);
    a[kc][1] = pack_bf16(d[8 * kc + 2], d[8 * kc + 3]);
    a[kc][2] = pack_bf16(d[8 * kc + 4], d[8 * kc + 5]);
    a[kc][3] = pack_bf16(d[8 * kc + 6], d[8 * kc + 7]);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ bool visible(int q_pos, int k_pos, int seq_len, int causal) {
  return k_pos < seq_len && (!causal || q_pos >= k_pos);
}

__device__ __forceinline__ char *align_1024(char *p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// A consumer warpgroup's [64 x D] f32 accumulator -> bf16 rows
// [row0, row0 + 64) of dst (rows at or past t_pad are dropped), through
// its own padded [64][D + 8] shared buffer and 16-byte stores.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], bf16 *stage, bf16 *dst, int row0, int t_pad,
                                           int t, int bar_id) {
  constexpr int LD = D + 8, CHUNKS = D / 8;
  const int r = (t / 32) * 16 + (t % 32) / 4, c = 2 * (t % 4);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t *>(stage + r * LD + 8 * j + c) = pack_bf16(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t *>(stage + (r + 8) * LD + 8 * j + c) = pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
  named_barrier(bar_id);
  for (int i = t; i < 64 * CHUNKS; i += 128) {
    const int row = i / CHUNKS, ch = i % CHUNKS;
    if (row0 + row < t_pad)
      *reinterpret_cast<uint4 *>(dst + static_cast<size_t>(row0 + row) * D + ch * 8) =
          *reinterpret_cast<const uint4 *>(stage + row * LD + ch * 8);
  }
  named_barrier(bar_id);   // the buffer may be written again
}

// ---------------------------------------------------------------------------
// forward (K2)
// ---------------------------------------------------------------------------

template <int D> struct FwdLayout {
  static constexpr int BQ = 128, BK = 128, CB = D / BOX_COLS;
  static constexpr int TILE_Q = BQ * D * 2, TILE_KV = BK * D * 2;   // bytes
  static constexpr int Q = 0, K = Q + TILE_Q, V = K + STAGES * TILE_KV, O = V + STAGES * TILE_KV;
  static constexpr int BAR = O + BQ * (D + 8) * 2;
  static constexpr int SMEM = BAR + 8 * (1 + 2 * STAGES) + 1024;     // + slack to align the base
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, bf16 *__restrict__ out,
                      float *__restrict__ lse, int bh_count, int n_qt, int t_pad, int seq_len, int causal,
                      float scale_log2) {
  using L = FwdLayout<D>;
  extern __shared__ char smem_raw[];
  char *smem = align_1024(smem_raw);
  bf16 *sq = reinterpret_cast<bf16 *>(smem + L::Q);
  bf16 *sk = reinterpret_cast<bf16 *>(smem + L::K);
  bf16 *sv = reinterpret_cast<bf16 *>(smem + L::V);
  bf16 *so = reinterpret_cast<bf16 *>(smem + L::O);
  uint64_t *q_full = reinterpret_cast<uint64_t *>(smem + L::BAR);
  uint64_t *full = q_full + 1, *empty = full + STAGES;

  // Heaviest first: later q tiles see more kv tiles under the causal mask.
  const int bh = blockIdx.x % bh_count;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / bh_count;
  const int q0 = qt * L::BQ;
  int n_kt = (seq_len + L::BK - 1) / L::BK;
  if (causal) n_kt = min(n_kt, qt + 1);   // BQ == BK: tiles past the diagonal are skipped

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::TILE_Q);
      for (int cb = 0; cb < L::CB; ++cb) tma_load_3d(sq + cb * L::BQ * BOX_COLS, &tm_q, q_full, cb * BOX_COLS, q0, bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * L::TILE_KV);
        bf16 *k_dst = sk + s * L::BK * D, *v_dst = sv + s * L::BK * D;
        for (int cb = 0; cb < L::CB; ++cb) {
          tma_load_3d(k_dst + cb * L::BK * BOX_COLS, &tm_k, &full[s], cb * BOX_COLS, kt * L::BK, bh);
          tma_load_3d(v_dst + cb * L::BK * BOX_COLS, &tm_v, &full[s], cb * BOX_COLS, kt * L::BK, bh);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup w owns q rows [q0 + 64 w, q0 + 64 w + 64) ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int w = wg - 1, t = threadIdx.x % 128;
    const int row = w * 64 + (t / 32) * 16 + (t % 32) / 4;   // tile row of the thread's first row
    const int q_pos[2] = {q0 + row, q0 + row + 8};
    const int c2 = 2 * (t % 4);
    const bf16 *sq_w = sq + w * 64 * BOX_COLS;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};   // l: this thread's share of the row sum

    mbar_wait(q_full, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % STAGES, k0 = kt * L::BK;
      mbar_wait(&full[s], (kt / STAGES) & 1);
      const bf16 *sk_s = sk + s * L::BK * D, *sv_s = sv + s * L::BK * D;

      // S = Q K^T: [64 x 128] f32 in registers.
      float sc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk / 4) * L::BQ * BOX_COLS + (kk % 4) * 16;   // block of 64 columns, k16 step
        wgmma_ss(sc, smem_desc(sq_w + off, 16), smem_desc(sk_s + (kk / 4) * L::BK * BOX_COLS + (kk % 4) * 16, 16),
                 kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(sc);

      // Online softmax in base 2, masks only on tiles that cross them.
      const bool masked = k0 + L::BK > seq_len || (causal && k0 + L::BK - 1 > q0 + w * 64);
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] *= scale_log2;
      if (masked) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k_pos = k0 + 8 * j + c2 + (e & 1);
            if (!visible(q_pos[e >> 1], k_pos, seq_len, causal)) sc[4 * j + e] = NEG_INF;
          }
      }
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m[h], quad_max(mx[h]));
        corr[h] = exp2f(m[h] - m_new);
        m[h] = m_new;
      }
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(sc[4 * j + e] - m[e >> 1]);
          if (masked && sc[4 * j + e] == NEG_INF) p = 0.0f;   // masked: exactly 0, even in a fully masked row
          sc[4 * j + e] = p;
          sum[e >> 1] += p;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + sum[h];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }

      // O += P V: P (bf16) from registers, V MN-major from the stage.
      uint32_t pa[8][4];
      to_operands<8>(sc, pa);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 8; ++kc) wgmma_rs(o, pa[kc], smem_desc(sv_s + kc * 16 * BOX_COLS, L::BK * ROW_BYTES));
      wgmma_commit();
      wgmma_wait();
      fence_regs(o);
      mbar_arrive(&empty[s]);
    }

    float denom[2], row_lse[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float total = quad_sum(l[h]);
      if (total == 0.0f) total = 1.0f;   // fully masked rows
      denom[h] = total;
      row_lse[h] = m[h] == NEG_INF ? NEG_INF : m[h] * LN2 + logf(total);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] /= denom[0];
      o[4 * j + 1] /= denom[0];
      o[4 * j + 2] /= denom[1];
      o[4 * j + 3] /= denom[1];
    }
    store_rows<D>(o, so + w * 64 * (D + 8), out + static_cast<size_t>(bh) * t_pad * D, q0 + w * 64, t_pad, t,
                  1 + w);
    if (lse != nullptr && c2 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (q_pos[h] < t_pad) lse[static_cast<size_t>(bh) * t_pad + q_pos[h]] = row_lse[h];
    }
  }
}

// ---------------------------------------------------------------------------
// backward: dQ (K3)
// ---------------------------------------------------------------------------

template <int D> struct DqLayout {
  static constexpr int BQ = 128, BK = 64, CB = D / BOX_COLS;
  static constexpr int TILE_Q = BQ * D * 2, TILE_KV = BK * D * 2, VEC = BQ * 4;   // bytes
  static constexpr int Q = 0, DO = Q + TILE_Q, K = DO + TILE_Q, V = K + STAGES * TILE_KV;
  static constexpr int LSE = V + STAGES * TILE_KV, DD = LSE + VEC, STG = DD + VEC;
  static constexpr int BAR = STG + BQ * (D + 8) * 2;
  static constexpr int SMEM = BAR + 8 * (1 + 2 * STAGES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_lse, const __grid_constant__ CUtensorMap tm_dd,
                     bf16 *__restrict__ dq, int bh_count, int n_qt, int t_pad, int seq_len, int causal,
                     float scale, float scale_log2) {
  using L = DqLayout<D>;
  extern __shared__ char smem_raw[];
  char *smem = align_1024(smem_raw);
  bf16 *sq = reinterpret_cast<bf16 *>(smem + L::Q);
  bf16 *sdo = reinterpret_cast<bf16 *>(smem + L::DO);
  bf16 *sk = reinterpret_cast<bf16 *>(smem + L::K);
  bf16 *sv = reinterpret_cast<bf16 *>(smem + L::V);
  const float *slse = reinterpret_cast<const float *>(smem + L::LSE);
  const float *sdd = reinterpret_cast<const float *>(smem + L::DD);
  bf16 *stg = reinterpret_cast<bf16 *>(smem + L::STG);
  uint64_t *q_full = reinterpret_cast<uint64_t *>(smem + L::BAR);
  uint64_t *full = q_full + 1, *empty = full + STAGES;

  // Heaviest first: later q tiles see more kv tiles under the causal mask.
  const int bh = blockIdx.x % bh_count;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / bh_count;
  const int q0 = qt * L::BQ;
  // Kv tiles past seq_len are never loaded; under the causal mask the last
  // is the one that holds the tile's last row. Rows of q past seq_len carry
  // dO = 0 and D = 0, so their dQ is 0.
  int n_kt = (seq_len + L::BK - 1) / L::BK;
  if (causal) n_kt = min(n_kt, (q0 + L::BQ - 1) / L::BK + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * L::TILE_Q + 2 * L::VEC);
      for (int cb = 0; cb < L::CB; ++cb) {
        tma_load_3d(sq + cb * L::BQ * BOX_COLS, &tm_q, q_full, cb * BOX_COLS, q0, bh);
        tma_load_3d(sdo + cb * L::BQ * BOX_COLS, &tm_do, q_full, cb * BOX_COLS, q0, bh);
      }
      tma_load_2d(smem + L::LSE, &tm_lse, q_full, q0, bh);
      tma_load_2d(smem + L::DD, &tm_dd, q_full, q0, bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * L::TILE_KV);
        bf16 *k_dst = sk + s * L::BK * D, *v_dst = sv + s * L::BK * D;
        for (int cb = 0; cb < L::CB; ++cb) {
          tma_load_3d(k_dst + cb * L::BK * BOX_COLS, &tm_k, &full[s], cb * BOX_COLS, kt * L::BK, bh);
          tma_load_3d(v_dst + cb * L::BK * BOX_COLS, &tm_v, &full[s], cb * BOX_COLS, kt * L::BK, bh);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup w owns q rows [q0 + 64 w, q0 + 64 w + 64) ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int w = wg - 1, t = threadIdx.x % 128;
    const int row = w * 64 + (t / 32) * 16 + (t % 32) / 4;   // tile row of the thread's first row
    const int q_pos[2] = {q0 + row, q0 + row + 8};
    const int c2 = 2 * (t % 4);
    const int w_last = q0 + w * 64 + 63;                       // the warpgroup's last row
    const bf16 *sq_w = sq + w * 64 * BOX_COLS, *sdo_w = sdo + w * 64 * BOX_COLS;

    float dqa[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqa[i] = 0.0f;

    mbar_wait(q_full, 0);
    float lse2[2], dd[2];   // the thread's two rows: lse in base 2, and D
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lse2[h] = slse[row + 8 * h] * LOG2E;
      dd[h] = sdd[row + 8 * h];
    }

    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % STAGES, k0 = kt * L::BK;
      mbar_wait(&full[s], (kt / STAGES) & 1);
      if (causal && k0 > w_last) {   // wholly above this warpgroup's diagonal: adds nothing
        mbar_arrive(&empty[s]);
        continue;
      }
      const bf16 *sk_s = sk + s * L::BK * D, *sv_s = sv + s * L::BK * D;

      // S = Q K^T and dP = dO V^T: [64 x 64] f32 each, in registers.
      float sc[32], dp[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int own = (kk / 4) * L::BQ * BOX_COLS + (kk % 4) * 16;
        const int streamed = (kk / 4) * L::BK * BOX_COLS + (kk % 4) * 16;
        wgmma_ss(sc, smem_desc(sq_w + own, 16), smem_desc(sk_s + streamed, 16), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int own = (kk / 4) * L::BQ * BOX_COLS + (kk % 4) * 16;
        const int streamed = (kk / 4) * L::BK * BOX_COLS + (kk % 4) * 16;
        wgmma_ss(dp, smem_desc(sdo_w + own, 16), smem_desc(sv_s + streamed, 16), kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(sc);
      fence_regs(dp);

      // P = exp(S scale - lse[row]), dS = P (dP - D[row]); masked P is exactly 0.
      const bool masked = k0 + L::BK > seq_len || (causal && k0 + L::BK - 1 > q0 + w * 64);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 4 * j + e, h = e >> 1;
          float p = exp2f(sc[r] * scale_log2 - lse2[h]);
          if (masked && !visible(q_pos[h], k0 + 8 * j + c2 + (e & 1), seq_len, causal)) p = 0.0f;
          dp[r] = p * (dp[r] - dd[h]);
        }

      // dQ += dS K: dS (bf16) from registers, K MN-major from the stage.
      uint32_t dsa[4][4];
      to_operands<4>(dp, dsa);
      fence_regs(dqa);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) wgmma_rs(dqa, dsa[kc], smem_desc(sk_s + kc * 16 * BOX_COLS, L::BK * ROW_BYTES));
      wgmma_commit();
      wgmma_wait();
      fence_regs(dqa);
      mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqa[i] *= scale;
    store_rows<D>(dqa, stg + w * 64 * (D + 8), dq + static_cast<size_t>(bh) * t_pad * D, q0 + w * 64, t_pad, t,
                  1 + w);
  }
}

// ---------------------------------------------------------------------------
// backward: dK and dV (K4)
// ---------------------------------------------------------------------------

template <int D> struct DkvLayout {
  static constexpr int BK = 128, BQ = 64, CB = D / BOX_COLS;
  static constexpr int TILE_KV = BK * D * 2, TILE_Q = BQ * D * 2, VEC = BQ * 4;   // bytes
  static constexpr int K = 0, V = K + TILE_KV, Q = V + TILE_KV, DO = Q + STAGES * TILE_Q;
  static constexpr int LSE = DO + STAGES * TILE_Q, DD = LSE + STAGES * VEC, STG = DD + STAGES * VEC;
  static constexpr int BAR = STG + BK * (D + 8) * 2;
  static constexpr int SMEM = BAR + 8 * (1 + 2 * STAGES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_lse, const __grid_constant__ CUtensorMap tm_dd,
                      bf16 *__restrict__ dk, bf16 *__restrict__ dv, int bh_count, int n_kt, int t_pad,
                      int seq_len, int causal, float scale, float scale_log2) {
  using L = DkvLayout<D>;
  extern __shared__ char smem_raw[];
  char *smem = align_1024(smem_raw);
  bf16 *sk = reinterpret_cast<bf16 *>(smem + L::K);
  bf16 *sv = reinterpret_cast<bf16 *>(smem + L::V);
  bf16 *sq = reinterpret_cast<bf16 *>(smem + L::Q);
  bf16 *sdo = reinterpret_cast<bf16 *>(smem + L::DO);
  float *slse = reinterpret_cast<float *>(smem + L::LSE);
  float *sdd = reinterpret_cast<float *>(smem + L::DD);
  bf16 *stg = reinterpret_cast<bf16 *>(smem + L::STG);
  uint64_t *kv_full = reinterpret_cast<uint64_t *>(smem + L::BAR);
  uint64_t *full = kv_full + 1, *empty = full + STAGES;

  // Heaviest first: early kv tiles see more q tiles under the causal mask.
  const int bh = blockIdx.x % bh_count;
  const int k0 = (static_cast<int>(blockIdx.x) / bh_count) * L::BK;
  // A kv tile past seq_len sees nothing (all of P is 0): its loop is empty.
  // Rows of q past seq_len carry dO = 0 and D = 0 and add nothing.
  const int qt_end = k0 < seq_len ? (seq_len + L::BQ - 1) / L::BQ : 0;
  const int qt_begin = causal ? k0 / L::BQ : 0;   // the diagonal q tile
  const int n_q = max(qt_end - qt_begin, 0);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * L::TILE_KV);
      for (int cb = 0; cb < L::CB; ++cb) {
        tma_load_3d(sk + cb * L::BK * BOX_COLS, &tm_k, kv_full, cb * BOX_COLS, k0, bh);
        tma_load_3d(sv + cb * L::BK * BOX_COLS, &tm_v, kv_full, cb * BOX_COLS, k0, bh);
      }
      for (int i = 0; i < n_q; ++i) {
        const int s = i % STAGES, q0 = (qt_begin + i) * L::BQ;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * L::TILE_Q + 2 * L::VEC);
        bf16 *q_dst = sq + s * L::BQ * D, *do_dst = sdo + s * L::BQ * D;
        for (int cb = 0; cb < L::CB; ++cb) {
          tma_load_3d(q_dst + cb * L::BQ * BOX_COLS, &tm_q, &full[s], cb * BOX_COLS, q0, bh);
          tma_load_3d(do_dst + cb * L::BQ * BOX_COLS, &tm_do, &full[s], cb * BOX_COLS, q0, bh);
        }
        tma_load_2d(slse + s * L::BQ, &tm_lse, &full[s], q0, bh);
        tma_load_2d(sdd + s * L::BQ, &tm_dd, &full[s], q0, bh);
      }
    }
  } else {
    // ---- consumers: warpgroup w owns kv rows [k0 + 64 w, k0 + 64 w + 64) ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int w = wg - 1, t = threadIdx.x % 128;
    const int row = w * 64 + (t / 32) * 16 + (t % 32) / 4;
    const int k_pos[2] = {k0 + row, k0 + row + 8};
    const int c2 = 2 * (t % 4);
    const bf16 *sk_w = sk + w * 64 * BOX_COLS, *sv_w = sv + w * 64 * BOX_COLS;
    const bool k_masked = k0 + w * 64 + 63 >= seq_len;

    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.0f;

    mbar_wait(kv_full, 0);
    for (int i = 0; i < n_q; ++i) {
      const int s = i % STAGES, q0 = (qt_begin + i) * L::BQ;
      mbar_wait(&full[s], (i / STAGES) & 1);
      const bf16 *sq_s = sq + s * L::BQ * D, *sdo_s = sdo + s * L::BQ * D;
      const float *lse_s = slse + s * L::BQ, *dd_s = sdd + s * L::BQ;

      // S^T = K Q^T and dP^T = V dO^T: [64 x 64] f32 each, in registers.
      float st[32], dpt[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) st[j] = dpt[j] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int own = (kk / 4) * L::BK * BOX_COLS + (kk % 4) * 16;
        const int streamed = (kk / 4) * L::BQ * BOX_COLS + (kk % 4) * 16;
        wgmma_ss(st, smem_desc(sk_w + own, 16), smem_desc(sq_s + streamed, 16), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int own = (kk / 4) * L::BK * BOX_COLS + (kk % 4) * 16;
        const int streamed = (kk / 4) * L::BQ * BOX_COLS + (kk % 4) * 16;
        wgmma_ss(dpt, smem_desc(sv_w + own, 16), smem_desc(sdo_s + streamed, 16), kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(st);
      fence_regs(dpt);

      // P^T = exp(S^T scale - lse[col]), dS^T = P^T (dP^T - D[col]).
      const bool masked = k_masked || q0 + L::BQ > t_pad || (causal && q0 < k0 + w * 64 + 63);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + c2 + e;
          const float lse2 = lse_s[col] * LOG2E, dd = dd_s[col];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 4 * j + 2 * h + e;
            float p = exp2f(st[r] * scale_log2 - lse2);
            if (masked && !(q0 + col < t_pad && visible(q0 + col, k_pos[h], seq_len, causal))) p = 0.0f;
            st[r] = p;
            dpt[r] = p * (dpt[r] - dd);
          }
        }

      // dV += P^T dO, dK += dS^T Q: A from registers, B MN-major from the stage.
      uint32_t pa[4][4], dsa[4][4];
      to_operands<4>(st, pa);
      to_operands<4>(dpt, dsa);
      fence_regs(dva);
      fence_regs(dka);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) wgmma_rs(dva, pa[kc], smem_desc(sdo_s + kc * 16 * BOX_COLS, L::BQ * ROW_BYTES));
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) wgmma_rs(dka, dsa[kc], smem_desc(sq_s + kc * 16 * BOX_COLS, L::BQ * ROW_BYTES));
      wgmma_commit();
      wgmma_wait();
      fence_regs(dva);
      fence_regs(dka);
      mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] *= scale;
    const size_t slab = static_cast<size_t>(bh) * t_pad * D;
    bf16 *stg_w = stg + w * 64 * (D + 8);
    store_rows<D>(dka, stg_w, dk + slab, k0 + w * 64, t_pad, t, 1 + w);
    store_rows<D>(dva, stg_w, dv + slab, k0 + w * 64, t_pad, t, 1 + w);
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps and launchers
// ---------------------------------------------------------------------------

constexpr int ERR_NO_ENCODER = -1, ERR_ENCODE = -2, ERR_HEAD_DIM = -3, ERR_KERNEL = -4;

using EncodeTiled = CUresult (*)(CUtensorMap *, CUtensorMapDataType, cuuint32_t, void *, const cuuint64_t *,
                                 const cuuint64_t *, const cuuint32_t *, const cuuint32_t *, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the libcuda.so.1 the runtime has loaded (no -lcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = []() -> EncodeTiled {
    void *lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// [BH, T_pad, D] bf16, boxes of [box_rows][64] with the 128-byte swizzle;
// rows past T_pad read as zeros.
int map_rows(CUtensorMap *map, const void *base, int bh, int t_pad, int d, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(t_pad),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2, static_cast<cuuint64_t>(t_pad) * d * 2};
  const cuuint32_t box[3] = {BOX_COLS, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  if (encoder() == nullptr) return ERR_NO_ENCODER;
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void *>(base), dims, strides, box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : ERR_ENCODE;
}

// [BH, T_pad] f32, boxes of 64 entries of one row; entries past T_pad read as zeros.
int map_vec(CUtensorMap *map, const void *base, int bh, int t_pad, int box) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(t_pad), static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(t_pad) * 4};
  const cuuint32_t boxes[2] = {static_cast<cuuint32_t>(box), 1};
  const cuuint32_t unit[2] = {1, 1};
  if (encoder() == nullptr) return ERR_NO_ENCODER;
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void *>(base), dims, strides, boxes, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : ERR_ENCODE;
}

template <int D>
int launch_fwd(const void *q, const void *k, const void *v, void *out, void *lse, int bh, int t_pad, int seq_len,
               int causal, float scale, cudaStream_t stream) {
  using L = FwdLayout<D>;
  CUtensorMap mq, mk, mv;
  int err;
  if ((err = map_rows(&mq, q, bh, t_pad, D, L::BQ)) || (err = map_rows(&mk, k, bh, t_pad, D, L::BK)) ||
      (err = map_rows(&mv, v, bh, t_pad, D, L::BK)))
    return err;
  auto kernel = flash_fwd_sm90_kernel<D>;
  cudaError_t cerr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int n_qt = (t_pad + L::BQ - 1) / L::BQ;
  kernel<<<static_cast<unsigned>(bh) * n_qt, NT, L::SMEM, stream>>>(
      mq, mk, mv, static_cast<bf16 *>(out), static_cast<float *>(lse), bh, n_qt, t_pad, seq_len, causal,
      scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void *q, const void *k, const void *v, const void *dout, const void *lse, const void *dd,
              void *dq, int bh, int t_pad, int seq_len, int causal, float scale, cudaStream_t stream) {
  using L = DqLayout<D>;
  CUtensorMap mq, mk, mv, mdo, mlse, mdd;
  int err;
  if ((err = map_rows(&mq, q, bh, t_pad, D, L::BQ)) || (err = map_rows(&mk, k, bh, t_pad, D, L::BK)) ||
      (err = map_rows(&mv, v, bh, t_pad, D, L::BK)) || (err = map_rows(&mdo, dout, bh, t_pad, D, L::BQ)) ||
      (err = map_vec(&mlse, lse, bh, t_pad, L::BQ)) || (err = map_vec(&mdd, dd, bh, t_pad, L::BQ)))
    return err;
  auto kernel = flash_dq_sm90_kernel<D>;
  cudaError_t cerr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int n_qt = (t_pad + L::BQ - 1) / L::BQ;
  kernel<<<static_cast<unsigned>(bh) * n_qt, NT, L::SMEM, stream>>>(
      mq, mk, mv, mdo, mlse, mdd, static_cast<bf16 *>(dq), bh, n_qt, t_pad, seq_len, causal, scale,
      scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void *q, const void *k, const void *v, const void *dout, const void *lse, const void *dd,
               void *dk, void *dv, int bh, int t_pad, int seq_len, int causal, float scale, cudaStream_t stream) {
  using L = DkvLayout<D>;
  CUtensorMap mq, mk, mv, mdo, mlse, mdd;
  int err;
  if ((err = map_rows(&mq, q, bh, t_pad, D, L::BQ)) || (err = map_rows(&mk, k, bh, t_pad, D, L::BK)) ||
      (err = map_rows(&mv, v, bh, t_pad, D, L::BK)) || (err = map_rows(&mdo, dout, bh, t_pad, D, L::BQ)) ||
      (err = map_vec(&mlse, lse, bh, t_pad, L::BQ)) || (err = map_vec(&mdd, dd, bh, t_pad, L::BQ)))
    return err;
  auto kernel = flash_dkv_sm90_kernel<D>;
  cudaError_t cerr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int n_kt = (t_pad + L::BK - 1) / L::BK;
  kernel<<<static_cast<unsigned>(bh) * n_kt, NT, L::SMEM, stream>>>(
      mq, mk, mv, mdo, mlse, mdd, static_cast<bf16 *>(dk), static_cast<bf16 *>(dv), bh, n_kt, t_pad, seq_len,
      causal, scale, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

template <int D> int smem_bytes(int kernel) {
  switch (kernel) {
    case 0: return FwdLayout<D>::SMEM;
    case 1: return DkvLayout<D>::SMEM;
    case 2: return DqLayout<D>::SMEM;
  }
  return ERR_KERNEL;
}

}  // namespace

// Pointers are device pointers to contiguous bf16 [BH, T_pad, D] tensors
// (lse, dd: f32 [BH, T_pad]), each 16-byte aligned; T_pad is a multiple of
// 8. lse may be null in flash_fwd_sm90 (no logsumexp rows are written).
extern "C" {

int flash_fwd_sm90(const void *q, const void *k, const void *v, void *out, void *lse, int bh, int t_pad, int d,
                   int seq_len, int causal, float scale, void *stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_fwd<64>(q, k, v, out, lse, bh, t_pad, seq_len, causal, scale, s);
  if (d == 128) return launch_fwd<128>(q, k, v, out, lse, bh, t_pad, seq_len, causal, scale, s);
  return ERR_HEAD_DIM;
}

int flash_dq_sm90(const void *q, const void *k, const void *v, const void *dout, const void *lse, const void *dd,
                  void *dq, int bh, int t_pad, int d, int seq_len, int causal, float scale, void *stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_dq<64>(q, k, v, dout, lse, dd, dq, bh, t_pad, seq_len, causal, scale, s);
  if (d == 128) return launch_dq<128>(q, k, v, dout, lse, dd, dq, bh, t_pad, seq_len, causal, scale, s);
  return ERR_HEAD_DIM;
}

int flash_dkv_sm90(const void *q, const void *k, const void *v, const void *dout, const void *lse, const void *dd,
                   void *dk, void *dv, int bh, int t_pad, int d, int seq_len, int causal, float scale,
                   void *stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_dkv<64>(q, k, v, dout, lse, dd, dk, dv, bh, t_pad, seq_len, causal, scale, s);
  if (d == 128) return launch_dkv<128>(q, k, v, dout, lse, dd, dk, dv, bh, t_pad, seq_len, causal, scale, s);
  return ERR_HEAD_DIM;
}

// Dynamic shared memory of a launch: kernel 0 = flash_fwd_sm90, 1 = flash_dkv_sm90, 2 = flash_dq_sm90.
int flash_sm90_smem_bytes(int kernel, int d) {
  if (d == 64) return smem_bytes<64>(kernel);
  if (d == 128) return smem_bytes<128>(kernel);
  return ERR_HEAD_DIM;
}

}  // extern "C"
