// The ConvNeXt block's MLP tail for Hopper, shared by the fused MLP kernel
// (convnext_mlp.cu, K5) and the fused block kernel (convnext_block.cu, K4):
//   out[r] = resid[r] + gamma * (b2 + gelu_tanh(x[r] @ W1^T + b1) @ W2^T)
// with the TPU kernels' rounding points: both products take bf16 operands and
// accumulate in f32, b1 is added and the tanh-form GELU taken in f32, the
// hidden activation is cast to bf16 before the second product, and the
// residual sum is f32 with one cast at the end.
//
// Two GEMM phases, launched one after the other on the caller's stream:
//   phase 1: h   = bf16(gelu_tanh(x @ W1^T + b1))          (P, HID) workspace
//   phase 2: out = bf16(resid + gamma * (h @ W2^T + b2))    (P, C)
// Both are TN products on torch's (out, in) layouts: every operand is K-major
// (rows of K contiguous elements), so nothing is transposed.
//
// What bounds it on an H100: operations (16 P C^2 bf16 FLOPs a call, 76 GFLOP
// at every ConvNeXt-L stage of a 2x769x1345 clip). The first version of this
// kernel kept the whole R x C accumulator of 16-64 rows in warp-level
// (mma.sync-class) fragments and re-read all of W1 and W2 from L2 for every
// such tile, synchronously; it ran 20x off the bound. Here every operand
// byte brought on chip serves a tile of 128 x 128 or 128 x 192 outputs,
// the loads run ahead of the tensor cores, and the hidden activation goes
// through device memory (49.5 MB a call at stage 2, about the L2's size;
// 198 MB at stage 0) so that the hidden and output columns are tiled too
// and every stage fills the card.
//
// Each phase is one persistent, warp-specialised GEMM kernel of three
// warpgroups, one block an SM, walking the (row tile, column tile) grid in
// row-major order of row tiles with a stride of the grid size, so that the
// blocks in flight share their row tiles of A in L2. Warpgroup 2 gives up
// its registers (setmaxnreg: 40 a thread, the consumers take 232) and one of
// its threads keeps TMA loads of the next K slices of A (128 x 64) and B
// (BN x 64) in flight, through a ring of STAGES slots in shared memory
// guarded by mbarriers (full: the bytes have landed; empty: the consumers are
// done with the slot). Warpgroups 0 and 1 run wgmma m64nBNk16 (bf16 in, f32
// accumulators in registers) straight from the 128-byte-swizzled slices that
// TMA wrote; the tensor maps and the wgmma descriptors use the same 128B
// swizzle, so the layout needs no reshuffle. TMA fills rows and columns past
// the ends of A and B with zeros, so ragged K, N and rows need only the
// epilogue's masks. While the consumers run an epilogue, the producer
// already loads the next tile's slices.
//
// The two phases schedule their consumers differently, as measured on the
// card (PERF.md, section 6):
// - phase 1 (the GELU epilogue, 4C wide): ping-pong. Each consumer
//   warpgroup takes whole 128 x 128 tiles in turn, so one's GELU and stores
//   run while the other's products keep the tensor cores busy; an ordered
//   pair of mbarriers hands the tensor cores from one to the other;
// - phase 2 (the residual epilogue, C wide): cooperative. Both consumer
//   warpgroups take 64 rows of one 128 x 192 tile; 192 divides every
//   ConvNeXt width (192 x 2^s), and the wider tile brings fewer bytes from
//   L2 per product.
// The epilogues (bias, GELU or layer scale and residual, the bf16 cast) run
// on the accumulator registers and store bf16 pairs; their loads go through
// the read-only path in batches, ahead of the batch's stores.
//
// This is the first version written for this card: no 2-CTA cluster sharing
// the weight tile by multicast, no stmatrix/TMA store of the epilogue, and no
// overlap of K4's depthwise conv with the GEMMs; these are left for later.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (cuTensorMapEncodeTiled is looked up at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace axvs_mlp {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;       // rows of a tile
constexpr int BK = 64;        // depth of a K slice: 128 bytes, one swizzle row
constexpr int STAGES = 5;     // K slices in flight
constexpr int THREADS = 384;  // warpgroups 0-1 compute, warpgroup 2 loads
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // after setmaxnreg
constexpr int MAX_C = 1536;   // the checked limit on C (ConvNeXt-L's widest)

// The shared-memory ring of a BN-wide tile: STAGES slots of A (BM x BK) and
// B (BN x BK), their full and empty mbarriers, and the ping-pong's two order
// barriers; the ring starts at a 1024-byte boundary (the period of the
// 128-byte swizzle, which the wgmma descriptors assume).
template <int BN>
struct Ring {
  static constexpr int A_TILE = BM * BK, B_TILE = BN * BK;  // elements of a slot
  static constexpr uint32_t STAGE_BYTES = (A_TILE + B_TILE) * 2;
  static constexpr size_t SMEM_BYTES = (size_t)STAGES * STAGE_BYTES + (2 * STAGES + 2) * 8 + 1024;
  bf16* a;
  bf16* b;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* order;
};

__device__ __forceinline__ float gelu_tanh(float h) {
  return 0.5f * h * (1.f + tanhf(0.7978845608028654f * (h + 0.044715f * h * h * h)));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Spins until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box at (c0 = column, c1 = row) of the map into dst; completion is
// counted in bytes on bar.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major operand in 128-byte-swizzled shared memory:
// rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(const bf16* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d[64 x N] += A[64 x 16] B[N x 16]^T, bf16 operands from shared memory,
// f32 accumulators: thread t of the warpgroup holds rows 16 (t / 32) + (t % 32)
// / 4 (+ 8) and columns 8 j + 2 (t % 4) (+ 1) in d[4 j .. 4 j + 3].
template <int N>
__device__ __forceinline__ void wgmma_m64k16(float (&d)[N / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_m64k16<128>(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_m64k16<192>(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

// The epilogues take all of one thread's accumulators of a 64-row half
// tile: rows r0 and r0 + 8, columns cb + 8 j (+ 1) in acc[4 j .. 4 j + 3].
// Their per-column vectors and the residual come in through the read-only
// path (__ldg) in batches, ahead of the batch's stores, so that the loads'
// latencies overlap instead of queueing behind stores the compiler could
// not otherwise prove disjoint.

// Phase 1: h[row, col..col+1] = bf16(gelu_tanh(acc + b1)).
struct GeluStore {
  const float* __restrict__ b1;
  bf16* __restrict__ h;
  int ld;
  template <int BN>
  __device__ __forceinline__ void tile(const float (&acc)[BN / 2], int r0, int cb, int M,
                                       int N) const {
    constexpr int BATCH = 8;  // column groups whose biases are loaded together
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += BATCH) {
      float2 bias[BATCH];
#pragma unroll
      for (int q = 0; q < BATCH; ++q) {
        const int col = cb + 8 * (j0 + q);
        bias[q] = col < N ? __ldg(reinterpret_cast<const float2*>(b1 + col))
                          : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int q = 0; q < BATCH; ++q) {
        const int j = j0 + q, col = cb + 8 * j;
        if (col >= N) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = r0 + 8 * half;
          const float v0 = gelu_tanh(acc[4 * j + 2 * half] + bias[q].x);
          const float v1 = gelu_tanh(acc[4 * j + 2 * half + 1] + bias[q].y);
          if (row < M) {
            *reinterpret_cast<__nv_bfloat162*>(h + (size_t)row * ld + col) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
  }
};

// Phase 2: out = bf16(resid + gamma * (acc + b2)), f32 inside.
struct ResidualStore {
  const float* __restrict__ b2;
  const float* __restrict__ gamma;
  const bf16* __restrict__ resid;
  bf16* __restrict__ out;
  int ld;
  template <int BN>
  __device__ __forceinline__ void tile(const float (&acc)[BN / 2], int r0, int cb, int M,
                                       int N) const {
    constexpr int BATCH = 4;  // column groups whose loads are in flight together
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += BATCH) {
      float2 g[BATCH], b[BATCH], r[BATCH][2];
#pragma unroll
      for (int q = 0; q < BATCH; ++q) {
        const int col = cb + 8 * (j0 + q);
        g[q] = b[q] = r[q][0] = r[q][1] = make_float2(0.f, 0.f);
        if (col < N) {
          g[q] = __ldg(reinterpret_cast<const float2*>(gamma + col));
          b[q] = __ldg(reinterpret_cast<const float2*>(b2 + col));
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = r0 + 8 * half;
            if (row < M) {
              r[q][half] = __bfloat1622float2(__ldg(
                  reinterpret_cast<const __nv_bfloat162*>(resid + (size_t)row * ld + col)));
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < BATCH; ++q) {
        const int j = j0 + q, col = cb + 8 * j;
        if (col >= N) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = r0 + 8 * half;
          if (row >= M) continue;
          const float o0 = r[q][half].x + g[q].x * (acc[4 * j + 2 * half] + b[q].x);
          const float o1 = r[q][half].y + g[q].y * (acc[4 * j + 2 * half + 1] + b[q].y);
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * ld + col) =
              __floats2bfloat162_rn(o0, o1);
        }
      }
    }
  }
};

template <int BN>
__device__ __forceinline__ Ring<BN> carve(unsigned char* smem_raw) {
  Ring<BN> r;
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  r.a = reinterpret_cast<bf16*>(base);
  r.b = r.a + STAGES * Ring<BN>::A_TILE;
  r.full = reinterpret_cast<uint64_t*>(r.b + STAGES * Ring<BN>::B_TILE);
  r.empty = r.full + STAGES;
  r.order = r.empty + STAGES;
  return r;
}

// One thread: sets up the barriers (each slot read by `readers` consumer
// warpgroups) before the block's __syncthreads.
template <int BN>
__device__ __forceinline__ void init_barriers(const Ring<BN>& r, uint32_t readers) {
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    mbar_init(&r.full[s], 1);  // the producer's arrive, plus the TMA bytes
    mbar_init(&r.empty[s], readers);
  }
  mbar_init(&r.order[0], 1);
  mbar_init(&r.order[1], 1);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The producer's one thread: the K slices of every tile of this block, in
// order, into the ring.
template <int BN>
__device__ __forceinline__ void produce(const Ring<BN>& r, const CUtensorMap* ta,
                                        const CUtensorMap* tb, int tiles, int n_tiles,
                                        int ksteps) {
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = t / n_tiles * BM, n0 = t % n_tiles * BN;
    for (int k = 0; k < ksteps; ++k, ++it) {
      const int s = it % STAGES;
      if (it >= STAGES) mbar_wait(&r.empty[s], ((it / STAGES) - 1) & 1);
      mbar_expect_tx(&r.full[s], Ring<BN>::STAGE_BYTES);  // whole boxes, zero-filled past the ends
      tma_load_2d(r.a + s * Ring<BN>::A_TILE, ta, &r.full[s], k * BK, m0);
      tma_load_2d(r.b + s * Ring<BN>::B_TILE, tb, &r.full[s], k * BK, n0);
    }
  }
}

// Phase 2's kernel, cooperative: consumer warpgroup c takes rows 64 c ..
// 64 c + 63 of every tile of the block.
template <int BN, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
gemm_cooperative_kernel(const __grid_constant__ CUtensorMap ta,
                        const __grid_constant__ CUtensorMap tb, int M, int N, int K, Epi epi) {
  extern __shared__ unsigned char smem_raw[];
  const Ring<BN> r = carve<BN>(smem_raw);
  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * n_tiles;
  const int ksteps = (K + BK - 1) / BK;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) init_barriers(r, 2);
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
    if (threadIdx.x == 256) produce(r, &ta, &tb, tiles, n_tiles, ksteps);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");
  const int c = wg;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const bool leader = (threadIdx.x & 127) == 0;
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = t / n_tiles * BM, n0 = t % n_tiles * BN;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int k = 0; k < ksteps; ++k, ++it) {
      const int s = it % STAGES;
      mbar_wait(&r.full[s], (it / STAGES) & 1);
      const bf16* a = r.a + s * Ring<BN>::A_TILE + c * 64 * BK;
      const bf16* b = r.b + s * Ring<BN>::B_TILE;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wgmma_m64k16<BN>(acc, sw128_desc(a + kk * 16), sw128_desc(b + kk * 16));
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous slice's products are done: free its slot
      fence_acc(acc);
      if (prev >= 0 && leader) mbar_arrive(&r.empty[prev]);
      prev = s;
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (leader) mbar_arrive(&r.empty[prev]);
    epi.template tile<BN>(acc, m0 + c * 64 + warp * 16 + (lane >> 2), n0 + 2 * (lane & 3), M,
                          N);
  }
}

// Phase 1's kernel, ping-pong: the two consumer warpgroups take whole tiles
// in turn (local tiles 0, 2, ... and 1, 3, ...), so that one's epilogue runs
// while the other's products keep the tensor cores busy. order[c] lets
// warpgroup c start a tile's products only once the other has issued all of
// the previous tile's: the ring is consumed in order, and no wait on a slot
// runs more than one phase ahead of it (a parity wait cannot tell further).
template <int BN, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
gemm_pingpong_kernel(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tb, int M, int N, int K, Epi epi) {
  extern __shared__ unsigned char smem_raw[];
  const Ring<BN> r = carve<BN>(smem_raw);
  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * n_tiles;
  const int ksteps = (K + BK - 1) / BK;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) init_barriers(r, 1);
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
    if (threadIdx.x == 256) produce(r, &ta, &tb, tiles, n_tiles, ksteps);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");
  const int c = wg;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const bool leader = (threadIdx.x & 127) == 0;
  for (int j = c, t = blockIdx.x + c * gridDim.x; t < tiles; j += 2, t += 2 * gridDim.x) {
    const int m0 = t / n_tiles * BM, n0 = t % n_tiles * BN;
    if (j > 0) mbar_wait(&r.order[c], ((j - 1) >> 1) & 1);
    float acc0[BN / 2], acc1[BN / 2];  // rows 0-63 and 64-127 of the tile
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      acc0[i] = 0.f;
      acc1[i] = 0.f;
    }
    int it = j * ksteps, prev = -1;
    for (int k = 0; k < ksteps; ++k, ++it) {
      const int s = it % STAGES;
      mbar_wait(&r.full[s], (it / STAGES) & 1);
      const bf16* a = r.a + s * Ring<BN>::A_TILE;
      const bf16* b = r.b + s * Ring<BN>::B_TILE;
      fence_acc(acc0);
      fence_acc(acc1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = sw128_desc(b + kk * 16);
        wgmma_m64k16<BN>(acc0, sw128_desc(a + kk * 16), db);
        wgmma_m64k16<BN>(acc1, sw128_desc(a + 64 * BK + kk * 16), db);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(acc0);
      fence_acc(acc1);
      if (prev >= 0 && leader) mbar_arrive(&r.empty[prev]);
      prev = s;
    }
    if (leader) mbar_arrive(&r.order[1 - c]);  // the other may start its next tile
    wgmma_wait<0>();
    fence_acc(acc0);
    fence_acc(acc1);
    if (leader) mbar_arrive(&r.empty[prev]);
    const int r0 = m0 + warp * 16 + (lane >> 2), cb = n0 + 2 * (lane & 3);
    epi.template tile<BN>(acc0, r0, cb, M, N);
    epi.template tile<BN>(acc1, r0 + 64, cb, M, N);
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time: the library is not linked
// against libcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// A tensor map of a row-major (rows, cols) bf16 matrix with boxes of
// box_rows x BK, 128-byte swizzle, zeros past the ends. 0 or a CUDA error.
inline int make_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// D = A B^T through `kernel` (a BN-wide tile kernel): A (M, K) and B (N, K)
// bf16, row-major; every D element pair goes to epi. One persistent block
// an SM. 0 or a CUDA error code.
template <int BN, class Epi>
inline int launch_gemm(void (*kernel)(CUtensorMap, CUtensorMap, int, int, int, Epi),
                       const void* a, const void* b, int M, int N, int K, const Epi& epi,
                       cudaStream_t stream) {
  CUtensorMap ta, tb;
  int status = make_map(&ta, a, M, K, BM);
  if (!status) status = make_map(&tb, b, N, K, BN);
  if (status) return status;
  const size_t smem = Ring<BN>::SMEM_BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, THREADS, smem, stream>>>(ta, tb, M, N, K, epi);
  return (int)cudaGetLastError();
}

// Both phases: x, resid, out (P, C) bf16; w1 (HID, C), w2 (C, HID) bf16;
// b1 (HID,), b2, gamma (C,) f32; h: a (P, HID) bf16 workspace. Pointers
// 16-byte aligned, C and HID multiples of 16. 0 or a CUDA error code.
inline int run(const void* x, const void* resid, const void* w1, const void* b1,
               const void* w2, const void* b2, const void* gamma, void* out, void* h, int P,
               int C, int HID, cudaStream_t stream) {
  const GeluStore gelu{(const float*)b1, (bf16*)h, HID};
  const int err = launch_gemm<128>(gemm_pingpong_kernel<128, GeluStore>, x, w1, P, HID, C,
                                   gelu, stream);
  if (err) return err;
  const ResidualStore residual{(const float*)b2, (const float*)gamma, (const bf16*)resid,
                               (bf16*)out, C};
  return launch_gemm<192>(gemm_cooperative_kernel<192, ResidualStore>, h, w2, P, C, HID,
                          residual, stream);
}

}  // namespace axvs_mlp
