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
//
// The overlap probe (overlap.cu, P3) runs its GEMMs on these two kernels
// with a third epilogue (Bf16Store) and asks whether CUDA-core work hides
// under the products: a kernel's `Side` policy adds a fourth warpgroup that
// runs such work beside the consumers, or has the consumers run slices of it
// between issuing a K slice's wgmma and waiting for it. K4 and K5 take
// NoSide, which adds nothing.

#pragma once

#include <math.h>

#include "hopper.cuh"  // mbarriers, TMA, wgmma, tensor maps, the SM count

namespace axvs_mlp {

using namespace axvs_hopper;

constexpr int BM = 128;       // rows of a tile
constexpr int STAGES = 5;     // K slices in flight
constexpr int MAX_C = 1536;   // the checked limit on C (ConvNeXt-L's widest)

// Work beside the products: none. A Side policy gives the block's
// warpgroups (0-1 compute, 2 loads; with WARPGROUPS = 4, warpgroup 3 runs
// `warpgroup()` with SIDE_REGS registers), their registers after setmaxnreg
// (the four counts sum to 512, 128 threads each taking the SM's 65,536),
// and a consumer warpgroup's `Slice` for the K slices it will run in the
// launch: step() runs after each K slice's wgmma is issued and before its
// wait, finish() after the warpgroup's last tile.
struct NoSide {
  static constexpr int WARPGROUPS = 3;
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  struct Slice {
    __device__ __forceinline__ void step() {}
    __device__ __forceinline__ void finish() {}
  };
  __device__ __forceinline__ Slice consumer(int /*steps*/) const { return Slice{}; }
};

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

// The overlap probe's phases (P3): d = bf16(acc), no bias, GELU or residual.
struct Bf16Store {
  bf16* __restrict__ d;
  int ld;
  template <int BN>
  __device__ __forceinline__ void tile(const float (&acc)[BN / 2], int r0, int cb, int M,
                                       int N) const {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = cb + 8 * j;
      if (col >= N) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + 8 * half;
        if (row < M) {
          *reinterpret_cast<__nv_bfloat162*>(d + (size_t)row * ld + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
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

// Warpgroups 2 (the producer) and 3 (the side work, where the policy has
// one) give up their registers and run their work; true for them, false for
// the consumers, which take theirs.
template <class Side, int BN>
__device__ __forceinline__ bool run_helpers(int wg, const Ring<BN>& r, const CUtensorMap* ta,
                                            const CUtensorMap* tb, int tiles, int n_tiles,
                                            int ksteps, const Side& side) {
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Side::PRODUCER_REGS) : "memory");
    if (threadIdx.x == 256) produce(r, ta, tb, tiles, n_tiles, ksteps);
    return true;
  }
  if constexpr (Side::WARPGROUPS == 4) {
    if (wg == 3) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Side::SIDE_REGS) : "memory");
      side.warpgroup();
      return true;
    }
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Side::CONSUMER_REGS) : "memory");
  return false;
}

// Phase 2's kernel, cooperative: consumer warpgroup c takes rows 64 c ..
// 64 c + 63 of every tile of the block.
template <int BN, class Epi, class Side = NoSide>
__global__ void __launch_bounds__(Side::WARPGROUPS * 128, 1)
gemm_cooperative_kernel(const __grid_constant__ CUtensorMap ta,
                        const __grid_constant__ CUtensorMap tb, int M, int N, int K, Epi epi,
                        Side side) {
  extern __shared__ unsigned char smem_raw[];
  const Ring<BN> r = carve<BN>(smem_raw);
  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * n_tiles;
  const int ksteps = (K + BK - 1) / BK;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) init_barriers(r, 2);
  __syncthreads();

  if (run_helpers(wg, r, &ta, &tb, tiles, n_tiles, ksteps, side)) return;
  const int c = wg;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const bool leader = (threadIdx.x & 127) == 0;
  const int my_tiles = blockIdx.x < tiles ? (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  typename Side::Slice slice = side.consumer(my_tiles * ksteps);
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
      slice.step();
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
  slice.finish();
}

// Phase 1's kernel, ping-pong: the two consumer warpgroups take whole tiles
// in turn (local tiles 0, 2, ... and 1, 3, ...), so that one's epilogue runs
// while the other's products keep the tensor cores busy. order[c] lets
// warpgroup c start a tile's products only once the other has issued all of
// the previous tile's: the ring is consumed in order, and no wait on a slot
// runs more than one phase ahead of it (a parity wait cannot tell further).
template <int BN, class Epi, class Side = NoSide>
__global__ void __launch_bounds__(Side::WARPGROUPS * 128, 1)
gemm_pingpong_kernel(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tb, int M, int N, int K, Epi epi,
                     Side side) {
  extern __shared__ unsigned char smem_raw[];
  const Ring<BN> r = carve<BN>(smem_raw);
  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * n_tiles;
  const int ksteps = (K + BK - 1) / BK;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) init_barriers(r, 1);
  __syncthreads();

  if (run_helpers(wg, r, &ta, &tb, tiles, n_tiles, ksteps, side)) return;
  const int c = wg;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const bool leader = (threadIdx.x & 127) == 0;
  const int first = blockIdx.x + c * gridDim.x;  // this warpgroup's tiles: every other one
  const int my_tiles = first < tiles ? (tiles - first + 2 * gridDim.x - 1) / (2 * gridDim.x) : 0;
  typename Side::Slice slice = side.consumer(my_tiles * ksteps);
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
      slice.step();
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
  slice.finish();
}

// D = A B^T through `kernel` (a BN-wide tile kernel): A (M, K) and B (N, K)
// bf16, row-major; every D element pair goes to epi; `side` runs beside the
// products. One persistent block an SM. 0 or a CUDA error code.
template <int BN, class Epi, class Side = NoSide>
inline int launch_gemm(void (*kernel)(CUtensorMap, CUtensorMap, int, int, int, Epi, Side),
                       const void* a, const void* b, int M, int N, int K, const Epi& epi,
                       cudaStream_t stream, const Side& side = Side()) {
  CUtensorMap ta, tb;
  int status = make_map(&ta, a, M, K, BM);
  if (!status) status = make_map(&tb, b, N, K, BN);
  if (status) return status;
  const size_t smem = Ring<BN>::SMEM_BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, Side::WARPGROUPS * 128, smem, stream>>>(ta, tb, M, N, K, epi, side);
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
