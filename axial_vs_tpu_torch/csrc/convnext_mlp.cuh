// The ConvNeXt block's MLP tail on one tile of rows, shared by the fused MLP
// kernel (convnext_mlp.cu, K5) and the fused block kernel (convnext_block.cu,
// K4):
//   out[r] = resid[r] + gamma * (b2 + gelu_tanh(xs[r] @ W1^T + b1) @ W2^T)
// with the TPU kernels' rounding points: both products take bf16 operands and
// accumulate in f32, b1 is added and the tanh-form GELU taken in f32, the
// hidden activation is cast to bf16 before the second product, and the
// residual sum is f32 with one cast at the end.
//
// A tile is R = 16 * RT rows of C channels, already in shared memory as bf16.
// A block of 8 warps walks the hidden axis (HID = 4C in ConvNeXt) in chunks of
// HC = 128 columns: in each chunk every warp computes one 16-column tile of
// h = gelu(x W1^T + b1) for all R rows on the tensor cores (wmma bf16
// 16x16x16, f32 accumulators) and writes it to shared memory as bf16; then
// every warp adds h @ W2^T[chunk] into the output columns it owns. A warp owns
// the 16-column output tiles j = warp, warp + 8, ... and keeps their f32 sums
// in wmma accumulator fragments for the whole hidden loop (RT x MAXT of them),
// so the R x C accumulator never leaves registers and the R x HID hidden
// activation never exists in full. Weight fragments are read straight from
// device memory (L2) in torch's (out, in) layout, each once per block.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

namespace axvs_mlp {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int HC = WARPS * 16;  // hidden columns per chunk: one tile per warp
constexpr int PAD = 8;          // bf16 padding of a shared row (bank spread)
constexpr int MAX_C = 12 * 16 * WARPS;  // 1536: 12 output tiles per warp

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// Shared bytes of the hidden tile (R x (HC + PAD) bf16) and of the per-warp
// f32 staging tiles (16 x 16 each).
__host__ __device__ inline size_t hidden_bytes(int rows) {
  return align128((size_t)rows * (HC + PAD) * 2);
}
__host__ __device__ inline size_t stage_bytes() { return (size_t)WARPS * 256 * 4; }

// Output tiles per warp for C channels, rounded up to an instantiated count
// (1, 2, 3, 4, 6, 8 or 12). The launchers pair each with RT = min(4, 12 /
// MAXT) row tiles: at most 12 accumulator fragments (96 f32 registers) a
// thread.
__host__ __device__ inline int tiles_per_warp(int C) {
  const int t = (C / 16 + WARPS - 1) / WARPS;
  return t <= 4 ? t : t <= 6 ? 6 : t <= 8 ? 8 : 12;
}

__device__ __forceinline__ float gelu_tanh(float h) {
  return 0.5f * h * (1.f + tanhf(0.7978845608028654f * (h + 0.044715f * h * h * h)));
}

// Adds the MLP of the tile xs (R x C bf16, row stride xld) into acc.
// hs: R x (HC + PAD) bf16 scratch; stage: this warp's 256 f32 scratch.
// w1 (HID, C), w2 (C, HID): bf16, torch's (out, in) layout; b1 (HID,) f32.
template <int RT, int MAXT>
__device__ __forceinline__ void mlp_accumulate(
    const bf16* xs, int xld, bf16* hs, float* stage,
    const bf16* __restrict__ w1, const float* __restrict__ b1,
    const bf16* __restrict__ w2, int C, int HID, FragC (&acc)[RT][MAXT]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hld = HC + PAD;
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int t = 0; t < MAXT; ++t) wmma::fill_fragment(acc[rt][t], 0.f);

  for (int h0 = 0; h0 < HID; h0 += HC) {
    // h[:, n0:n0+16] = gelu(x @ W1[n0:n0+16, :]^T + b1), this warp's tile
    const int n0 = h0 + warp * 16;
    if (n0 < HID) {
      FragC hacc[RT];
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) wmma::fill_fragment(hacc[rt], 0.f);
      for (int k = 0; k < C / 16; ++k) {
        FragBt wf;
        wmma::load_matrix_sync(wf, w1 + (size_t)n0 * C + k * 16, C);
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
          FragA xa;
          wmma::load_matrix_sync(xa, xs + rt * 16 * xld + k * 16, xld);
          wmma::mma_sync(hacc[rt], xa, wf, hacc[rt]);
        }
      }
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
        wmma::store_matrix_sync(stage, hacc[rt], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = e >> 4, cc = e & 15;
          const float v = gelu_tanh(stage[e] + b1[n0 + cc]);
          hs[(rt * 16 + r) * hld + warp * 16 + cc] = __float2bfloat16_rn(v);
        }
        __syncwarp();
      }
    }
    __syncthreads();  // the chunk's h is complete

    // acc[:, j] += h @ W2[j, h0:h0+HC]^T for this warp's output tiles j
    const int kt = min(HC, HID - h0) / 16;
    for (int kk = 0; kk < kt; ++kk) {
      FragA ha[RT];
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
        wmma::load_matrix_sync(ha[rt], hs + rt * 16 * hld + kk * 16, hld);
#pragma unroll
      for (int t = 0; t < MAXT; ++t) {
        const int j = warp + WARPS * t;
        if (j * 16 < C) {
          FragBt wf;
          wmma::load_matrix_sync(wf, w2 + (size_t)j * 16 * HID + h0 + kk * 16, HID);
#pragma unroll
          for (int rt = 0; rt < RT; ++rt) wmma::mma_sync(acc[rt][t], ha[rt], wf, acc[rt][t]);
        }
      }
    }
    __syncthreads();  // hs is rewritten by the next chunk
  }
}

// out[p0 + r, :] = resid[p0 + r, :] + gamma * (acc[r, :] + b2) for the tile's
// first nvalid rows; resid and out are (rows, C) bf16 at row stride C.
template <int RT, int MAXT>
__device__ __forceinline__ void mlp_store(
    FragC (&acc)[RT][MAXT], float* stage, const float* __restrict__ b2,
    const float* __restrict__ gamma, const bf16* __restrict__ resid,
    bf16* __restrict__ out, size_t p0, int nvalid, int C) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < MAXT; ++t) {
    const int j = warp + WARPS * t;
    if (j * 16 >= C) continue;
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
      wmma::store_matrix_sync(stage, acc[rt][t], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = rt * 16 + (e >> 4), col = j * 16 + (e & 15);
        if (row < nvalid) {
          const size_t at = (p0 + row) * (size_t)C + col;
          const float o = __bfloat162float(resid[at]) + gamma[col] * (stage[e] + b2[col]);
          out[at] = __float2bfloat16_rn(o);
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace axvs_mlp
