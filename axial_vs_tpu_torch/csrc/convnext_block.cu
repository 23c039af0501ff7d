// Whole ConvNeXt block (inference), NHWC bf16 in and out:
//   y   = LayerNorm_C(dwconv7x7_same(x) + dw_bias) * ln_w + ln_b   (f32, cast bf16)
//   out = x + gamma * (gelu_tanh(y @ W1^T + b1) @ W2^T + b2)
//
// Replaces the TPU kernel axial_vs_tpu/ops/convnext_pallas.py::
// convnext_block_fused (Pallas body `_block_kernel`). Its rounding points are
// the TPU kernel's: f32 taps and LayerNorm, the normalised tile stored bf16
// (the TPU kernel's `dbuf`), then the MLP tail of convnext_mlp.cuh. So the
// result is K1's rounding followed by K5's.
//
// What bounds it on an H100: operations, as for the MLP alone (16 P C^2
// FLOPs, 76 GFLOP per call at every ConvNeXt-L stage of a 2x769x1345 clip);
// the 49-tap depthwise conv adds 98 P C f32 operations, and x is read and
// out written once, with no intermediate in device memory.
//
// Design: one block of 8 warps per tile of R = 16 RT consecutive pixels of
// one image row (the last tile of a row is ragged). A 7-row halo of the tile
// would not fit in shared memory at C = 1536 (7 x 22 x 1536 bf16 = 473 KB),
// so the depthwise part runs as in dwconv_ln.cu: a thread owns two channels
// of one 16-pixel segment, streams the 22 input pixels of each of the 7 rows
// along W from L1/L2 and adds each into the accumulators it touches
// (out-of-image taps are zero). The f32 results go to shared memory; each
// warp then normalises pixels with two warp reductions over C (mean, then the
// mean of squared deviations) and writes the bf16 tile, which the shared MLP
// body consumes. The residual is x itself, re-read (from L2) in the epilogue.
// The f32 buffer is reused for the hidden chunk and the staging tiles. The
// TPU kernel's software pipeline (the dw part of tile i against the MLP of
// tile i - 1, a VPU/MXU overlap) is not carried over.

#include "convnext_mlp.cuh"

namespace {

using namespace axvs_mlp;

constexpr int SEG = 16;  // pixels per depthwise segment

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ inline size_t region_bytes(int rows, int C) {
  const size_t f32 = (size_t)rows * C * 4;
  const size_t mlp = hidden_bytes(rows) + stage_bytes();
  return align128(f32 > mlp ? f32 : mlp);
}

template <int RT, int MAXT>
__global__ void __launch_bounds__(THREADS)
block_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,  // (C, 7, 7)
             const float* __restrict__ dwb, const float* __restrict__ ln_w,
             const float* __restrict__ ln_b, const bf16* __restrict__ w1,
             const float* __restrict__ b1, const bf16* __restrict__ w2,
             const float* __restrict__ b2, const float* __restrict__ gamma,
             bf16* __restrict__ out, int H, int W, int C, int HID, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int R = 16 * RT;
  const int xld = C + PAD;
  float* dbuf = (float*)smem;  // (R, C) f32: dwconv + bias
  bf16* xs = (bf16*)(smem + region_bytes(R, C));
  const int w0 = blockIdx.x * R, h = blockIdx.y, n = blockIdx.z;
  const int nvalid = W - w0 < R ? W - w0 : R;

  // ---- depthwise 7x7 + bias, f32, into dbuf ----
  const int pairs = C / 2;
  for (int it = threadIdx.x; it < pairs * RT; it += THREADS) {
    const int c = 2 * (it % pairs), ws = w0 + (it / pairs) * SEG;
    if (ws >= W) continue;  // a segment past the row's end: never read
    const float bb0 = dwb[c], bb1 = dwb[c + 1];
    float a0[SEG], a1[SEG];
#pragma unroll
    for (int p = 0; p < SEG; ++p) {
      a0[p] = bb0;
      a1[p] = bb1;
    }
    const bf16* w_c0 = wt + (size_t)c * 49;
    const bf16* w_c1 = w_c0 + 49;
    for (int dy = 0; dy < 7; ++dy) {
      const int y = h + dy - 3;
      if (y < 0 || y >= H) continue;
      float k0[7], k1[7];
#pragma unroll
      for (int dx = 0; dx < 7; ++dx) {
        k0[dx] = __bfloat162float(w_c0[dy * 7 + dx]);
        k1[dx] = __bfloat162float(w_c1[dy * 7 + dx]);
      }
      const bf16* row = x + ((size_t)n * H + y) * W * C + c;
#pragma unroll
      for (int j = 0; j < SEG + 6; ++j) {
        const int xx = ws + j - 3;
        float2 v = make_float2(0.f, 0.f);
        if (xx >= 0 && xx < W) {
          v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + (size_t)xx * C));
        }
#pragma unroll
        for (int dx = 0; dx < 7; ++dx) {
          const int p = j - dx;
          if (p >= 0 && p < SEG) {
            a0[p] = fmaf(v.x, k0[dx], a0[p]);
            a1[p] = fmaf(v.y, k1[dx], a1[p]);
          }
        }
      }
    }
    float* drow = dbuf + (size_t)(ws - w0) * C + c;
#pragma unroll
    for (int p = 0; p < SEG; ++p) {
      *reinterpret_cast<float2*>(drow + (size_t)p * C) = make_float2(a0[p], a1[p]);
    }
  }
  __syncthreads();

  // ---- LayerNorm over C per pixel, a warp per pixel; bf16 tile into xs ----
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float inv_c = 1.f / (float)C;
  for (int r = warp; r < R; r += WARPS) {
    bf16* xrow = xs + r * xld;
    if (r >= nvalid) {  // past the row's end: a zero row, its output is dropped
      for (int c = lane; c < C; c += 32) xrow[c] = __float2bfloat16_rn(0.f);
      continue;
    }
    const float* d = dbuf + (size_t)r * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += d[c];
    const float mean = warp_sum(s) * inv_c;
    float q = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float e = d[c] - mean;
      q += e * e;
    }
    const float rs = rsqrtf(warp_sum(q) * inv_c + eps);
    for (int c = lane; c < C; c += 32) {
      xrow[c] = __float2bfloat16_rn((d[c] - mean) * rs * ln_w[c] + ln_b[c]);
    }
  }
  __syncthreads();  // dbuf is free: it now holds the hidden chunk and staging

  bf16* hs = (bf16*)smem;
  float* stage = (float*)(smem + hidden_bytes(R)) + warp * 256;
  FragC acc[RT][MAXT];
  mlp_accumulate<RT, MAXT>(xs, xld, hs, stage, w1, b1, w2, C, HID, acc);
  const size_t p0 = ((size_t)n * H + h) * W + w0;
  mlp_store<RT, MAXT>(acc, stage, b2, gamma, x, out, p0, nvalid, C);
}

size_t smem_bytes(int rt, int C) {
  const int rows = 16 * rt;
  return region_bytes(rows, C) + align128((size_t)rows * (C + PAD) * 2);
}

template <int RT, int MAXT>
int launch(const void* x, const void* wt, const void* dwb, const void* ln_w,
           const void* ln_b, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* gamma, void* out, int N, int H, int W,
           int C, int HID, float eps, cudaStream_t stream) {
  const size_t smem = smem_bytes(RT, C);
  cudaError_t err = cudaFuncSetAttribute(
      block_kernel<RT, MAXT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + 16 * RT - 1) / (16 * RT), H, N);
  block_kernel<RT, MAXT><<<grid, THREADS, smem, stream>>>(
      (const bf16*)x, (const bf16*)wt, (const float*)dwb, (const float*)ln_w,
      (const float*)ln_b, (const bf16*)w1, (const float*)b1, (const bf16*)w2,
      (const float*)b2, (const float*)gamma, (bf16*)out, H, W, C, HID, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (N, H, W, C) bf16, contiguous; wt: (C, 1, 7, 7) bf16; dw_bias,
// ln_w, ln_b, b2, gamma: (C,) f32; w1 (HID, C), w2 (C, HID) bf16; b1 (HID,)
// f32. C and HID multiples of 16, C <= 1536; every pointer 32-byte aligned.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int axvs_convnext_block(const void* x, const void* wt, const void* dwb,
                                   const void* ln_w, const void* ln_b,
                                   const void* w1, const void* b1, const void* w2,
                                   const void* b2, const void* gamma, void* out,
                                   int N, int H, int W, int C, int HID, float eps,
                                   void* stream) {
  if (N <= 0 || N > 65535 || H <= 0 || H > 65535 || W <= 0 || C <= 0 || C % 16 ||
      C > MAX_C || HID <= 0 || HID % 16) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
#define AXVS_BLOCK_LAUNCH(RT, MAXT)                                              \
  launch<RT, MAXT>(x, wt, dwb, ln_w, ln_b, w1, b1, w2, b2, gamma, out, N, H, W, C, \
                   HID, eps, s)
  switch (tiles_per_warp(C)) {
    case 1: return AXVS_BLOCK_LAUNCH(4, 1);
    case 2: return AXVS_BLOCK_LAUNCH(4, 2);
    case 3: return AXVS_BLOCK_LAUNCH(4, 3);
    case 4: return AXVS_BLOCK_LAUNCH(3, 4);
    case 6: return AXVS_BLOCK_LAUNCH(2, 6);
    case 8: return AXVS_BLOCK_LAUNCH(1, 8);
    default: return AXVS_BLOCK_LAUNCH(1, 12);
  }
#undef AXVS_BLOCK_LAUNCH
}
