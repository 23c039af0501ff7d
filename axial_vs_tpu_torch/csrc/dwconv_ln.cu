// Fused 7x7 depthwise convolution + channel LayerNorm for the ConvNeXt block
// (inference), NHWC bf16 in and out.
//
// Replaces the TPU kernel axial_vs_tpu/ops/convnext_pallas.py::
// dwconv7x7_layernorm (Pallas body `_kernel`). It computes
//   out = LayerNorm_C(dwconv7x7_same(x) + bias) * ln_w + ln_b
// with f32 accumulation, eps as given, and zero padding outside the image.
//
// What bounds it on an H100: memory. Each call reads the activation once and
// writes it once (bf16): 1.15 GB over the 36 calls of a ConvNeXt-L clip at
// 2x769x1345, computed from the shapes, against 49 multiply-adds per element,
// far below the card's ridge of ~295 bf16 operations per byte.
//
// Design: one block per TW consecutive output pixels of one image row, each
// thread owns two adjacent channels (one 4-byte bf16x2 load per tap). For
// each of the 7 input rows a thread streams TW+6 pixels along W and adds each
// into the TW accumulators it touches, so one input load feeds up to 7 taps
// and the 7x re-read of neighbouring rows is served from L1/L2 rather than
// device memory. The LayerNorm statistics are two block reductions (mean,
// then the mean of squared deviations) over the channel threads, done for
// all TW pixels at once; the normalised value never leaves registers.
// Out-of-image taps are skipped, i.e. zero, as in the TPU kernel's select.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TW = 8;           // output pixels per block along W
constexpr int MAX_THREADS = 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Replaces v[p] by its sum over all threads of the block, for each p.
__device__ __forceinline__ void block_sum(float (&v)[TW], float* red, float* tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int p = 0; p < TW; ++p) {
    const float s = warp_sum(v[p]);
    if (lane == 0) red[warp * TW + p] = s;
  }
  __syncthreads();
  if (threadIdx.x < TW) {
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w) s += red[w * TW + threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < TW; ++p) v[p] = tot[p];
  __syncthreads();  // red and tot are reused by the next call
}

__global__ void __launch_bounds__(MAX_THREADS)
dwconv7x7_ln_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ wt,  // (C, 7, 7)
                    const float* __restrict__ bias,
                    const float* __restrict__ ln_w,
                    const float* __restrict__ ln_b,
                    __nv_bfloat16* __restrict__ out,
                    int H, int W, int C, float eps) {
  __shared__ float red[(MAX_THREADS / 32) * TW];
  __shared__ float tot[TW];
  const int w0 = blockIdx.x * TW;
  const int h = blockIdx.y;
  const int n = blockIdx.z;
  const int c = 2 * threadIdx.x;
  const bool active = c < C;

  float a0[TW], a1[TW];
  const float b0 = active ? bias[c] : 0.f;
  const float b1 = active ? bias[c + 1] : 0.f;
#pragma unroll
  for (int p = 0; p < TW; ++p) {
    a0[p] = b0;
    a1[p] = b1;
  }

  if (active) {
    const __nv_bfloat16* w_c0 = wt + (size_t)c * 49;
    const __nv_bfloat16* w_c1 = w_c0 + 49;
    for (int dy = 0; dy < 7; ++dy) {
      const int y = h + dy - 3;
      if (y < 0 || y >= H) continue;
      float k0[7], k1[7];
#pragma unroll
      for (int dx = 0; dx < 7; ++dx) {
        k0[dx] = __bfloat162float(w_c0[dy * 7 + dx]);
        k1[dx] = __bfloat162float(w_c1[dy * 7 + dx]);
      }
      const __nv_bfloat16* row = x + ((size_t)n * H + y) * W * C + c;
#pragma unroll
      for (int j = 0; j < TW + 6; ++j) {
        const int xx = w0 + j - 3;
        float2 v = make_float2(0.f, 0.f);
        if (xx >= 0 && xx < W) {
          v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(row + (size_t)xx * C));
        }
#pragma unroll
        for (int dx = 0; dx < 7; ++dx) {
          const int p = j - dx;
          if (p >= 0 && p < TW) {
            a0[p] = fmaf(v.x, k0[dx], a0[p]);
            a1[p] = fmaf(v.y, k1[dx], a1[p]);
          }
        }
      }
    }
  }

  const float inv_c = 1.f / (float)C;
  float s[TW];
#pragma unroll
  for (int p = 0; p < TW; ++p) s[p] = a0[p] + a1[p];  // inactive threads add 0
  block_sum(s, red, tot);
  float mean[TW];
#pragma unroll
  for (int p = 0; p < TW; ++p) {
    mean[p] = s[p] * inv_c;
    const float d0 = a0[p] - mean[p];
    const float d1 = a1[p] - mean[p];
    s[p] = active ? d0 * d0 + d1 * d1 : 0.f;
  }
  block_sum(s, red, tot);
  if (!active) return;

  const float g0 = ln_w[c], g1 = ln_w[c + 1];
  const float e0 = ln_b[c], e1 = ln_b[c + 1];
  __nv_bfloat16* orow = out + ((size_t)n * H + h) * W * C + c;
#pragma unroll
  for (int p = 0; p < TW; ++p) {
    const int xx = w0 + p;
    if (xx < W) {
      const float r = rsqrtf(s[p] * inv_c + eps);
      const float y0 = (a0[p] - mean[p]) * r * g0 + e0;
      const float y1 = (a1[p] - mean[p]) * r * g1 + e1;
      *reinterpret_cast<__nv_bfloat162*>(orow + (size_t)xx * C) =
          __floats2bfloat162_rn(y0, y1);
    }
  }
}

}  // namespace

// x, out: (N, H, W, C) bf16, contiguous; wt: (C, 1, 7, 7) bf16; bias, ln_w,
// ln_b: (C,) f32. C must be even and at most 2 * MAX_THREADS. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int axvs_dwconv7x7_ln(const void* x, const void* wt, const void* bias,
                                 const void* ln_w, const void* ln_b, void* out,
                                 int N, int H, int W, int C, float eps,
                                 void* stream) {
  if (C <= 0 || C % 2 != 0 || C > 2 * MAX_THREADS || N <= 0 || H <= 0 ||
      W <= 0 || N > 65535 || H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = ((C / 2 + 31) / 32) * 32;
  const dim3 grid((W + TW - 1) / TW, H, N);
  dwconv7x7_ln_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)wt, (const float*)bias,
      (const float*)ln_w, (const float*)ln_b, (__nv_bfloat16*)out, H, W, C, eps);
  return (int)cudaGetLastError();
}
