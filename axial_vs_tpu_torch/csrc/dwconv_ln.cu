// Fused 7x7 depthwise convolution + channel LayerNorm for the ConvNeXt block
// (inference), NHWC, bf16 or f32 in and out (the weights in the same type).
//
// Replaces the TPU kernel axial_vs_tpu/ops/convnext_pallas.py::
// dwconv7x7_layernorm (Pallas body `_kernel`). It computes
//   out = LayerNorm_C(dwconv7x7_same(x) + bias) * ln_w + ln_b
// with f32 accumulation, eps as given, zero padding outside the image, and
// the two-pass LayerNorm of the TPU kernel (the mean, then the mean of the
// squared deviations), rounded once at the end.
//
// What bounds it on an H100: operations on the CUDA cores in bf16. Each call
// reads the activation once and writes it once (4 bytes an element) and does
// 49 f32 multiply-adds per element plus about 10 LayerNorm operations: 108
// over 4 bytes, above the CUDA cores' ridge of about 20 flops a byte (67
// TFLOP/s of f32 over 3.35 TB/s). Nothing of it can run on the tensor
// cores. In f32 (8 bytes an element) it is 13.5 flops a byte: bytes bound it.
// At the FMA rate every issue slot of the SM goes to an FMA, so what the
// kernel spends beside its FMAs (loads, conversions, reductions, address
// arithmetic) is what separates it from the bound.
//
// The first version (one block per 8 pixels of a row, a thread per two
// channels) reloaded its 14 taps per input row as scalar loads from the
// (C, 7, 7) layout, 98 bytes apart between neighbouring threads, read each
// input element as 4-byte pairs, and ran two block reductions per 8 pixels.
// This design:
// - takes the taps tap-major, (7, 7, C), a copy the wrapper keeps beside the
//   weight, so that a warp's tap loads are coalesced 16-byte vectors;
// - lets a thread own V channels (8 in bf16, 4 in f32: 16-byte loads and
//   stores) of TW consecutive output pixels of a row (4 at V = 8, else 8),
//   and slides the 7-tap window along W in registers: per input row it
//   loads the TW + 6 input vectors and the row's 7 tap vectors once each,
//   and each input vector feeds up to 7 outputs;
// - gives a block G such column strips side by side over all C channels, so
//   that a block has 96-192 threads at every ConvNeXt width (rounded up to
//   whole warps where C / V * G is not: the extra threads only join the
//   barriers and the reductions), and walks it down RH output rows, picked so that about 8 blocks run on each SM; two
//   neighbouring output rows share 6 input rows, which come from L1 or L2;
// - reduces each pixel's LayerNorm sums once per row for all TW pixels of
//   the strip: each thread adds its V channels, writes the partial to shared
//   memory, and one full warp per (strip, pixel) sums the partials with
//   shuffles.
// On the card (PERF.md section 6) it runs about a fifth under the first
// version at the ConvNeXt-L stages, at about a fifth of the FMA rate, as
// did every variant tried: V of 2, 4 or 8 by TW of 2, 4 or 8, and a thread
// block cluster that split C over up to 8 blocks, each staging its input
// tile once in shared memory by cp.async (slower). What holds them all
// there is not known yet: not the loads (the cluster's tile cut L2 reads
// 3.5x and lost), nor, per the P1 probe, the LayerNorm.
// C not a multiple of 8 (4) takes a narrower vector: 4 or 2 channels a
// thread (C even).

#include "dwconv.cuh"  // vectors, the strip sum, the block layout

namespace {

using axvs_dwconv::MIN_THREADS;
using axvs_dwconv::Vec;
using axvs_dwconv::strip_sum;

constexpr int MAX_C = 2048;  // channels; a strip is C / V threads

// T: the activation and weight type, __nv_bfloat16 or float; V: channels a
// thread; TW: output pixels a thread, along W. Block: G strips of CG = C / V
// threads, rounded up to whole warps; grid: (column groups of G * TW, row
// groups of RH, N).
template <typename T, int V, int TW>
__global__ void __launch_bounds__(MAX_C / V)
dwconv7x7_ln_kernel(const T* __restrict__ x,
                    const T* __restrict__ taps,  // (7, 7, C)
                    const float* __restrict__ bias,
                    const float* __restrict__ ln_w,
                    const float* __restrict__ ln_b,
                    T* __restrict__ out,
                    int H, int W, int C, int G, int RH, float eps) {
  __shared__ float part[MAX_C / V * TW];   // a partial per (thread, pixel)
  __shared__ float tot[MIN_THREADS * TW];  // a sum per (strip, pixel): G <= 96
  const int CG = C / V;
  const int t = threadIdx.x % CG;  // channel group
  const int g = threadIdx.x / CG;  // strip
  const bool live = g < G;         // else a thread past the strips, in the last warp
  const int c0 = t * V;
  const int w0 = (blockIdx.x * G + g) * TW;
  const int n = blockIdx.z;
  const int h_end = min(H, ((int)blockIdx.y + 1) * RH);
  const float inv_c = 1.f / (float)C;

  float b0[V];
#pragma unroll
  for (int i = 0; i < V; ++i) b0[i] = bias[c0 + i];

  for (int h = (int)blockIdx.y * RH; h < h_end; ++h) {
    float acc[TW][V];
#pragma unroll
    for (int p = 0; p < TW; ++p) {
#pragma unroll
      for (int i = 0; i < V; ++i) acc[p][i] = b0[i];
    }
    for (int dy = 0; dy < 7; ++dy) {
      const int y = h + dy - 3;
      if (!live || y < 0 || y >= H) continue;  // zero rows
      float k[7][V];
#pragma unroll
      for (int dx = 0; dx < 7; ++dx) {
        Vec<T, V>::load(taps + (size_t)(dy * 7 + dx) * C + c0, k[dx]);
      }
      const T* row = x + ((size_t)n * H + y) * W * C + c0;
#pragma unroll
      for (int j = 0; j < TW + 6; ++j) {
        const int xx = w0 + j - 3;
        float v[V];
        if (xx >= 0 && xx < W) {
          Vec<T, V>::load(row + (size_t)xx * C, v);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) v[i] = 0.f;
        }
#pragma unroll
        for (int dx = 0; dx < 7; ++dx) {
          const int p = j - dx;
          if (p >= 0 && p < TW) {
#pragma unroll
            for (int i = 0; i < V; ++i) acc[p][i] = fmaf(v[i], k[dx][i], acc[p][i]);
          }
        }
      }
    }

    float s[TW];
#pragma unroll
    for (int p = 0; p < TW; ++p) {
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) a += acc[p][i];
      s[p] = a;
    }
    strip_sum<TW>(s, part, tot, CG, G, g, t, live);
    float mean[TW];
#pragma unroll
    for (int p = 0; p < TW; ++p) {
      mean[p] = s[p] * inv_c;
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = acc[p][i] - mean[p];
        a = fmaf(d, d, a);
      }
      s[p] = a;
    }
    strip_sum<TW>(s, part, tot, CG, G, g, t, live);

    T* orow = out + ((size_t)n * H + h) * W * C + c0;
#pragma unroll
    for (int p = 0; p < TW; ++p) {
      if (live && w0 + p < W) {
        const float r = rsqrtf(s[p] * inv_c + eps);
        float o[V];
#pragma unroll
        for (int i = 0; i < V; ++i) o[i] = (acc[p][i] - mean[p]) * r * ln_w[c0 + i] + ln_b[c0 + i];
        Vec<T, V>::store(orow + (size_t)(w0 + p) * C, o);
      }
    }
  }
}

template <typename T, int V>
int launch_v(const void* x, const void* taps, const void* bias, const void* ln_w,
             const void* ln_b, void* out, int N, int H, int W, int C, float eps,
             cudaStream_t stream) {
  // pixels a thread: 4 at 8 channels, 8 at 4 or 2 (the fastest on the card at
  // the four ConvNeXt-L stages, PERF.md section 6)
  constexpr int TW = V == 8 ? 4 : 8;
  const int CG = C / V;
  const int G = axvs_dwconv::strips_per_block(CG, MAX_C / V);
  const int threads = (CG * G + 31) / 32 * 32;  // whole warps for strip_sum
  const int cols = (W + G * TW - 1) / (G * TW);
  // rows a block walks down: as many as keep about 8 blocks on each SM
  int RH = 1;
  const cudaError_t err = axvs_dwconv::walk_length((long long)cols * N, H, &RH);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(cols, (H + RH - 1) / RH, N);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  dwconv7x7_ln_kernel<T, V, TW><<<grid, threads, 0, stream>>>(
      (const T*)x, (const T*)taps, (const float*)bias, (const float*)ln_w,
      (const float*)ln_b, (T*)out, H, W, C, G, RH, eps);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, size_t bytes) { return ((uintptr_t)p % bytes) == 0; }

template <typename T>
int launch(const void* x, const void* taps, const void* bias, const void* ln_w,
           const void* ln_b, void* out, int N, int H, int W, int C, float eps,
           void* stream) {
  if (C <= 0 || C % 2 != 0 || C > MAX_C || N <= 0 || H <= 0 || W <= 0 || N > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  // the widest vector (16 bytes at most) that C and the three arrays allow
  auto fits = [&](int v) {
    const size_t bytes = v * sizeof(T);
    return C % v == 0 && aligned(x, bytes) && aligned(taps, bytes) && aligned(out, bytes);
  };
  if constexpr (sizeof(T) == 2) {
    if (fits(8)) return launch_v<T, 8>(x, taps, bias, ln_w, ln_b, out, N, H, W, C, eps, s);
  }
  if (fits(4)) return launch_v<T, 4>(x, taps, bias, ln_w, ln_b, out, N, H, W, C, eps, s);
  if (!fits(2)) return (int)cudaErrorMisalignedAddress;
  return launch_v<T, 2>(x, taps, bias, ln_w, ln_b, out, N, H, W, C, eps, s);
}

}  // namespace

// x, out: (N, H, W, C) bf16, contiguous; taps: (7, 7, C) bf16, the depthwise
// weight tap-major (taps[dy][dx][c] = weight[c][0][dy][dx]); bias, ln_w,
// ln_b: (C,) f32. C even, at most 2048. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int axvs_dwconv7x7_ln(const void* x, const void* taps, const void* bias,
                                 const void* ln_w, const void* ln_b, void* out,
                                 int N, int H, int W, int C, float eps,
                                 void* stream) {
  return launch<__nv_bfloat16>(x, taps, bias, ln_w, ln_b, out, N, H, W, C, eps,
                               stream);
}

// The same in f32: x, out, taps f32.
extern "C" int axvs_dwconv7x7_ln_f32(const void* x, const void* taps,
                                     const void* bias, const void* ln_w,
                                     const void* ln_b, void* out, int N, int H,
                                     int W, int C, float eps, void* stream) {
  return launch<float>(x, taps, bias, ln_w, ln_b, out, N, H, W, C, eps, stream);
}
