// Eight variants of K1's math, one kernel templated on the variant (P1):
// ConvNeXt's 7x7 depthwise conv + bias + channel LayerNorm, NHWC bf16.
//
// Replaces the TPU kernel of tools/exp_dwconv_variants.py::run_variant (its
// `pallas_call` over the bodies `_k_noln`, `_k_tree`, `_k_bf16`,
// `_k_f32once`, `_k_dxpart`, `_make_accn(2)`, `_make_accn(4)`, `_k_dxonce`),
// a probe of where a dwconv+LN kernel loses its time. Each variant sums the
// 49 taps in its JAX body's order (taps numbered dx-major, dy-minor):
//   NOLN     bias, then the chain of the 49 products; no LayerNorm
//   TREE     the 49 products combined by the pairwise tree of `_k_tree`
//            (adjacent pairs, the odd one carried), then the bias
//   BF16MUL  products rounded to bf16 (__hmul2 on bf16x2), f32 chain from
//            the bias
//   F32ONCE  the input window staged once in f32 in shared memory, chain
//            from the bias
//   DXPART   7 dy-chains, one per dx, combined as
//            ((p0 + p1) + (p2 + p3)) + ((p4 + p5) + p6), then bias + that
//            (the JAX package's shipped K1 order)
//   ACC2/4   taps round-robin over 2 or 4 accumulators, summed in order,
//            then the bias
//   DXONCE   DXPART over the staged f32 window of F32ONCE
// then (all but NOLN) LayerNorm over C in f32, one rounding to bf16. Out-of-
// image taps are zeros, as in the JAX bodies' padded window, so every
// variant sums exactly its 49 terms. Multiply and add may contract into an
// FMA, as in a real kernel: the plain versions (tools/exp_dwconv_variants.py)
// round the product first, so kernel and plain agree to a bf16 ulp.
//
// What bounds it on an H100: operations on the CUDA cores. 49 f32
// multiply-adds per element (98 flops) against 4 bytes (bf16 in and out) is
// about 24.5 flops a byte, above their ridge of about 20 (67 TFLOP/s over
// 3.35 TB/s): one stage-0 call (2x192x336x192) needs 0.036 ms of f32
// operations and 0.030 ms of bytes.
//
// Design: K1's block layout (csrc/dwconv_ln.cu): one block per 8 output
// pixels of an image row, one thread per two channels, the LayerNorm as two
// block reductions. Where K1 streams the 7 input rows (dy-major), this
// kernel streams the 14 input columns: each column's 7 rows are loaded once
// (one bf16x2 load each, 98 a thread as in K1) and feed the taps (dy, dx) of
// the up to 7 output pixels they touch, so each accumulator sees its taps in
// the JAX variants' dx-major order. A thread holds its 49 weight pairs in
// f32 registers (bf16x2 for BF16MUL), converted once: unpacked at every tap
// they would cost as many instructions as the FMAs. A block of at most 384
// threads (C <= 768) runs an instantiation bounded at 384 threads, which
// leaves 168 registers a thread for that state, and C = 1536's 768 threads
// leave 80. The staged variants copy each input column, all C channels in
// f32, into shared memory with 16-byte loads before the taps read it: the
// whole window (7 x 14 x C f32) would need 602 KB at C = 1536. The tree
// keeps a stack of 6 partial sums a pixel (a binary counter that
// reproduces `_k_tree`'s pairing), which is its register pressure.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

enum { NOLN, TREE, BF16MUL, F32ONCE, DXPART, ACC2, ACC4, DXONCE };

constexpr int TW = 8;             // output pixels per block along W
constexpr int MAX_THREADS = 768;  // C <= 1536
constexpr int MID_THREADS = 384;  // C <= 768: a register budget of 168
constexpr int TAPS = 49;
constexpr int LEVELS = 6;         // tree stack: 49 < 2^6

__device__ __forceinline__ float2 add2(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 mul2(float2 a, float2 b) {
  return make_float2(a.x * b.x, a.y * b.y);
}
__device__ __forceinline__ float2 fma2(float2 a, float2 b, float2 c) {
  return make_float2(fmaf(a.x, b.x, c.x), fmaf(a.y, b.y, c.y));
}

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

template <int V, int THREADS>
__global__ void __launch_bounds__(THREADS)
dwconv_variant_kernel(const bf16* __restrict__ x,
                      const bf16* __restrict__ wt,  // (C, 7, 7)
                      const float* __restrict__ bias,
                      const float* __restrict__ ln_w,
                      const float* __restrict__ ln_b,
                      bf16* __restrict__ out, int H, int W, int C, float eps) {
  constexpr bool STAGED = V == F32ONCE || V == DXONCE;
  constexpr bool DXSPLIT = V == DXPART || V == DXONCE;
  constexpr int NACC = V == ACC2 ? 2 : V == ACC4 ? 4 : 1;
  extern __shared__ float4 scol4[];  // STAGED: one input column, 7 x C f32
  __shared__ float red[(THREADS / 32) * TW];
  __shared__ float tot[TW];
  const float* scol = reinterpret_cast<const float*>(scol4);
  const int w0 = blockIdx.x * TW;
  const int h = blockIdx.y;
  const int n = blockIdx.z;
  const int c = 2 * threadIdx.x;
  const bool active = c < C;

  // weights k[dy * 7 + dx] of channels c and c+1, converted once (bf16
  // pairs for BF16MUL's bf16 products); zero for idle threads
  std::conditional_t<V == BF16MUL, bf162, float2> k[TAPS];
#pragma unroll
  for (int i = 0; i < TAPS; ++i) {
    const bf162 w2 = active ? __halves2bfloat162(wt[(size_t)c * TAPS + i],
                                                 wt[(size_t)(c + 1) * TAPS + i])
                            : __floats2bfloat162_rn(0.f, 0.f);
    if constexpr (V == BF16MUL) {
      k[i] = w2;
    } else {
      k[i] = __bfloat1622float2(w2);
    }
  }
  const float2 b = active ? make_float2(bias[c], bias[c + 1]) : make_float2(0.f, 0.f);

  float2 acc[TW][NACC];    // chains (from the bias) or round-robin sums
  float2 st[TW][LEVELS];   // TREE: partial sums of 2^l products
  float2 part[TW];         // DXSPLIT: the current dx's dy-chain
  float2 q[TW][2];         // DXSPLIT: (p0+p1)+(p2+p3) and (p4+p5)+p6
#pragma unroll
  for (int p = 0; p < TW; ++p) {
#pragma unroll
    for (int a = 0; a < NACC; ++a) {
      acc[p][a] = (V == NOLN || V == BF16MUL || V == F32ONCE) ? b : make_float2(0.f, 0.f);
    }
  }

#pragma unroll
  for (int j = 0; j < TW + 6; ++j) {
    const int xx = w0 + j - 3;
    const bool col_in = xx >= 0 && xx < W;
    float2 xf[7];
    bf162 xb[7];
    if constexpr (STAGED) {
      __syncthreads();  // the previous column is consumed
      const int vecs = C / 8;
      for (int i = threadIdx.x; i < 7 * vecs; i += blockDim.x) {
        const int dy = i / vecs;
        const int cv = i - dy * vecs;
        const int y = h + dy - 3;
        float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
        if (col_in && y >= 0 && y < H) {
          const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
              x + (((size_t)n * H + y) * W + xx) * C) + cv);
          const bf162* hv = reinterpret_cast<const bf162*>(&raw);
          const float2 f0 = __bfloat1622float2(hv[0]), f1 = __bfloat1622float2(hv[1]);
          const float2 f2 = __bfloat1622float2(hv[2]), f3 = __bfloat1622float2(hv[3]);
          lo = make_float4(f0.x, f0.y, f1.x, f1.y);
          hi = make_float4(f2.x, f2.y, f3.x, f3.y);
        }
        scol4[(dy * C + cv * 8) / 4] = lo;
        scol4[(dy * C + cv * 8) / 4 + 1] = hi;
      }
      __syncthreads();
#pragma unroll
      for (int dy = 0; dy < 7; ++dy) {
        xf[dy] = active ? *reinterpret_cast<const float2*>(scol + dy * C + c)
                        : make_float2(0.f, 0.f);
      }
    } else {
#pragma unroll
      for (int dy = 0; dy < 7; ++dy) {
        const int y = h + dy - 3;
        bf162 v = __floats2bfloat162_rn(0.f, 0.f);
        if (active && col_in && y >= 0 && y < H) {
          v = *reinterpret_cast<const bf162*>(x + (((size_t)n * H + y) * W + xx) * C + c);
        }
        xb[dy] = v;
        xf[dy] = __bfloat1622float2(v);
      }
    }

#pragma unroll
    for (int dx = 0; dx < 7; ++dx) {
      const int p = j - dx;  // the output pixel this column feeds through dx
      if (p < 0 || p >= TW) continue;
#pragma unroll
      for (int dy = 0; dy < 7; ++dy) {
        const int t = dx * 7 + dy;  // the tap's place in the JAX order
        const auto kf = k[dy * 7 + dx];
        if constexpr (V == BF16MUL) {
          acc[p][0] = add2(acc[p][0], __bfloat1622float2(__hmul2(xb[dy], kf)));
        } else if constexpr (V == NOLN || V == F32ONCE) {
          acc[p][0] = fma2(xf[dy], kf, acc[p][0]);
        } else if constexpr (V == TREE) {
          float2 v = mul2(xf[dy], kf);
#pragma unroll
          for (int l = 0; l < LEVELS; ++l) {  // t's bits: occupied levels
            if ((t >> l) & 1) {
              v = add2(st[p][l], v);
            } else {
              st[p][l] = v;
              break;
            }
          }
        } else if constexpr (NACC > 1) {
          acc[p][t % NACC] = fma2(xf[dy], kf, acc[p][t % NACC]);
        } else {  // DXSPLIT
          part[p] = dy == 0 ? mul2(xf[dy], kf) : fma2(xf[dy], kf, part[p]);
        }
      }
      if constexpr (DXSPLIT) {
        if (dx == 0 || dx == 2 || dx == 4) {
          q[p][dx == 0 ? 0 : 1] = part[p];
        } else if (dx == 1) {
          q[p][0] = add2(q[p][0], part[p]);                   // p0 + p1
        } else if (dx == 3) {
          q[p][0] = add2(q[p][0], add2(q[p][1], part[p]));    // + (p2 + p3)
        } else {
          q[p][1] = add2(q[p][1], part[p]);                   // (p4+p5), +p6
        }
      }
    }
  }

  float a0[TW], a1[TW];
#pragma unroll
  for (int p = 0; p < TW; ++p) {
    float2 y;
    if constexpr (V == NOLN || V == BF16MUL || V == F32ONCE) {
      y = acc[p][0];
    } else if constexpr (V == TREE) {
      // fold the levels of 49 = 0b110001 from the newest: [0..31] +
      // ([32..47] + 48), as `_k_tree`'s last two rounds
      y = add2(st[p][5], add2(st[p][4], st[p][0]));
      y = add2(y, b);
    } else if constexpr (DXSPLIT) {
      y = add2(b, add2(q[p][0], q[p][1]));
    } else {
      y = acc[p][0];
#pragma unroll
      for (int a = 1; a < NACC; ++a) y = add2(y, acc[p][a]);
      y = add2(y, b);
    }
    a0[p] = y.x;
    a1[p] = y.y;
  }

  bf16* orow = out + ((size_t)n * H + h) * W * C + c;
  if constexpr (V == NOLN) {
    if (!active) return;
#pragma unroll
    for (int p = 0; p < TW; ++p) {
      if (w0 + p < W) {
        *reinterpret_cast<bf162*>(orow + (size_t)(w0 + p) * C) =
            __floats2bfloat162_rn(a0[p], a1[p]);
      }
    }
    return;
  }

  const float inv_c = 1.f / (float)C;
  float s[TW];
#pragma unroll
  for (int p = 0; p < TW; ++p) s[p] = a0[p] + a1[p];  // idle threads add 0
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
#pragma unroll
  for (int p = 0; p < TW; ++p) {
    if (w0 + p < W) {
      const float r = rsqrtf(s[p] * inv_c + eps);
      *reinterpret_cast<bf162*>(orow + (size_t)(w0 + p) * C) =
          __floats2bfloat162_rn((a0[p] - mean[p]) * r * g0 + e0,
                                (a1[p] - mean[p]) * r * g1 + e1);
    }
  }
}

template <int V>
int launch(const void* x, const void* wt, const void* bias, const void* ln_w,
           const void* ln_b, void* out, int N, int H, int W, int C, float eps,
           cudaStream_t stream) {
  const bool staged = V == F32ONCE || V == DXONCE;
  const size_t smem = staged ? (size_t)7 * C * sizeof(float) : 0;
  const int threads = ((C / 2 + 31) / 32) * 32;
  const dim3 grid((W + TW - 1) / TW, H, N);
  // the smaller thread bound leaves each thread more registers
  if (threads <= MID_THREADS) {
    dwconv_variant_kernel<V, MID_THREADS><<<grid, threads, smem, stream>>>(
        (const bf16*)x, (const bf16*)wt, (const float*)bias,
        (const float*)ln_w, (const float*)ln_b, (bf16*)out, H, W, C, eps);
  } else {
    dwconv_variant_kernel<V, MAX_THREADS><<<grid, threads, smem, stream>>>(
        (const bf16*)x, (const bf16*)wt, (const float*)bias,
        (const float*)ln_w, (const float*)ln_b, (bf16*)out, H, W, C, eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (N, H, W, C) bf16, contiguous, x 16-byte aligned; wt: (C, 1, 7, 7)
// bf16; bias, ln_w, ln_b: (C,) f32. C a multiple of 8, at most 1536.
// variant: 0 noln, 1 tree, 2 bf16mul, 3 f32once, 4 dxpart, 5 acc2, 6 acc4,
// 7 dxonce. Launches on `stream` and returns cudaGetLastError().
extern "C" int axvs_dwconv_variant(const void* x, const void* wt,
                                   const void* bias, const void* ln_w,
                                   const void* ln_b, void* out, int N, int H,
                                   int W, int C, float eps, int variant,
                                   void* stream) {
  if (C <= 0 || C % 8 != 0 || C > 2 * MAX_THREADS || N <= 0 || H <= 0 ||
      W <= 0 || N > 65535 || H > 65535 || ((uintptr_t)x & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
#define AXVS_VARIANT(V) \
  case V: return launch<V>(x, wt, bias, ln_w, ln_b, out, N, H, W, C, eps, s)
  switch (variant) {
    AXVS_VARIANT(NOLN);
    AXVS_VARIANT(TREE);
    AXVS_VARIANT(BF16MUL);
    AXVS_VARIANT(F32ONCE);
    AXVS_VARIANT(DXPART);
    AXVS_VARIANT(ACC2);
    AXVS_VARIANT(ACC4);
    AXVS_VARIANT(DXONCE);
    default: return (int)cudaErrorInvalidValue;
  }
#undef AXVS_VARIANT
}
