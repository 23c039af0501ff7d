// Two-stage trajectory attention, middle section, forward, bf16 or f32.
//
// Replaces the TPU kernel axial_vs_tpu/ops/traj_pallas.py::
// fused_trajectory_attention (Pallas body `_kernel`; math `_traj_math`). For
// q, k, v (B', N, C), N = f * n tokens frame-major, C = h * 32, per head:
//   1. x[s, g] = softmax_n(scale * q_s . k_{g, :}) @ v_{g, :}   (frame g's keys)
//   2. x_diag[s] = x[s, s / n]                                   (own frame)
//   3. q2 = x_diag @ Wq^T + bq,  [k2 | v2][s, g] = x[s, g] @ Wkv^T + bkv
//   4. out[s] = sum_g softmax_g(scale * q2_s . k2_{s, g}) v2_{s, g}
// with the TPU kernel's rounding points: f32 spatial logits and softmax, the
// probabilities rounded to bf16 before the AV product, f32 accumulation of
// the AV product and of the projections with one bf16 cast each, the biases
// added in bf16, q2 * scale rounded to bf16, then f32 temporal logits,
// softmax and sum, rounded once at the end.
//
// What bounds it on an H100: operations. Per call 4 B' N^2 C (stage 1) +
// 2 B' N C^2 (proj_q) + 4 f B' N C^2 (proj_kv) FLOPs against 8 B' N C bytes
// of q, k, v and out; at the Tube-Link shapes that is ~1,000 FLOPs per byte,
// above the card's ~295 bf16 ridge, and proj_kv over all f frames dominates.
//
// Design: one block of h warps (a warp per head) owns one row and a tile of
// 16 query tokens, and keeps the tile's whole trajectory x (f x 16 x C, bf16)
// in shared memory, so x never reaches device memory. The projections mix
// heads, which is why the block, and not a warp, owns the tile: after stage
// 1 every head's columns of x are in shared memory. Stage 1 stages one
// frame's keys and values (all heads, zero-padded to a multiple of 16 rows,
// which masks the ragged tail n % 16) and runs QK^T and PV on the tensor
// cores (wmma bf16 16x16x16, f32 accumulators), with the exact two-pass
// softmax in between. Stage 2 streams the Wq / Wkv columns of the warp's head
// from L2 as wmma B fragments; each Wkv fragment is loaded once and used for
// all f frames. The TPU design kept a whole row in VMEM, which at the widest
// within-clip row (q, k, v of 168 x 256 bf16, 258 KB) exceeds one SM's
// 227 KB; here a row's K and V live in shared memory one frame at a time.
//
// The f32 instantiation (the reference's default dtype) is a kernel of its
// own, traj_fwd_f32_kernel: the same block and warp roles, every product an
// f32 FMA on the CUDA cores (no TF32: the reference's f32 path is full f32).
// Stage 1 has lane j of a warp own keys j, j + 32, ...: it holds a key's 32
// dims in registers and scores it against the 16 queries of the tile (the
// tile is in shared memory), then the exact softmax runs per query row and
// the PV product runs with lanes over the head dim. Stage 2 has lane i own
// output column i of the warp's head: it streams that column's rows of Wq and
// Wkv from L2 as float4s and reuses each against the 16 tokens' trajectory in
// shared memory; the softmax over the f frames is taken online.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int HD = 32;     // head dim
constexpr int TQ = 16;     // query tokens per block
constexpr int MAX_F = 8;   // frames
constexpr int MAX_H = 8;   // heads = warps per block
constexpr int PAD = 8;     // bf16 padding of a shared row (bank spread)

// Shared memory carve-up, in bytes. Every region size is a multiple of 32 B,
// so every wmma pointer below is 256-bit aligned.
struct Layout {
  int n_pad, c, ld, s_ld, p_ld;
  size_t ks, vs, qs, xs, s, p, total;
};

__host__ __device__ inline Layout layout(int n, int f, int h) {
  Layout L;
  L.n_pad = (n + 15) / 16 * 16;
  L.c = h * HD;
  L.ld = L.c + PAD;                          // K, V, Q / x_diag, x rows
  L.s_ld = L.n_pad > 2 * 16 ? L.n_pad : 32;  // per-warp f32 scratch
  L.p_ld = L.n_pad + PAD;                    // per-warp bf16 probabilities
  size_t off = 0;
  L.ks = off; off += (size_t)L.n_pad * L.ld * 2;
  L.vs = off; off += (size_t)L.n_pad * L.ld * 2;
  L.qs = off; off += (size_t)TQ * L.ld * 2;
  L.xs = off; off += (size_t)f * TQ * L.ld * 2;
  L.s = off;  off += (size_t)h * TQ * L.s_ld * 4;
  L.p = off;  off += (size_t)h * TQ * L.p_ld * 2;
  L.total = off;
  return L;
}

__device__ __forceinline__ bf16 add_bf16(float acc, bf16 bias) {
  // cast the f32 sum once, then add the bias as bf16 + bf16 rounded to bf16
  const float a = __bfloat162float(__float2bfloat16_rn(acc));
  return __float2bfloat16_rn(a + __bfloat162float(bias));
}

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

template <int F>
__global__ void __launch_bounds__(MAX_H * 32, 1)
traj_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v,    // (B, N, C)
                const bf16* __restrict__ wq,   // (C, C)  (out, in)
                const bf16* __restrict__ bq,   // (C,)
                const bf16* __restrict__ wkv,  // (2C, C) (out, in)
                const bf16* __restrict__ bkv,  // (2C,)
                bf16* __restrict__ out,        // (B, N, C)
                int N, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(N / F, F, H);
  const int n = N / F, C = L.c, LD = L.ld, SLD = L.s_ld, PLD = L.p_ld;
  bf16* Ks = (bf16*)(smem + L.ks);
  bf16* Vs = (bf16*)(smem + L.vs);
  bf16* Qs = (bf16*)(smem + L.qs);  // the Q tile, then the x_diag tile
  bf16* Xs = (bf16*)(smem + L.xs);  // (F, TQ, LD): the tile's trajectory
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Sw = (float*)(smem + L.s) + (size_t)warp * TQ * SLD;
  bf16* Pw = (bf16*)(smem + L.p) + (size_t)warp * TQ * PLD;
  const int s0 = blockIdx.x * TQ;
  const size_t base = (size_t)blockIdx.y * N * C;
  const int chunks = C / 8;  // 16-byte pieces of one token row
  const int hc = warp * HD;  // this warp's head columns
  const int r = lane >> 1;   // lanes 2r, 2r+1 own tile row r ...
  const int half = lane & 1; // ... and split its columns
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int i = threadIdx.x; i < TQ * chunks; i += blockDim.x) {
    const int t = i / chunks, ch = i % chunks;
    uint4 val = zero;
    if (s0 + t < N) val = *(const uint4*)(q + base + (size_t)(s0 + t) * C + ch * 8);
    *(uint4*)(Qs + t * LD + ch * 8) = val;
  }

  // ---- stage 1: per frame, spatial softmax and aggregation, all heads ----
  for (int g = 0; g < F; ++g) {
    __syncthreads();  // the previous frame's K, V are no longer read
    for (int i = threadIdx.x; i < L.n_pad * chunks; i += blockDim.x) {
      const int j = i / chunks, ch = i % chunks;
      uint4 kv = zero, vv = zero;
      if (j < n) {
        const size_t off = base + (size_t)(g * n + j) * C + ch * 8;
        kv = *(const uint4*)(k + off);
        vv = *(const uint4*)(v + off);
      }
      *(uint4*)(Ks + j * LD + ch * 8) = kv;
      *(uint4*)(Vs + j * LD + ch * 8) = vv;
    }
    __syncthreads();

    FragA qa[2];
    wmma::load_matrix_sync(qa[0], Qs + hc, LD);
    wmma::load_matrix_sync(qa[1], Qs + hc + 16, LD);
    for (int kb = 0; kb < L.n_pad / 16; ++kb) {
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        FragBt kf;
        wmma::load_matrix_sync(kf, Ks + kb * 16 * LD + hc + kk * 16, LD);
        wmma::mma_sync(acc, qa[kk], kf, acc);
      }
      wmma::store_matrix_sync(Sw + kb * 16, acc, SLD, wmma::mem_row_major);
    }
    __syncwarp();

    const float* srow = Sw + r * SLD;
    float m = -INFINITY;
    for (int j = half; j < n; j += 2) m = fmaxf(m, scale * srow[j]);
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    float sum = 0.f;
    for (int j = half; j < n; j += 2) sum += expf(scale * srow[j] - m);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    bf16* prow = Pw + r * PLD;
    for (int j = half; j < L.n_pad; j += 2) {
      prow[j] = __float2bfloat16_rn(j < n ? expf(scale * srow[j] - m) / sum : 0.f);
    }
    __syncwarp();

    FragC xo[2];
    wmma::fill_fragment(xo[0], 0.f);
    wmma::fill_fragment(xo[1], 0.f);
    for (int kb = 0; kb < L.n_pad / 16; ++kb) {
      FragA pa;
      wmma::load_matrix_sync(pa, Pw + kb * 16, PLD);
#pragma unroll
      for (int jf = 0; jf < 2; ++jf) {
        FragB vf;
        wmma::load_matrix_sync(vf, Vs + kb * 16 * LD + hc + jf * 16, LD);
        wmma::mma_sync(xo[jf], pa, vf, xo[jf]);
      }
    }
    wmma::store_matrix_sync(Sw, xo[0], SLD, wmma::mem_row_major);
    wmma::store_matrix_sync(Sw + 16, xo[1], SLD, wmma::mem_row_major);
    __syncwarp();
    bf16* xrow = Xs + (size_t)(g * TQ + r) * LD + hc;
    for (int j = half * 16; j < half * 16 + 16; ++j) {
      xrow[j] = __float2bfloat16_rn(Sw[r * SLD + j]);
    }
    __syncwarp();  // Sw is overwritten by the next frame's logits
  }
  __syncthreads();  // every head of every frame is in Xs

  // frame diagonal: token s keeps its own frame's aggregation, frame s / n
  for (int i = threadIdx.x; i < TQ * chunks; i += blockDim.x) {
    const int t = i / chunks, ch = i % chunks;
    const int gd = min((s0 + t) / n, F - 1);  // rows past N: any frame
    *(uint4*)(Qs + t * LD + ch * 8) =
        *(const uint4*)(Xs + (size_t)(gd * TQ + t) * LD + ch * 8);
  }
  __syncthreads();

  // ---- stage 2: projections of this warp's head, temporal softmax ----
  const int cq = half * 8;  // this lane's 8 columns within a 16-column piece
  float q2s[16];            // row r, columns jf * 16 + cq + i, times scale
#pragma unroll
  for (int jf = 0; jf < 2; ++jf) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < C / 16; ++kk) {
      FragA xa;
      FragBt wf;
      wmma::load_matrix_sync(xa, Qs + kk * 16, LD);
      wmma::load_matrix_sync(wf, wq + (size_t)(hc + jf * 16) * C + kk * 16, C);
      wmma::mma_sync(acc, xa, wf, acc);
    }
    wmma::store_matrix_sync(Sw, acc, SLD, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bf16 q2 = add_bf16(Sw[r * SLD + cq + i], bq[hc + jf * 16 + cq + i]);
      q2s[jf * 8 + i] = __bfloat162float(
          __float2bfloat16_rn(__bfloat162float(q2) * scale));
    }
    __syncwarp();
  }

  float tl[F];
#pragma unroll
  for (int g = 0; g < F; ++g) tl[g] = 0.f;
#pragma unroll
  for (int jf = 0; jf < 2; ++jf) {  // k2: output columns hc + jf * 16
    FragC acc[F];
#pragma unroll
    for (int g = 0; g < F; ++g) wmma::fill_fragment(acc[g], 0.f);
    for (int kk = 0; kk < C / 16; ++kk) {
      FragBt wf;
      wmma::load_matrix_sync(wf, wkv + (size_t)(hc + jf * 16) * C + kk * 16, C);
#pragma unroll
      for (int g = 0; g < F; ++g) {
        FragA xa;
        wmma::load_matrix_sync(xa, Xs + (size_t)g * TQ * LD + kk * 16, LD);
        wmma::mma_sync(acc[g], xa, wf, acc[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < F; ++g) {
      wmma::store_matrix_sync(Sw, acc[g], SLD, wmma::mem_row_major);
      __syncwarp();
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const bf16 k2 = add_bf16(Sw[r * SLD + cq + i], bkv[hc + jf * 16 + cq + i]);
        part = fmaf(q2s[jf * 8 + i], __bfloat162float(k2), part);
      }
      tl[g] += part;
      __syncwarp();
    }
  }
  float tmax = -INFINITY;
#pragma unroll
  for (int g = 0; g < F; ++g) {
    tl[g] += __shfl_xor_sync(0xffffffffu, tl[g], 1);
    tmax = fmaxf(tmax, tl[g]);
  }
  float tsum = 0.f;
#pragma unroll
  for (int g = 0; g < F; ++g) {
    tl[g] = expf(tl[g] - tmax);
    tsum += tl[g];
  }
#pragma unroll
  for (int g = 0; g < F; ++g) tl[g] = tl[g] / tsum;  // temporal probabilities

  float o[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = 0.f;
#pragma unroll
  for (int jf = 0; jf < 2; ++jf) {  // v2: output columns C + hc + jf * 16
    FragC acc[F];
#pragma unroll
    for (int g = 0; g < F; ++g) wmma::fill_fragment(acc[g], 0.f);
    for (int kk = 0; kk < C / 16; ++kk) {
      FragBt wf;
      wmma::load_matrix_sync(wf, wkv + (size_t)(C + hc + jf * 16) * C + kk * 16, C);
#pragma unroll
      for (int g = 0; g < F; ++g) {
        FragA xa;
        wmma::load_matrix_sync(xa, Xs + (size_t)g * TQ * LD + kk * 16, LD);
        wmma::mma_sync(acc[g], xa, wf, acc[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < F; ++g) {
      wmma::store_matrix_sync(Sw, acc[g], SLD, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const bf16 v2 = add_bf16(Sw[r * SLD + cq + i],
                                 bkv[C + hc + jf * 16 + cq + i]);
        o[jf * 8 + i] = fmaf(tl[g], __bfloat162float(v2), o[jf * 8 + i]);
      }
      __syncwarp();
    }
  }

  if (s0 + r < N) {
#pragma unroll
    for (int jf = 0; jf < 2; ++jf) {
      __align__(16) bf16 packed[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) packed[i] = __float2bfloat16_rn(o[jf * 8 + i]);
      *(uint4*)(out + base + (size_t)(s0 + r) * C + hc + jf * 16 + cq) =
          *(const uint4*)packed;
    }
  }
}

// ---- f32 ----

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory of the f32 kernel, in bytes: the tile's trajectory x (F, TQ,
// C), the query tile (TQ, C), and per warp the scores of the tile against
// one frame's n keys (TQ, n).
struct LayoutF32 {
  size_t xs, qs, s, total;
};

__host__ __device__ inline LayoutF32 layout_f32(int n, int f, int h) {
  const size_t c = (size_t)h * HD;
  LayoutF32 L;
  L.xs = 0;
  L.qs = L.xs + (size_t)f * TQ * c * 4;
  L.s = L.qs + (size_t)TQ * c * 4;
  L.total = L.s + (size_t)h * TQ * n * 4;
  return L;
}

__global__ void __launch_bounds__(MAX_H * 32)
traj_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,    // (B, N, C)
                    const float* __restrict__ wq,   // (C, C)  (out, in)
                    const float* __restrict__ bq,   // (C,)
                    const float* __restrict__ wkv,  // (2C, C) (out, in)
                    const float* __restrict__ bkv,  // (2C,)
                    float* __restrict__ out,        // (B, N, C)
                    int N, int F, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = N / F, C = H * HD;
  const LayoutF32 L = layout_f32(n, F, H);
  float* Xs = (float*)(smem + L.xs);
  float* Qs = (float*)(smem + L.qs);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Sw = (float*)(smem + L.s) + (size_t)warp * TQ * n;
  const int s0 = blockIdx.x * TQ;
  const size_t base = (size_t)blockIdx.y * N * C;
  const int hc = warp * HD;  // this warp's head columns
  const int c4s = C / 4;

  for (int i = threadIdx.x; i < TQ * c4s; i += blockDim.x) {
    const int t = i / c4s, c4 = i % c4s;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s0 + t < N) val = *(const float4*)(q + base + (size_t)(s0 + t) * C + c4 * 4);
    *(float4*)(Qs + t * C + c4 * 4) = val;
  }
  __syncthreads();

  // ---- stage 1: per frame, spatial softmax and aggregation, this head ----
  for (int g = 0; g < F; ++g) {
    for (int j = lane; j < n; j += 32) {
      float kr[HD];
      const float* kp = k + base + (size_t)(g * n + j) * C + hc;
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        const float4 t4 = *(const float4*)(kp + d);
        kr[d] = t4.x;
        kr[d + 1] = t4.y;
        kr[d + 2] = t4.z;
        kr[d + 3] = t4.w;
      }
      for (int t = 0; t < TQ; ++t) {
        const float* qt = Qs + t * C + hc;
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < HD; d += 4) {
          const float4 q4 = *(const float4*)(qt + d);
          acc = fmaf(q4.x, kr[d], acc);
          acc = fmaf(q4.y, kr[d + 1], acc);
          acc = fmaf(q4.z, kr[d + 2], acc);
          acc = fmaf(q4.w, kr[d + 3], acc);
        }
        Sw[t * n + j] = scale * acc;
      }
    }
    __syncwarp();
    for (int t = 0; t < TQ; ++t) {  // exact softmax over the frame's n keys
      float* srow = Sw + t * n;
      float m = -INFINITY;
      for (int j = lane; j < n; j += 32) m = fmaxf(m, srow[j]);
      m = warp_max(m);
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float e = expf(srow[j] - m);
        srow[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int j = lane; j < n; j += 32) srow[j] = srow[j] / sum;
    }
    __syncwarp();
    float xo[TQ];
#pragma unroll
    for (int t = 0; t < TQ; ++t) xo[t] = 0.f;
    const float* vp = v + base + (size_t)g * n * C + hc + lane;
    for (int j = 0; j < n; ++j) {
      const float vj = vp[(size_t)j * C];
#pragma unroll
      for (int t = 0; t < TQ; ++t) xo[t] = fmaf(Sw[t * n + j], vj, xo[t]);
    }
#pragma unroll
    for (int t = 0; t < TQ; ++t) Xs[((size_t)g * TQ + t) * C + hc + lane] = xo[t];
    __syncwarp();  // Sw is overwritten by the next frame's scores
  }
  __syncthreads();  // every head of every frame is in Xs

  // ---- stage 2: lane owns output column hc + lane of q2, k2 and v2 ----
  const int col = hc + lane;
  float q2[TQ];
  {
    float acc[TQ];
#pragma unroll
    for (int t = 0; t < TQ; ++t) acc[t] = 0.f;
    const float* wrow = wq + (size_t)col * C;
    for (int c = 0; c < C; c += 4) {
      const float4 w4 = *(const float4*)(wrow + c);
#pragma unroll
      for (int t = 0; t < TQ; ++t) {
        const int gd = min((s0 + t) / n, F - 1);  // own frame; rows past N: any
        const float4 x4 = *(const float4*)(Xs + ((size_t)gd * TQ + t) * C + c);
        acc[t] = fmaf(x4.x, w4.x, acc[t]);
        acc[t] = fmaf(x4.y, w4.y, acc[t]);
        acc[t] = fmaf(x4.z, w4.z, acc[t]);
        acc[t] = fmaf(x4.w, w4.w, acc[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < TQ; ++t) q2[t] = (acc[t] + bq[col]) * scale;
  }

  float m[TQ], l[TQ], o[TQ];  // online softmax over the frames
#pragma unroll
  for (int t = 0; t < TQ; ++t) {
    m[t] = -INFINITY;
    l[t] = 0.f;
    o[t] = 0.f;
  }
  const float* wk = wkv + (size_t)col * C;
  const float* wv = wkv + (size_t)(C + col) * C;
  const float bk = bkv[col], bv = bkv[C + col];
  for (int g = 0; g < F; ++g) {
    float ak[TQ], av[TQ];
#pragma unroll
    for (int t = 0; t < TQ; ++t) {
      ak[t] = 0.f;
      av[t] = 0.f;
    }
    const float* xg = Xs + (size_t)g * TQ * C;
    for (int c = 0; c < C; c += 4) {
      const float4 k4 = *(const float4*)(wk + c);
      const float4 v4 = *(const float4*)(wv + c);
#pragma unroll
      for (int t = 0; t < TQ; ++t) {
        const float4 x4 = *(const float4*)(xg + (size_t)t * C + c);
        ak[t] = fmaf(x4.x, k4.x, ak[t]);
        ak[t] = fmaf(x4.y, k4.y, ak[t]);
        ak[t] = fmaf(x4.z, k4.z, ak[t]);
        ak[t] = fmaf(x4.w, k4.w, ak[t]);
        av[t] = fmaf(x4.x, v4.x, av[t]);
        av[t] = fmaf(x4.y, v4.y, av[t]);
        av[t] = fmaf(x4.z, v4.z, av[t]);
        av[t] = fmaf(x4.w, v4.w, av[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < TQ; ++t) {
      const float logit = warp_sum(q2[t] * (ak[t] + bk));  // this head's dot
      const float mn = fmaxf(m[t], logit);
      const float corr = expf(m[t] - mn);
      const float p = expf(logit - mn);
      l[t] = l[t] * corr + p;
      o[t] = o[t] * corr + p * (av[t] + bv);
      m[t] = mn;
    }
  }
#pragma unroll
  for (int t = 0; t < TQ; ++t) {
    if (s0 + t < N) out[base + (size_t)(s0 + t) * C + col] = o[t] / l[t];
  }
}

template <int F>
int launch(const void* q, const void* k, const void* v, const void* wq,
           const void* bq, const void* wkv, const void* bkv, void* out, int B,
           int N, int H, float scale, cudaStream_t stream) {
  const size_t smem = layout(N / F, F, H).total;
  cudaError_t err = cudaFuncSetAttribute(
      traj_fwd_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + TQ - 1) / TQ, B);
  traj_fwd_kernel<F><<<grid, H * 32, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)wq,
      (const bf16*)bq, (const bf16*)wkv, (const bf16*)bkv, (bf16*)out, N, H,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory the kernel needs for n tokens per frame, f frames, h heads
// of 32 (-1 for a shape it does not take).
extern "C" int axvs_traj_smem_bytes(int n, int f, int h) {
  if (n <= 0 || f <= 0 || f > MAX_F || h <= 0 || h > MAX_H) return -1;
  const size_t bytes = layout(n, f, h).total;
  return bytes > 2147483647u ? -1 : (int)bytes;
}

// q, k, v, out (B, N, C); wq (C, C); bq (C,); wkv (2C, C); bkv (2C,): bf16,
// contiguous, 32-byte aligned; C = 32 H; N = F n, tokens frame-major.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int axvs_traj_fwd(const void* q, const void* k, const void* v,
                             const void* wq, const void* bq, const void* wkv,
                             const void* bkv, void* out, int B, int N, int F,
                             int H, float scale, void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || F <= 0 || F > MAX_F || N % F != 0 ||
      H <= 0 || H > MAX_H) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (F) {
    case 1: return launch<1>(q, k, v, wq, bq, wkv, bkv, out, B, N, H, scale, s);
    case 2: return launch<2>(q, k, v, wq, bq, wkv, bkv, out, B, N, H, scale, s);
    case 3: return launch<3>(q, k, v, wq, bq, wkv, bkv, out, B, N, H, scale, s);
    case 4: return launch<4>(q, k, v, wq, bq, wkv, bkv, out, B, N, H, scale, s);
    case 5: return launch<5>(q, k, v, wq, bq, wkv, bkv, out, B, N, H, scale, s);
    case 6: return launch<6>(q, k, v, wq, bq, wkv, bkv, out, B, N, H, scale, s);
    case 7: return launch<7>(q, k, v, wq, bq, wkv, bkv, out, B, N, H, scale, s);
    default: return launch<8>(q, k, v, wq, bq, wkv, bkv, out, B, N, H, scale, s);
  }
}

// Shared memory the f32 kernel needs (-1 for a shape it does not take).
extern "C" int axvs_traj_smem_bytes_f32(int n, int f, int h) {
  if (n <= 0 || f <= 0 || f > MAX_F || h <= 0 || h > MAX_H) return -1;
  const size_t bytes = layout_f32(n, f, h).total;
  return bytes > 2147483647u ? -1 : (int)bytes;
}

// The same as axvs_traj_fwd with every tensor f32 (16-byte aligned).
extern "C" int axvs_traj_fwd_f32(const void* q, const void* k, const void* v,
                                 const void* wq, const void* bq, const void* wkv,
                                 const void* bkv, void* out, int B, int N, int F,
                                 int H, float scale, void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || F <= 0 || F > MAX_F || N % F != 0 ||
      H <= 0 || H > MAX_H) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = layout_f32(N / F, F, H).total;
  cudaError_t err = cudaFuncSetAttribute(
      traj_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + TQ - 1) / TQ, B);
  traj_fwd_f32_kernel<<<grid, H * 32, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)wq,
      (const float*)bq, (const float*)wkv, (const float*)bkv, (float*)out, N, F, H,
      scale);
  return (int)cudaGetLastError();
}
