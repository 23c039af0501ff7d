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
//   F32ONCE  the input staged in f32 in shared memory, chain from the bias
//   DXPART   7 dy-chains, one per dx, combined as
//            ((p0 + p1) + (p2 + p3)) + ((p4 + p5) + p6), then bias + that
//            (the JAX package's shipped K1 order)
//   ACC2/4   taps round-robin over 2 or 4 accumulators, summed in order,
//            then the bias
//   DXONCE   DXPART over the staged f32 input of F32ONCE
// then (all but NOLN) LayerNorm over C in f32, one rounding to bf16. Out-of-
// image taps are zeros, as in the JAX bodies' padded window, so every
// variant sums exactly its 49 terms (NOLN and BF16MUL skip a column outside
// the image, whose products add nothing to a chain). Multiply and add may
// contract into an FMA, as in a real kernel: the plain versions
// (tools/exp_dwconv_variants.py) round the product first, so kernel and
// plain agree to a bf16 ulp.
//
// What bounds it on an H100: operations on the CUDA cores. 49 f32
// multiply-adds per element (98 flops) against 4 bytes (bf16 in and out) is
// about 24.5 flops a byte, above their ridge of about 20 (67 TFLOP/s over
// 3.35 TB/s): one stage-0 call (2x192x336x192) needs 0.036 ms of f32
// operations and 0.030 ms of bytes.
//
// Design: K1's layout (csrc/dwconv_ln.cu, through dwconv.cuh), turned a
// quarter so that the taps arrive dx-major. K1 gives a thread V = 8
// channels of TW = 4 output pixels along a row, keeps one input row's 7 tap
// vectors in registers and slides along W: its sums see the taps dy-major.
// Here a thread owns V = 8 channels (16-byte loads and stores) of TH = 4
// output pixels down a column, keeps one dx's 7 tap vectors (over dy) in
// registers and slides along H through the TH + 6 input rows of the column
// w + dx - 3, each loaded and converted once and fed to up to 7 pixels: so
// each pixel sees dx outer, dy inner, the JAX order, with K1's loads,
// conversions and FMAs per output (the other ways known, the dx loop over
// inputs re-read from L1 or all 49 taps in shared memory, convert each
// input or tap once per FMA). G strips of C / V threads stand side by side
// down H (K1's G, in whole warps: the extra threads join only the barriers,
// the staging and the reductions), the block walks RW output columns along
// W (K1's RH), and the LayerNorm sums run as K1's: one warp a (strip,
// pixel). The taps come tap-major, (7, 7, C), as K1 takes them.
// A narrower instantiation, where the state would not fit 255 registers
// without spills: TREE, which keeps a stack of 6 partial sums a pixel (a
// binary counter that reproduces `_k_tree`'s pairing), runs at TH = 2.
// Each row is loaded from a valid address whether or not it lies in the
// image, zeros selected after, so that no branch splits the row loop (such
// branches cost the variants that keep every column much of their time on
// the card; K1 still skips its rows outside the image with a branch, so
// NOLN against `ship` measures that difference as well as the LayerNorm).
// TREE unrolls the dx loop, so that each tap's place in the tree is known
// when compiled; the others
// keep it a loop, as K1 keeps dy: ACC2 and ACC4 feed tap (dx, dy) to
// register set dy mod n and rotate the sets after each dx, so that each
// set still takes the taps of one slot of the round robin.
// F32ONCE and DXONCE stage, for each dx, the block's input column (its G *
// TH + 6 rows, all C channels) by cp.async into shared memory as bf16, one
// column ahead of the one in use, and convert it once into an f32 copy that
// the taps read (6 bytes a staged element: 92 KB at C = 1536); the whole
// 7-column window in f32 would need 430 KB there.

#include "dwconv.cuh"  // vectors, the strip sum, the block layout

namespace {

using axvs_dwconv::MIN_THREADS;
using axvs_dwconv::Vec;
using axvs_dwconv::strip_sum;

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

enum { NOLN, TREE, BF16MUL, F32ONCE, DXPART, ACC2, ACC4, DXONCE };

constexpr int V = 8;                 // channels a thread
constexpr int MAX_C = 1536;
constexpr int MAX_CG = MAX_C / V;    // threads a strip
constexpr int MAX_THREADS = MAX_CG;  // a block: fewer than MIN_THREADS + CG live, whole warps
constexpr int LEVELS = 6;            // tree stack: 49 < 2^6

// output pixels a thread, down H: 4 as K1's, fewer where 4 would spill
// (ptxas on sm_90a: TREE at 4 takes 255 registers and spills, at 2 168)
template <int VAR>
__host__ __device__ constexpr int pixels() {
  return VAR == TREE ? 2 : 4;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(axvs_hopper::smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// the 8 channels of one staged row as f32: two planes of float4 (channels
// c0..c0+3, then c0+4..c0+7), so that a warp's 16-byte reads do not conflict
__device__ __forceinline__ void load_staged(const float4* f, int r, int CG, int t,
                                            float (&v)[V]) {
  const float4 lo = f[(2 * r) * CG + t], hi = f[(2 * r + 1) * CG + t];
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// The sums of one output column (TH pixels) of one thread, in the
// variant's order.
template <int VAR, int TH>
struct Sums {
  static constexpr int NACC = VAR == ACC2 ? 2 : VAR == ACC4 ? 4 : 1;
  static constexpr bool DXSPLIT = VAR == DXPART || VAR == DXONCE;
  float acc[TH][NACC][V];                 // chains (from the bias) or round-robin sums
  float st[VAR == TREE ? TH : 1][LEVELS][V];  // TREE: partial sums of 2^l products
  float part[DXSPLIT ? TH : 1][V];        // DXSPLIT: the current dx's dy-chain
  float q[DXSPLIT ? TH : 1][2][V];        // DXSPLIT: (p0+p1)+(p2+p3) and (p4+p5)+p6

  __device__ __forceinline__ void init(const float (&b)[V]) {
    constexpr bool FROM_BIAS = VAR == NOLN || VAR == BF16MUL || VAR == F32ONCE;
#pragma unroll
    for (int p = 0; p < TH; ++p)
#pragma unroll
      for (int a = 0; a < NACC; ++a)
#pragma unroll
        for (int i = 0; i < V; ++i) acc[p][a][i] = FROM_BIAS ? b[i] : 0.f;
  }

  // tap (dy, dx) of pixel p: input v (f32), weights k (f32)
  __device__ __forceinline__ void add(int p, int dx, int dy, const float (&v)[V],
                                      const float (&k)[V]) {
    const int t = dx * 7 + dy;  // the tap's place in the JAX order
    if constexpr (VAR == TREE) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float s = v[i] * k[i];
#pragma unroll
        for (int l = 0; l < LEVELS; ++l) {  // t's bits: occupied levels
          if ((t >> l) & 1) {
            s = st[p][l][i] + s;
          } else {
            st[p][l][i] = s;
            break;
          }
        }
      }
    } else if constexpr (DXSPLIT) {
#pragma unroll
      for (int i = 0; i < V; ++i) part[p][i] = dy == 0 ? v[i] * k[i] : fmaf(v[i], k[i], part[p][i]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        // the round robin's slot t mod NACC sits in register set dy mod
        // NACC while dx runs (see rotate)
        acc[p][dy % NACC][i] = fmaf(v[i], k[i], acc[p][dy % NACC][i]);
      }
    }
  }

  // BF16MUL's tap: the bf16 product, then an f32 add
  __device__ __forceinline__ void add_bf16(int p, const bf162 (&v)[V / 2], const bf162 (&k)[V / 2]) {
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const float2 f = __bfloat1622float2(__hmul2(v[i], k[i]));
      acc[p][0][2 * i] += f.x;
      acc[p][0][2 * i + 1] += f.y;
    }
  }

  // ACC2/4: after each dx, register set s takes the sum of set (s + 7) mod
  // NACC, so that at dx slot t = 7 dx + dy lies in set dy mod NACC; after the
  // 7 dx, slot l lies in set (l - 49) mod NACC
  __device__ __forceinline__ void rotate() {
#pragma unroll
    for (int p = 0; p < TH; ++p)
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float old[NACC];
#pragma unroll
        for (int a = 0; a < NACC; ++a) old[a] = acc[p][a][i];
#pragma unroll
        for (int a = 0; a < NACC; ++a) acc[p][a][i] = old[(a + 7) % NACC];
      }
  }

  // DXSPLIT: fold the finished dx's chains into the two halves, one branch
  // a dx; ACC2/4: rotate the register sets
  __device__ __forceinline__ void end_dx(int dx) {
    if constexpr (NACC > 1) rotate();
    if constexpr (DXSPLIT) {
      if (dx == 0) {
        fold<0, false>();  // p0
      } else if (dx == 1) {
        fold<0, true>();   // p0 + p1
      } else if (dx == 2 || dx == 4) {
        fold<1, false>();  // p2; p4
      } else if (dx == 3) {
#pragma unroll
        for (int p = 0; p < TH; ++p)
#pragma unroll
          for (int i = 0; i < V; ++i) q[p][0][i] = q[p][0][i] + (q[p][1][i] + part[p][i]);
      } else {
        fold<1, true>();   // (p4 + p5), + p6
      }
    }
  }

  // q[.][HALF] = the finished chain, or with ADD q[.][HALF] + the chain
  template <int HALF, bool ADD>
  __device__ __forceinline__ void fold() {
#pragma unroll
    for (int p = 0; p < TH; ++p)
#pragma unroll
      for (int i = 0; i < V; ++i) q[p][HALF][i] = ADD ? q[p][HALF][i] + part[p][i] : part[p][i];
  }

  // the pre-norm value of pixel p
  __device__ __forceinline__ void finish(int p, const float (&b)[V], float (&y)[V]) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if constexpr (VAR == NOLN || VAR == BF16MUL || VAR == F32ONCE) {
        y[i] = acc[p][0][i];
      } else if constexpr (VAR == TREE) {
        // fold the levels of 49 = 0b110001 from the newest: [0..31] +
        // ([32..47] + 48), as `_k_tree`'s last two rounds
        y[i] = (st[p][5][i] + (st[p][4][i] + st[p][0][i])) + b[i];
      } else if constexpr (DXSPLIT) {
        y[i] = b[i] + (q[p][0][i] + q[p][1][i]);
      } else {
        constexpr int SHIFT = NACC - 49 % NACC;  // slot l's set: (l + SHIFT) mod NACC
        float s = acc[p][SHIFT % NACC][i];
#pragma unroll
        for (int a = 1; a < NACC; ++a) s = s + acc[p][(a + SHIFT) % NACC][i];
        y[i] = s + b[i];
      }
    }
  }
};

// Row y of an input column (rows `pitch` elements apart) as 16 raw bytes;
// zeros outside the image, by a load from a valid address (`any`) and a
// select, so that no branch splits the row loop
__device__ __forceinline__ uint4 load_row(const bf16* col, const bf16* any, int y, int H,
                                          int pitch, bool col_in) {
  const bool in = col_in && y >= 0 && y < H;
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(in ? col + (size_t)y * pitch : any));
  return in ? raw : make_uint4(0u, 0u, 0u, 0u);
}

// One dx of one output column: the dx's 7 tap vectors, then the TH + 6 input
// rows of column w + dx - 3 from global memory (or, STAGED, from the f32
// copy f), each fed to the pixels it touches.
template <int VAR, int TH>
__device__ __forceinline__ void dx_step(Sums<VAR, TH>& sums, int dx, const bf16* __restrict__ x,
                                        const bf16* __restrict__ taps, const float4* f, int n,
                                        int h0, int w, int H, int W, int C, int c0, int CG,
                                        int t, int g, bool live) {
  constexpr bool STAGED = VAR == F32ONCE || VAR == DXONCE;
  const int xx = w + dx - 3;
  const bool col_in = xx >= 0 && xx < W;
  if constexpr (VAR == NOLN || VAR == BF16MUL) {
    if (!col_in) return;  // zeros add nothing to a chain
  }
  if (!live) return;
  if constexpr (VAR == BF16MUL) {
    bf162 k[7][V / 2];
#pragma unroll
    for (int dy = 0; dy < 7; ++dy) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(taps + (size_t)(dy * 7 + dx) * C + c0));
      const bf162* h = reinterpret_cast<const bf162*>(&raw);
#pragma unroll
      for (int i = 0; i < V / 2; ++i) k[dy][i] = h[i];
    }
    const bf16* col = x + ((size_t)n * H * W + xx) * C + c0;
#pragma unroll
    for (int j = 0; j < TH + 6; ++j) {
      const uint4 raw = load_row(col, taps + c0, h0 + j - 3, H, W * C, col_in);
      const bf162* h = reinterpret_cast<const bf162*>(&raw);
      bf162 v[V / 2];
#pragma unroll
      for (int i = 0; i < V / 2; ++i) v[i] = h[i];
#pragma unroll
      for (int p = 0; p < TH; ++p) {
        const int dy = j - p;
        if (dy >= 0 && dy < 7) sums.add_bf16(p, v, k[dy]);
      }
    }
  } else {
    float k[7][V];
#pragma unroll
    for (int dy = 0; dy < 7; ++dy) Vec<bf16, V>::load(taps + (size_t)(dy * 7 + dx) * C + c0, k[dy]);
    const bf16* col = x + ((size_t)n * H * W + xx) * C + c0;
#pragma unroll
    for (int j = 0; j < TH + 6; ++j) {
      float v[V];
      if constexpr (STAGED) {
        load_staged(f, g * TH + j, CG, t, v);
      } else {
        const uint4 raw = load_row(col, taps + c0, h0 + j - 3, H, W * C, col_in);
        const bf162* h = reinterpret_cast<const bf162*>(&raw);
#pragma unroll
        for (int i = 0; i < V / 2; ++i) {
          const float2 f2 = __bfloat1622float2(h[i]);
          v[2 * i] = f2.x;
          v[2 * i + 1] = f2.y;
        }
      }
#pragma unroll
      for (int p = 0; p < TH; ++p) {
        const int dy = j - p;
        if (dy >= 0 && dy < 7) sums.add(p, dx, dy, v, k[dy]);
      }
    }
  }
  sums.end_dx(dx);
}

// STAGED: the cp.asyncs of input column xx, rows [hb, hb + rows), into the
// bf16 buffer a; thread (t, g) of the G_all whole strips copies rows g,
// g + G_all, ...; zeros outside the image
__device__ __forceinline__ void stage_column(bf16* a, const bf16* __restrict__ x, int n, int hb,
                                             int rows, int xx, int H, int W, int C, int CG,
                                             int t, int g, int G_all) {
  if (g < G_all) {
    for (int r = g; r < rows; r += G_all) {
      const int y = hb + r;
      const bool in = xx >= 0 && xx < W && y >= 0 && y < H;
      const bf16* src = in ? x + (((size_t)n * H + y) * W + xx) * C + t * V : x;
      cp_async16(a + (size_t)r * C + t * V, src, in);
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// One dx of output column w. STAGED: wait for input column w + dx - 3 (in
// the bf16 buffer a, behind the f32 copy), convert it once into the f32
// copy, and start the cp.asyncs of the next column the block takes; then
// the dx's taps.
template <int VAR, int TH>
__device__ __forceinline__ void column_step(Sums<VAR, TH>& sums, int dx, const bf16* __restrict__ x,
                                            const bf16* __restrict__ taps, bf16* a, int n,
                                            int h0, int hb, int rows, int w, int w_end, int H,
                                            int W, int C, int c0, int CG, int t, int g,
                                            int G_all, bool live) {
  extern __shared__ float4 dyn[];
  if constexpr (VAR == F32ONCE || VAR == DXONCE) {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();  // the column has landed; every thread is done with the f32 copy
    if (g < G_all) {
      for (int r = g; r < rows; r += G_all) {
        float v[V];
        Vec<bf16, V>::load(a + (size_t)r * C + c0, v);
        dyn[(2 * r) * CG + t] = make_float4(v[0], v[1], v[2], v[3]);
        dyn[(2 * r + 1) * CG + t] = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
    __syncthreads();  // the f32 copy is whole; the bf16 buffer is free
    if (!(dx == 6 && w + 1 == w_end)) {
      const int next = dx < 6 ? w + dx - 2 : w - 2;  // (w, dx + 1) or (w + 1, 0)
      stage_column(a, x, n, hb, rows, next, H, W, C, CG, t, g, G_all);
    }
  }
  dx_step<VAR, TH>(sums, dx, x, taps, dyn, n, h0, w, H, W, C, c0, CG, t, g, live);
}

// The LayerNorm of a thread's TH pixels over their strips (K1's two passes,
// its sums of one warp a (strip, pixel)), stored as bf16.
template <int TH>
__device__ __forceinline__ void layer_norm_store(const float (&y)[TH][V], bf16* ocol, float* part,
                                                 float* tot, const float* __restrict__ ln_w,
                                                 const float* __restrict__ ln_b, int H, int W,
                                                 int C, int CG, int G, int g, int t, int c0,
                                                 int h0, bool live, float inv_c, float eps) {
  float s[TH];
#pragma unroll
  for (int p = 0; p < TH; ++p) {
    float z = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) z += y[p][i];
    s[p] = z;
  }
  strip_sum<TH>(s, part, tot, CG, G, g, t, live);
  float mean[TH];
#pragma unroll
  for (int p = 0; p < TH; ++p) {
    mean[p] = s[p] * inv_c;
    float z = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float d = y[p][i] - mean[p];
      z = fmaf(d, d, z);
    }
    s[p] = z;
  }
  strip_sum<TH>(s, part, tot, CG, G, g, t, live);
#pragma unroll
  for (int p = 0; p < TH; ++p) {
    if (live && h0 + p < H) {
      const float r = rsqrtf(s[p] * inv_c + eps);
      float o[V];
#pragma unroll
      for (int i = 0; i < V; ++i) o[i] = (y[p][i] - mean[p]) * r * ln_w[c0 + i] + ln_b[c0 + i];
      Vec<bf16, V>::store(ocol + (size_t)(h0 + p) * W * C, o);
    }
  }
}

// Block: G strips of CG = C / V threads down H, rounded up to whole warps;
// grid: (column groups of RW, row groups of G * TH, N). The STAGED variants
// take (G * TH + 6) * C * 6 bytes of dynamic shared memory.
template <int VAR>
__global__ void __launch_bounds__(MAX_THREADS)
dwconv_variant_kernel(const bf16* __restrict__ x,
                      const bf16* __restrict__ taps,  // (7, 7, C)
                      const float* __restrict__ bias,
                      const float* __restrict__ ln_w,
                      const float* __restrict__ ln_b,
                      bf16* __restrict__ out, int H, int W, int C, int G, int RW, float eps) {
  constexpr int TH = pixels<VAR>();
  constexpr bool STAGED = VAR == F32ONCE || VAR == DXONCE;
  __shared__ float part[MAX_CG * TH];      // a partial per (thread, pixel)
  __shared__ float tot[MIN_THREADS * TH];  // a sum per (strip, pixel): G <= 96
  extern __shared__ float4 dyn[];          // STAGED: the f32 copy, then the bf16 buffer
  const int CG = C / V;
  const int t = threadIdx.x % CG;  // channel group
  const int g = threadIdx.x / CG;  // strip
  const bool live = g < G;         // else a thread past the strips, in the last warp
  const int c0 = t * V;
  const int h0 = ((int)blockIdx.y * G + g) * TH;  // first output row of the strip
  const int n = blockIdx.z;
  const int w_begin = (int)blockIdx.x * RW;
  const int w_end = min(W, w_begin + RW);
  const float inv_c = 1.f / (float)C;
  // STAGED: the block's rows of one input column
  const int rows = G * TH + 6;
  const int hb = (int)blockIdx.y * G * TH - 3;
  const int G_all = blockDim.x / CG;  // whole strips of the block, live or not
  bf16* a = reinterpret_cast<bf16*>(dyn + (size_t)rows * 2 * CG);

  float b0[V];
#pragma unroll
  for (int i = 0; i < V; ++i) b0[i] = bias[c0 + i];

  if constexpr (STAGED) stage_column(a, x, n, hb, rows, w_begin - 3, H, W, C, CG, t, g, G_all);

  for (int w = w_begin; w < w_end; ++w) {
    Sums<VAR, TH> sums;
    sums.init(b0);
    if constexpr (VAR == TREE) {
#pragma unroll
      for (int dx = 0; dx < 7; ++dx) {
        column_step<VAR, TH>(sums, dx, x, taps, a, n, h0, hb, rows, w, w_end, H, W, C, c0, CG,
                             t, g, G_all, live);
      }
    } else {
#pragma unroll 1
      for (int dx = 0; dx < 7; ++dx) {
        column_step<VAR, TH>(sums, dx, x, taps, a, n, h0, hb, rows, w, w_end, H, W, C, c0, CG,
                             t, g, G_all, live);
      }
    }

    float y[TH][V];
#pragma unroll
    for (int p = 0; p < TH; ++p) sums.finish(p, b0, y[p]);

    bf16* ocol = out + ((size_t)n * H * W + w) * C + c0;
    if constexpr (VAR == NOLN) {
#pragma unroll
      for (int p = 0; p < TH; ++p) {
        if (live && h0 + p < H) Vec<bf16, V>::store(ocol + (size_t)(h0 + p) * W * C, y[p]);
      }
    } else {
      layer_norm_store<TH>(y, ocol, part, tot, ln_w, ln_b, H, W, C, CG, G, g, t, c0, h0, live,
                           inv_c, eps);
    }
  }
}

template <int VAR>
int launch(const void* x, const void* taps, const void* bias, const void* ln_w,
           const void* ln_b, void* out, int N, int H, int W, int C, float eps,
           cudaStream_t stream) {
  constexpr int TH = pixels<VAR>();
  constexpr bool STAGED = VAR == F32ONCE || VAR == DXONCE;
  const int CG = C / V;
  const int G = axvs_dwconv::strips_per_block(CG, MAX_CG);
  const int threads = (CG * G + 31) / 32 * 32;  // whole warps for strip_sum
  const int row_groups = (H + G * TH - 1) / (G * TH);
  // columns a block walks along W: as many as keep about 8 blocks on each SM
  int RW = 1;
  cudaError_t err = axvs_dwconv::walk_length((long long)row_groups * N, W, &RW);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + RW - 1) / RW, row_groups, N);
  const size_t smem = STAGED ? (size_t)(G * TH + 6) * C * 6 : 0;
  if constexpr (STAGED) {
    static size_t allowed = 0;  // raised once, not at every launch (host time)
    if (smem > allowed) {
      err = cudaFuncSetAttribute(dwconv_variant_kernel<VAR>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      allowed = smem;
    }
  }
  dwconv_variant_kernel<VAR><<<grid, threads, smem, stream>>>(
      (const bf16*)x, (const bf16*)taps, (const float*)bias, (const float*)ln_w,
      (const float*)ln_b, (bf16*)out, H, W, C, G, RW, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (N, H, W, C) bf16, contiguous, 16-byte aligned; taps: (7, 7, C)
// bf16, the depthwise weight tap-major (taps[dy][dx][c] = weight[c][0][dy][dx]),
// 16-byte aligned; bias, ln_w, ln_b: (C,) f32. C a multiple of 8, at most
// 1536; N and H at most 65535. variant: 0 noln, 1 tree, 2 bf16mul, 3
// f32once, 4 dxpart, 5 acc2, 6 acc4, 7 dxonce. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int axvs_dwconv_variant(const void* x, const void* taps,
                                   const void* bias, const void* ln_w,
                                   const void* ln_b, void* out, int N, int H,
                                   int W, int C, float eps, int variant,
                                   void* stream) {
  if (C <= 0 || C % V != 0 || C > MAX_C || N <= 0 || H <= 0 || W <= 0 || N > 65535 ||
      H > 65535 || ((uintptr_t)x & 15) || ((uintptr_t)taps & 15) || ((uintptr_t)out & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
#define AXVS_VARIANT(VAR) \
  case VAR: return launch<VAR>(x, taps, bias, ln_w, ln_b, out, N, H, W, C, eps, s)
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
