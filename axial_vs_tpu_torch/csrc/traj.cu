// Two-stage trajectory attention, middle section, forward, bf16 or f32.
//
// Replaces the TPU kernel axial_vs_tpu/ops/traj_pallas.py::
// fused_trajectory_attention (Pallas body `_kernel`; math `_traj_math`). For
// q, k, v (B', N, C), N = f * n tokens frame-major, C = h * d, per head:
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
// of q, k, v and out; stage 2 (the projections) is about 84% of the FLOPs at
// the WC shapes, and the whole is far above the card's ~295 bf16 ridge.
//
// The first bf16 version ran both stages in one block of 8 warps per 16
// query tokens of a row, on wmma 16x16x16 fragments: it restaged the row's K
// and V for every 16 tokens, held one block an SM (about 200 KB of shared
// memory at the widest row) with synchronous loads, and streamed all of Wq
// and Wkv (384 KB) from L2 for every 16-token tile: about 32 FLOPs per L2
// byte where the tensor cores need about 180. It ran at 2.6% of its bound.
// This design takes two launches:
//
// Stage 1 (traj_stage1_kernel): a block of 4 warps owns 64 query tokens of
// one (row, head), so a frame's K and V (one head, n x 32) are staged in
// shared memory once per 64 queries, V transposed so that both products
// read their B fragments as 32-bit words without bank conflicts. A warp
// holds 16 queries' scores against up to 64 keys in registers (mma.sync
// m16n8k16, bf16 in, f32 out), takes the exact softmax there (max and sum
// across the quad of lanes that shares a row; one exp a score), and feeds
// the probabilities,
// rounded to bf16, straight from its accumulators into the PV product as
// the A operand. Rows of more than 64 keys take the softmax's max and sum
// over 64-key chunks first and recompute each chunk's scores for PV (64
// rather than 128 keys in registers measured faster even at n = 84: fewer
// registers, more warps an SM). It
// writes x, rounded to bf16, to a workspace X (f, B' N, C) and the frame
// diagonal to XD (B' N, C): the TPU math rounds x to bf16 at exactly this
// point, so the round trip through L2 changes no bit.
//
// Stage 2 (traj_stage2_kernel) is a GEMM on the tensor cores: tokens of all
// rows flattened, tiles of 64 tokens, and for each tile a pair of heads. A
// persistent block of two consumer warpgroups (one per head of the pair)
// and one producer warp keeps the pair's rows of Wq (64 x C) and of Wkv (the
// k and v rows of both heads, 128 x C) resident in shared memory, loaded by
// TMA once per pair and applied to all f frames of every tile it takes; the
// producer streams the tile's XD and f frames of X through a TMA ring of
// three slots, each a 64 x C tile in 128-byte-swizzled 64-column slices.
// Each warpgroup runs wgmma m64n32 (q2 of its head) and m64n64 (k2 and v2 of
// its head, per frame) with f32 accumulators, and takes the temporal
// softmax in the epilogue, on its registers: the bias, the bf16 casts, the
// head's logit (a quad of lanes shares a row), and an online softmax and
// sum over the frames in f32, one cast at the end. Its mbarriers, TMA loads,
// tensor maps and wgmma descriptors come from hopper.cuh, which K5 and K4
// use too.
//
// The f32 instantiation (the reference's default dtype) keeps every
// product an f32 FMA on the CUDA cores (no TF32: the reference's f32 path is
// full f32; the bound counts 67 TFLOP/s of FMAs) and has the same two-launch
// structure through f32 workspaces (traj_stage1_f32_kernel,
// traj_stage2_f32_kernel, below): register-tiled with 8-11 FMAs per shared
// load, K and V staged once per 64 queries, one head's weights resident.
// (One block of h warps per 16 tokens with a lane per output column, the
// first design, streamed all 3 C^2 weights from L2 for every 16 tokens and
// reloaded each frame's K and V for every 16 queries.)
//
// Head width. Every kernel is a template on the head width HD = d, 8, 16 or
// 32 (the JAX kernel takes any d; 32 is the WC and Tube-Link layers', 8 the
// overfit tools'), and C = h d must be a multiple of 16 (the TMA row pitch,
// and whole 16-column steps of stage 2's k). Stage 1 works a head at a time,
// so d sizes its tiles: the q . k product's k is d, zero-padded in registers
// to the mma's 16 where d = 8; the PV product's n is d / 8 tiles of 8 (bf16),
// or d / 8 columns a thread (f32). Stage 2 does not work a head at a time:
// its unit is a group of 32 columns (GW), which holds 32 / d heads, so its
// GEMM tiles, weights in shared memory and TMA boxes are those of d = 32 at
// every d; only the epilogue splits a group's columns into heads, each with
// its own logit (a sum over the head's columns across the 4 or 8 lanes that
// share a row), softmax and sum. At d = 32 a group is one head and every
// kernel computes what it did before the template, in the same order.

#include "hopper.cuh"  // mbarriers, TMA, wgmma descriptors and products, the SM count

namespace {

namespace hopper = axvs_hopper;
typedef __nv_bfloat16 bf16;

constexpr int GW = 32;     // stage 2's columns of a group (32 / HD heads)
// frames: both stages loop over them (stage 1 one frame at a time, stage 2
// with an online softmax), so the bound only keeps the host's checks finite;
// the cross-clip module runs the clip axis here, 256 clips being 512 frames
// of 2-frame clips. The workspace X (F, B' N, C) must also hold fewer than
// 2^31 rows (checked at launch).
constexpr int MAX_F = 256;
constexpr int MAX_H = 8;   // heads

// ---- bf16, stage 1 ----

constexpr int S1_WARPS = 4;
constexpr int S1_TQ = 16 * S1_WARPS;  // query tokens of a block
constexpr int KCH = 64;               // keys whose scores a warp holds at once

// bf16 row of the staged keys: a word count 4 more than a multiple of 8 (20,
// 12, 4 words at d = 32, 16, 8), so the 8 rows a B fragment reads fall on
// distinct banks
template <int HD>
__host__ __device__ constexpr int k_ld() {
  return HD == 8 ? 8 : HD + 8;
}

// Shared memory of stage 1: one frame's keys of one head (n_pad x k_ld) and
// its values transposed (HD x vt_ld), zero past n. vt_ld / 2 words is 4
// more than a multiple of 8, so the 8 rows a B fragment reads fall on
// distinct banks.
struct Stage1Layout {
  int n_pad, vt_ld;
  size_t k, vt, total;
};

template <int HD>
__host__ __device__ inline Stage1Layout stage1_layout(int n) {
  Stage1Layout L;
  L.n_pad = (n + 15) / 16 * 16;
  L.vt_ld = L.n_pad + 8;
  L.k = 0;
  L.vt = (size_t)L.n_pad * k_ld<HD>() * 2;
  L.total = L.vt + (size_t)HD * L.vt_ld * 2;
  return L;
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// d += A (16 x 16, row) B (16 x 8, col), bf16 in, f32 accumulators. Lane l:
// a = rows l/4 (+8), cols 2(l%4) (+1) (+8); b = rows 2(l%4) (+1) (+8), col
// l/4; d = rows l/4 (+8), cols 2(l%4) (+1).
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// grid (ceil(N / 64), h, B'); 128 threads. X: (F, B' N, C), XD: (B' N, C).
// The q . k product takes d in k-steps of 16; at d = 8 the A fragment's
// columns 8-15 and the B fragment's rows 8-15 are zeros in registers.
template <int HD>
__global__ void __launch_bounds__(S1_WARPS * 32)
traj_stage1_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ X,
                   bf16* __restrict__ XD, int B, int N, int F, int C, float scale) {
  constexpr int K_LD = k_ld<HD>();
  constexpr int KSTEPS = (HD + 15) / 16;
  extern __shared__ __align__(16) unsigned char smem1[];
  const int n = N / F;
  const Stage1Layout L = stage1_layout<HD>(n);
  bf16* Ks = (bf16*)(smem1 + L.k);
  bf16* Vt = (bf16*)(smem1 + L.vt);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int hc = blockIdx.y * HD;
  const int b = blockIdx.z;
  const size_t base = (size_t)b * N * C;
  const int sq = blockIdx.x * S1_TQ + warp * 16 + gq;  // rows sq and sq + 8

  uint32_t qa[KSTEPS][4];  // this warp's 16 queries as A fragments, zero past N and d
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = sq + 8 * (i & 1);
      const int dim = 16 * kk + 2 * tq + 8 * (i >> 1);
      qa[kk][i] = s < N && dim < HD ? ld32(q + base + (size_t)s * C + hc + dim) : 0u;
    }
  }

  const int nch = (n + KCH - 1) / KCH;
  for (int g = 0; g < F; ++g) {
    __syncthreads();  // the previous frame's K and V are no longer read
    for (int i = threadIdx.x; i < L.n_pad * (HD / 8); i += blockDim.x) {
      const int j = i / (HD / 8), ch = i % (HD / 8);  // key, 8-dim piece
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (j < n) {
        const size_t off = base + (size_t)(g * n + j) * C + hc + ch * 8;
        kv = *(const uint4*)(k + off);
        vv = *(const uint4*)(v + off);
      }
      *(uint4*)(Ks + j * K_LD + ch * 8) = kv;
      const bf16* ve = (const bf16*)&vv;
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(ch * 8 + e) * L.vt_ld + j] = ve[e];
    }
    __syncthreads();

    float sc[KCH / 8][4];  // scores of one chunk: key tiles of 8
    auto scores = [&](int c0) {
#pragma unroll
      for (int nt = 0; nt < KCH / 8; ++nt) {
        if (c0 + nt * 8 < L.n_pad) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          const bf16* kr = Ks + (c0 + nt * 8 + gq) * K_LD + 2 * tq;
#pragma unroll
          for (int kk = 0; kk < KSTEPS; ++kk) {
            const uint32_t b1 = 16 * kk + 8 < HD ? ld32(kr + 16 * kk + 8) : 0u;
            mma16816(acc, qa[kk], ld32(kr + 16 * kk), b1);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = c0 + nt * 8 + 2 * tq + (i & 1);
            sc[nt][i] = key < n ? scale * acc[i] : -INFINITY;
          }
        }
      }
    };

    // the exact softmax's max and sum, over chunks of KCH keys
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int c = 0; c < nch; ++c) {
      const int c0 = c * KCH;
      scores(c0);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float cm = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < KCH / 8; ++nt) {
          if (c0 + nt * 8 < L.n_pad) cm = fmaxf(cm, fmaxf(sc[nt][2 * r], sc[nt][2 * r + 1]));
        }
        const float mn = fmaxf(m[r], quad_max(cm));
        float cs = 0.f;
#pragma unroll
        for (int nt = 0; nt < KCH / 8; ++nt) {
          if (c0 + nt * 8 < L.n_pad) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float ex = expf(sc[nt][2 * r + e] - mn);
              if (nch == 1) sc[nt][2 * r + e] = ex;  // mn is final: keep exp
              cs += ex;
            }
          }
        }
        l[r] = l[r] * expf(m[r] - mn) + quad_sum(cs);
        m[r] = mn;
      }
    }

    // p = e / l as e * (1 / l): at most one f32 ulp from the quotient before
    // the bf16 cast, as the sums' order may move it; one division a row
    const float rl[2] = {1.f / l[0], 1.f / l[1]};
    float o[HD / 8][4];
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
    for (int c = 0; c < nch; ++c) {
      const int c0 = c * KCH;
      if (nch > 1) {  // the chunk's scores again, as exp(s - m)
        scores(c0);
#pragma unroll
        for (int nt = 0; nt < KCH / 8; ++nt) {
          if (c0 + nt * 8 < L.n_pad) {
#pragma unroll
            for (int i = 0; i < 4; ++i) sc[nt][i] = expf(sc[nt][i] - m[i >> 1]);
          }
        }
      }
#pragma unroll
      for (int ks = 0; ks < KCH / 16; ++ks) {
        if (c0 + ks * 16 < L.n_pad) {
          uint32_t pa[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {  // tiles 2 ks (i < 2) and 2 ks + 1; rows by i & 1
            const float* s2 = &sc[2 * ks + (i >> 1)][2 * (i & 1)];
            const int r = i & 1;
            pa[i] = pack_bf16(s2[0] * rl[r], s2[1] * rl[r]);
          }
#pragma unroll
          for (int nd = 0; nd < HD / 8; ++nd) {
            const bf16* vr = Vt + (nd * 8 + gq) * L.vt_ld + c0 + ks * 16 + 2 * tq;
            mma16816(o[nd], pa, ld32(vr), ld32(vr + 8));
          }
        }
      }
    }

    // x, rounded once to bf16; the diagonal also to XD
    const size_t frame = (size_t)g * B * N;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = sq + 8 * r;
      if (s >= N) continue;
      const size_t tok = (size_t)b * N + s;
      const bool diag = s / n == g;
#pragma unroll
      for (int nd = 0; nd < HD / 8; ++nd) {
        const __nv_bfloat162 val = __floats2bfloat162_rn(o[nd][2 * r], o[nd][2 * r + 1]);
        const int col = hc + nd * 8 + 2 * tq;
        *(__nv_bfloat162*)(X + (frame + tok) * C + col) = val;
        if (diag) *(__nv_bfloat162*)(XD + tok * C + col) = val;
      }
    }
  }
}

// ---- bf16, stage 2 ----

constexpr int S2_BM = 64;        // tokens of a tile
constexpr int S2_STAGES = 3;     // A tiles in flight
constexpr int S2_THREADS = 288;  // warpgroups 0-1 compute (a head each), warp 8 loads
constexpr int SLICE = S2_BM * hopper::BK;  // elements of a 64 x 64 slice (8 KB)

// Shared memory of stage 2, from a 1024-byte boundary, for ks = ceil(C / 64)
// slices of 64 columns: Wq rows of the group pair (64 x C), Wkv rows (k0, v0,
// k1, v1: 32 x C each), S2_STAGES A tiles (64 x C), then the mbarriers.
__host__ __device__ inline size_t stage2_smem(int ks) {
  return 1024 + (size_t)ks * SLICE * 2 * (3 + S2_STAGES) + (2 * S2_STAGES + 2) * 8;
}

__device__ __forceinline__ float add_bf16(float acc, bf16 bias) {
  // cast the f32 sum once, then add the bias as bf16 + bf16 rounded to bf16
  const float a = __bfloat162float(__float2bfloat16_rn(acc));
  return __bfloat162float(__float2bfloat16_rn(a + __bfloat162float(bias)));
}

// Persistent: block i takes units [i U / grid, (i + 1) U / grid) of the U =
// (B' N / 64 tiles) x (group pairs) units, pair-major, so it reloads its
// weight rows only when the pair changes. Warpgroup w takes group 2 pair + w
// of 32 columns: 32 / HD heads, JH = HD / 8 of a thread's 4 column pairs each.
template <int HD>
__global__ void __launch_bounds__(S2_THREADS, 1)
traj_stage2_kernel(const __grid_constant__ CUtensorMap t_xd,  // (B' N, C), boxes 64 x 64
                   const __grid_constant__ CUtensorMap t_x,   // (F B' N, C), boxes 64 x 64
                   const __grid_constant__ CUtensorMap t_wq,  // (C, C), boxes 64 x 64
                   const __grid_constant__ CUtensorMap t_wkv, // (2C, C), boxes 32 x 64
                   const bf16* __restrict__ bq, const bf16* __restrict__ bkv,
                   bf16* __restrict__ out, int BN, int F, int H, float scale) {
  constexpr int SUB = GW / HD, JH = HD / 8;  // heads of a group; column pairs of a head
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  const int C = H * HD;
  const int KS = (C + hopper::BK - 1) / hopper::BK;
  bf16* Bq = (bf16*)base;            // KS slices of 64 rows
  bf16* Bkv = Bq + KS * SLICE;       // KS slices of 128 rows
  bf16* A = Bkv + 2 * KS * SLICE;    // S2_STAGES x KS slices of 64 rows
  uint64_t* full = (uint64_t*)(A + S2_STAGES * KS * SLICE);
  uint64_t* empty = full + S2_STAGES;
  uint64_t* bfull = empty + S2_STAGES;
  uint64_t* bempty = bfull + 1;
  const int tiles = (BN + S2_BM - 1) / S2_BM;
  const int units = tiles * ((C + 2 * GW - 1) / (2 * GW));
  const int u0 = (int)((long long)blockIdx.x * units / gridDim.x);
  const int u1 = (int)((long long)(blockIdx.x + 1) * units / gridDim.x);
  if (threadIdx.x == 0) {
    for (int s = 0; s < S2_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);  // both warpgroups read every tile
    }
    hopper::mbar_init(bfull, 1);
    hopper::mbar_init(bempty, 2);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // the producer warp; one thread issues
    if (threadIdx.x != 256) return;
    int it = 0, nb = 0, cur = -1;
    for (int u = u0; u < u1; ++u) {
      const int hp = u / tiles, t0 = (u % tiles) * S2_BM;
      if (hp != cur) {
        if (nb > 0) hopper::mbar_wait(bempty, (nb - 1) & 1);
        hopper::mbar_expect_tx(bfull, (uint32_t)(KS * SLICE * 2 * 3));
        for (int s = 0; s < KS; ++s) {
          hopper::tma_load_2d(Bq + s * SLICE, &t_wq, bfull, s * hopper::BK, hp * 64);
          for (int w = 0; w < 2; ++w) {
            bf16* dst = Bkv + (2 * s + w) * SLICE;  // k rows, then v rows, of group 2 hp + w
            hopper::tma_load_2d(dst, &t_wkv, bfull, s * hopper::BK, (2 * hp + w) * GW);
            hopper::tma_load_2d(dst + SLICE / 2, &t_wkv, bfull, s * hopper::BK,
                                C + (2 * hp + w) * GW);
          }
        }
        ++nb;
        cur = hp;
      }
      for (int a = 0; a <= F; ++a, ++it) {  // XD, then frames 0 .. F - 1
        const int s = it % S2_STAGES;
        if (it >= S2_STAGES) hopper::mbar_wait(&empty[s], ((it / S2_STAGES) - 1) & 1);
        hopper::mbar_expect_tx(&full[s], (uint32_t)(KS * SLICE * 2));
        for (int ks = 0; ks < KS; ++ks) {
          bf16* dst = A + (s * KS + ks) * SLICE;
          if (a == 0) {
            hopper::tma_load_2d(dst, &t_xd, &full[s], ks * hopper::BK, t0);
          } else {
            hopper::tma_load_2d(dst, &t_x, &full[s], ks * hopper::BK, (a - 1) * BN + t0);
          }
        }
      }
    }
    return;
  }

  const int w = threadIdx.x >> 7;  // this warpgroup's group of the pair
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const bool leader = (threadIdx.x & 127) == 0;
  int it = 0, nb = 0, cur = -1, col0 = 0;
  __nv_bfloat162 b_q[4], b_k[4], b_v[4];  // this thread's 8 columns of the group
  for (int u = u0; u < u1; ++u) {
    const int hp = u / tiles, t0 = (u % tiles) * S2_BM;
    if (hp != cur) {
      if (cur >= 0 && leader) hopper::mbar_arrive(bempty);  // done with the last pair's rows
      hopper::mbar_wait(bfull, nb & 1);
      ++nb;
      cur = hp;
      col0 = (2 * hp + w) * GW;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + 8 * j + 2 * tq;
        const __nv_bfloat162 z = __floats2bfloat162_rn(0.f, 0.f);
        b_q[j] = col < C ? *(const __nv_bfloat162*)(bq + col) : z;
        b_k[j] = col < C ? *(const __nv_bfloat162*)(bkv + col) : z;
        b_v[j] = col < C ? *(const __nv_bfloat162*)(bkv + C + col) : z;
      }
    }
    const bf16* bq_rows = Bq + w * 32 * hopper::BK;
    const bf16* bkv_rows = Bkv + w * SLICE;

    // q2 of this group: rows r0, r0 + 8; columns 8 j + 2 tq (+1)
    float q2s[4][2][2];
    {
      const int s = it % S2_STAGES;
      hopper::mbar_wait(&full[s], (it / S2_STAGES) & 1);
      float acc[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = 0.f;
      const bf16* a = A + s * KS * SLICE;
      hopper::fence_acc(acc);
      hopper::wgmma_fence();
      for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int kk = 0; kk < hopper::BK / 16; ++kk) {
          hopper::wgmma_m64k16<32>(acc, hopper::sw128_desc(a + ks * SLICE + kk * 16),
                                hopper::sw128_desc(bq_rows + ks * SLICE + kk * 16));
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_acc(acc);
      if (leader) hopper::mbar_arrive(&empty[s]);
      ++it;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float q0 = add_bf16(acc[4 * j + 2 * r], __low2bfloat16(b_q[j]));
          const float q1 = add_bf16(acc[4 * j + 2 * r + 1], __high2bfloat16(b_q[j]));
          q2s[j][r][0] = __bfloat162float(__float2bfloat16_rn(q0 * scale));
          q2s[j][r][1] = __bfloat162float(__float2bfloat16_rn(q1 * scale));
        }
      }
    }

    // per frame: k2 and v2 of this group, each head's logit, an online
    // softmax and sum; head e holds column pairs j of e JH <= j < (e + 1) JH
    float m[SUB][2], l[SUB][2], o[4][2][2];
#pragma unroll
    for (int e = 0; e < SUB; ++e) {
      m[e][0] = m[e][1] = -INFINITY;
      l[e][0] = l[e][1] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j][0][0] = o[j][0][1] = o[j][1][0] = o[j][1][1] = 0.f;
    for (int g = 0; g < F; ++g, ++it) {
      const int s = it % S2_STAGES;
      hopper::mbar_wait(&full[s], (it / S2_STAGES) & 1);
      float acc[32];  // columns 0-31: k2; 32-63: v2
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      const bf16* a = A + s * KS * SLICE;
      hopper::fence_acc(acc);
      hopper::wgmma_fence();
      for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int kk = 0; kk < hopper::BK / 16; ++kk) {
          hopper::wgmma_m64k16<64>(acc, hopper::sw128_desc(a + ks * SLICE + kk * 16),
                                hopper::sw128_desc(bkv_rows + 2 * ks * SLICE + kk * 16));
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_acc(acc);
      if (leader) hopper::mbar_arrive(&empty[s]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int e = 0; e < SUB; ++e) {
          float logit = 0.f;
#pragma unroll
          for (int j = e * JH; j < (e + 1) * JH; ++j) {
            logit = fmaf(q2s[j][r][0], add_bf16(acc[4 * j + 2 * r], __low2bfloat16(b_k[j])), logit);
            logit = fmaf(q2s[j][r][1], add_bf16(acc[4 * j + 2 * r + 1], __high2bfloat16(b_k[j])),
                         logit);
          }
          logit = quad_sum(logit);
          const float mn = fmaxf(m[e][r], logit);
          const float corr = expf(m[e][r] - mn), p = expf(logit - mn);
          l[e][r] = l[e][r] * corr + p;
          m[e][r] = mn;
#pragma unroll
          for (int j = e * JH; j < (e + 1) * JH; ++j) {
            const float v0 = add_bf16(acc[16 + 4 * j + 2 * r], __low2bfloat16(b_v[j]));
            const float v1 = add_bf16(acc[16 + 4 * j + 2 * r + 1], __high2bfloat16(b_v[j]));
            o[j][r][0] = o[j][r][0] * corr + p * v0;
            o[j][r][1] = o[j][r][1] * corr + p * v1;
          }
        }
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = t0 + warp * 16 + (lane >> 2) + 8 * r;
      if (row >= BN) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + 8 * j + 2 * tq;
        const float rl = l[j / JH][r];
        if (col < C) {
          *(__nv_bfloat162*)(out + (size_t)row * C + col) =
              __floats2bfloat162_rn(o[j][r][0] / rl, o[j][r][1] / rl);
        }
      }
    }
  }
}

// ---- f32: two launches joined by f32 workspaces X (F, B' N, C), XD (B' N, C) ----

__device__ __forceinline__ float xor8_max(float v) {  // over the 8 lanes sharing lane >> 3
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}

__device__ __forceinline__ float xor8_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(hopper::smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Stage 1 (traj_stage1_f32_kernel): a block of 128 threads owns 64 query
// tokens of one (row, head) and stages each frame's K and V (n x d) in
// shared memory once for them. Thread (qg, sub) = (tid / 8, tid % 8) holds a
// microtile of queries qg + 16 i (i < 4): against keys sub + 8 j of each
// 32-key chunk for the scores, then dims DPT sub .. DPT sub + DPT - 1 (DPT =
// d / 8) for the PV product; at d = 32 each float4 it reads from shared
// memory feeds 4 FMAs to 16 products (8 FMAs a load), on conflict-free banks
// (rows padded by 4 floats, the score rows by 8). The softmax is exact: the
// scores go to shared memory with the row maximum kept in registers, the 8
// lanes of a query quad reduce it by shuffles, each thread turns its own
// scores into exp(s - max), the 8 lanes sum them, and each thread divides
// its own by the sum before the PV product: each p = exp(s - max) / sum is
// rounded, as in the plain softmax.
constexpr int F1_TQ = 64;
constexpr int F1_THREADS = 128;

struct Stage1LayoutF32 {
  int n32, s_ld;
  size_t k, v, s, total;  // Q at 0
};

// rows of Q and K padded by 4 floats (HD + 4: a start bank 4 more than a
// multiple of 8 at d = 8, 16, 32)
template <int HD>
__host__ __device__ inline Stage1LayoutF32 stage1_layout_f32(int n) {
  Stage1LayoutF32 L;
  L.n32 = (n + 31) / 32 * 32;
  L.s_ld = L.n32 + 8;
  L.k = (size_t)F1_TQ * (HD + 4) * 4;
  L.v = L.k + (size_t)L.n32 * (HD + 4) * 4;
  L.s = L.v + (size_t)L.n32 * HD * 4;
  L.total = L.s + (size_t)F1_TQ * L.s_ld * 4;
  return L;
}

// DPT floats as one load or store (float4, float2 or float)
template <int DPT>
__device__ __forceinline__ void ld_dims(float (&d)[DPT], const float* p) {
  if constexpr (DPT == 4) {
    const float4 t = *(const float4*)p;
    d[0] = t.x, d[1] = t.y, d[2] = t.z, d[3] = t.w;
  } else if constexpr (DPT == 2) {
    const float2 t = *(const float2*)p;
    d[0] = t.x, d[1] = t.y;
  } else {
    d[0] = *p;
  }
}

template <int DPT>
__device__ __forceinline__ void st_dims(float* p, const float (&d)[DPT]) {
  if constexpr (DPT == 4) {
    *(float4*)p = make_float4(d[0], d[1], d[2], d[3]);
  } else if constexpr (DPT == 2) {
    *(float2*)p = make_float2(d[0], d[1]);
  } else {
    *p = d[0];
  }
}

// grid (ceil(N / 64), h, B'); 128 threads. X: (F, B' N, C), XD: (B' N, C).
template <int HD>
__global__ void __launch_bounds__(F1_THREADS)
traj_stage1_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ X,
                       float* __restrict__ XD, int B, int N, int F, int C, float scale) {
  constexpr int F1_LD = HD + 4, DPT = HD / 8, C4 = HD / 4;  // C4: float4s of a head row
  extern __shared__ __align__(16) unsigned char smf1[];
  const int n = N / F;
  const Stage1LayoutF32 L = stage1_layout_f32<HD>(n);
  float* Qs = (float*)smf1;
  float* Ks = (float*)(smf1 + L.k);
  float* Vs = (float*)(smf1 + L.v);
  float* Ss = (float*)(smf1 + L.s);
  const int tid = threadIdx.x, sub = tid & 7, qg = tid >> 3;
  const int hc = blockIdx.y * HD;
  const int b = blockIdx.z;
  const size_t base = (size_t)b * N * C;
  const int s0 = blockIdx.x * F1_TQ;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i = tid; i < F1_TQ * C4; i += F1_THREADS) {
    const int r = i / C4, c4 = i % C4;
    float4 val = zero;
    if (s0 + r < N) val = *(const float4*)(q + base + (size_t)(s0 + r) * C + hc + 4 * c4);
    *(float4*)(Qs + r * F1_LD + 4 * c4) = val;
  }

  const int nch = L.n32 / 32;
  const int n4 = (n + 3) & ~3;
  for (int g = 0; g < F; ++g) {
    __syncthreads();  // Q is staged; the previous frame's K, V and S are no longer read
    for (int i = tid; i < L.n32 * C4; i += F1_THREADS) {
      const int j = i / C4, c4 = i % C4;
      float4 kv = zero, vv = zero;
      if (j < n) {
        const size_t off = base + (size_t)(g * n + j) * C + hc + 4 * c4;
        kv = *(const float4*)(k + off);
        vv = *(const float4*)(v + off);
      }
      *(float4*)(Ks + j * F1_LD + 4 * c4) = kv;
      *(float4*)(Vs + j * HD + 4 * c4) = vv;
    }
    __syncthreads();

    // scores, scaled, into S; keys past n at -inf
    float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    for (int c = 0; c < nch; ++c) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = *(const float4*)(Qs + (qg + 16 * i) * F1_LD + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = *(const float4*)(Ks + (c * 32 + sub + 8 * j) * F1_LD + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = dot4(qv[i], kv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = c * 32 + sub + 8 * j;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float s = key < n ? scale * acc[i][j] : -INFINITY;
          mx[i] = fmaxf(mx[i], s);
          Ss[(qg + 16 * i) * L.s_ld + key] = s;
        }
      }
    }
    // exp(s - max) in place (each thread its own entries) and the row sums
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) mx[i] = xor8_max(mx[i]);
    for (int c = 0; c < nch; ++c) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* sp = Ss + (qg + 16 * i) * L.s_ld + c * 32 + sub + 8 * j;
          const float e = expf(*sp - mx[i]);
          *sp = e;
          sum[i] += e;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) sum[i] = xor8_sum(sum[i]);
    for (int c = 0; c < nch; ++c) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* sp = Ss + (qg + 16 * i) * L.s_ld + c * 32 + sub + 8 * j;
          *sp = *sp / sum[i];
        }
      }
    }
    __syncthreads();  // S complete

    float o[4][DPT];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int e = 0; e < DPT; ++e) o[i][e] = 0.f;
    }
    for (int j = 0; j < n4; j += 4) {
      float4 sv[4];
      float vv[4][DPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = *(const float4*)(Ss + (qg + 16 * i) * L.s_ld + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) ld_dims<DPT>(vv[jj], Vs + (j + jj) * HD + DPT * sub);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p[4] = {sv[i].x, sv[i].y, sv[i].z, sv[i].w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
          for (int e = 0; e < DPT; ++e) o[i][e] = fmaf(p[jj], vv[jj][e], o[i][e]);
        }
      }
    }

    const size_t frame = (size_t)g * B * N;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = s0 + qg + 16 * i;
      if (s >= N) continue;
      const size_t tok = (size_t)b * N + s;
      st_dims<DPT>(X + (frame + tok) * C + hc + DPT * sub, o[i]);
      if (s / n == g) st_dims<DPT>(XD + tok * C + hc + DPT * sub, o[i]);
    }
  }
}

// Stage 2 (traj_stage2_f32_kernel): a register-blocked SGEMM over the B' N
// tokens flattened across rows, in units of (group of 32 columns, 128-token
// tile), group major. A persistent block of 256 threads keeps one group's
// rows of Wq, Wk and Wv (3 x 32 x C f32, 96 KB at C = 256) resident in
// shared memory, so a block with a run of units loads them about once, and
// streams each unit's XD tile, then its F frames of X, through a 3-slot
// cp.async ring of 128 x 64 slices. Thread (rg, cg) = (tid / 8, tid % 8)
// owns tokens rg + 32 i and the group's columns cg + 8 j (i, j < 4) of q2,
// k2 and v2: per 4 columns of depth it reads 4 float4 of X and 4 (q2) or 8
// (k2, v2) float4 of weights for 64 or 128 FMAs. The epilogue of each frame
// takes the temporal softmax on the registers: the biases, each head's
// logit over its d columns (its d / 8 columns of each of the 8 lanes, by
// shuffles), an online softmax and sum over the frames, and one division at
// the end. Measured against this: slices of 32 columns (twice
// the barriers) were slower; so were 2 tokens a thread (more units at the
// small shapes), also as 512 threads; 8 tokens a thread (255 registers)
// were no faster a token.
constexpr int F2_BK = 64;
constexpr int F2_LDA = F2_BK + 4;
constexpr int F2_STAGES = 3;
constexpr int F2_THREADS = 256;

constexpr int TM = 4;  // tokens a thread
constexpr int F2_BM = 32 * TM;

__host__ __device__ inline size_t stage2_smem_f32(int C) {
  return ((size_t)3 * GW * (C + 4) + (size_t)F2_STAGES * F2_BM * F2_LDA) * 4;
}

// PART: C is not a multiple of 32, so the last group is part (16 columns)
// and its last 64-column slice may be a quarter one. Without it (every C of
// d = 32) no column bound is tested and the slice loop stops only at a half
// slice: those tests at every C cost stage 2 about 3% at d = 32 (H100).
template <int HD, bool PART>
__global__ void __launch_bounds__(F2_THREADS, 1)
traj_stage2_f32_kernel(const float* __restrict__ X, const float* __restrict__ XD,
                       const float* __restrict__ wq, const float* __restrict__ bq,
                       const float* __restrict__ wkv, const float* __restrict__ bkv,
                       float* __restrict__ out, int BN, int F, int H, float scale) {
  constexpr int SUB = GW / HD, JH = HD / 8;  // heads of a group; columns of a head a lane
  constexpr int KSTEP = PART ? 16 : 32;  // the depth a part slice ends at a multiple of
  extern __shared__ __align__(16) float smf2[];
  const int C = H * HD, ldw = C + 4;
  float* Wq_s = smf2;
  float* Wk_s = Wq_s + GW * ldw;
  float* Wv_s = Wk_s + GW * ldw;
  float* As = Wv_s + GW * ldw;
  const int tid = threadIdx.x, cg = tid & 7, rg = tid >> 3;
  const int tiles = (BN + F2_BM - 1) / F2_BM;
  const int units = tiles * ((C + GW - 1) / GW);
  const int u0 = (int)((long long)blockIdx.x * units / gridDim.x);
  const int u1 = (int)((long long)(blockIdx.x + 1) * units / gridDim.x);
  const int KS = (C + F2_BK - 1) / F2_BK;  // the last slice may be part (C % 64 != 0)
  const int per_unit = (F + 1) * KS;  // slices: XD, then frames 0 .. F - 1
  const int total = (u1 - u0) * per_unit;

  auto issue = [&](int idx) {
    if (idx < total) {
      const int u = u0 + idx / per_unit, rem = idx % per_unit;
      const int a = rem / KS, ks = rem % KS;
      const int t0 = (u % tiles) * F2_BM;
      const float* src = a == 0 ? XD : X + (size_t)(a - 1) * BN * C;
      float* dst = As + (idx % F2_STAGES) * F2_BM * F2_LDA;
      for (int i = tid; i < F2_BM * (F2_BK / 4); i += F2_THREADS) {
        const int r = i / (F2_BK / 4), c4 = i % (F2_BK / 4);
        const int row = t0 + r, col = ks * F2_BK + 4 * c4;
        const bool in = row < BN && col < C;  // else zeros
        cp_async16(dst + r * F2_LDA + 4 * c4, src + (in ? (size_t)row * C + col : 0),
                   in ? 16 : 0);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < F2_STAGES - 1; ++s) issue(s);

  int cur = -1;
  float bqr[4], bkr[4], bvr[4];
  float q2[TM][4], ak[TM][4], av[TM][4], o[TM][4], mx[TM][SUB], l[TM][SUB];
  for (int idx = 0; idx < total; ++idx) {
    const int u = u0 + idx / per_unit, rem = idx % per_unit;
    const int a = rem / KS, ks = rem % KS;
    const int group = u / tiles, t0 = (u % tiles) * F2_BM;
    const int col0 = group * GW;
    if (group != cur) {  // the same for the whole block
      __syncthreads();  // every thread is done with the last group's rows
      for (int i = tid; i < 3 * GW * (C / 4); i += F2_THREADS) {
        const int r = i / (C / 4), c4 = i % (C / 4);  // r: Wq rows, then Wk, then Wv
        const int m = r / GW, row = col0 + r % GW;  // zeros past C
        const float* src = m == 0 ? wq + (size_t)row * C : wkv + (size_t)((m - 1) * C + row) * C;
        *(float4*)(Wq_s + r * ldw + 4 * c4) = !PART || row < C
                                                  ? *(const float4*)(src + 4 * c4)
                                                  : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + cg + 8 * j;
        const bool in = !PART || col < C;
        bqr[j] = in ? bq[col] : 0.f;
        bkr[j] = in ? bkv[col] : 0.f;
        bvr[j] = in ? bkv[C + col] : 0.f;
      }
      cur = group;
    }
    cp_async_wait<F2_STAGES - 2>();
    __syncthreads();  // slice idx (and the weights) visible; slot (idx - 1) % STAGES free
    issue(idx + F2_STAGES - 1);

    if (ks == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) ak[i][j] = av[i][j] = 0.f;
      }
    }
    const float* A = As + (idx % F2_STAGES) * F2_BM * F2_LDA;
    const int kc = ks * F2_BK;
    if (a == 0) {  // q2 of the group, into ak
#pragma unroll
      for (int kk = 0; kk < F2_BK; kk += 4) {
        if (kk % KSTEP == 0 && kc + kk >= C) break;  // a part slice past C
        float4 x4[TM], w4[4];
#pragma unroll
        for (int i = 0; i < TM; ++i) x4[i] = *(const float4*)(A + (rg + 32 * i) * F2_LDA + kk);
#pragma unroll
        for (int j = 0; j < 4; ++j) w4[j] = *(const float4*)(Wq_s + (cg + 8 * j) * ldw + kc + kk);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) ak[i][j] = dot4(x4[i], w4[j], ak[i][j]);
        }
      }
    } else {  // k2 and v2 of the group for frame a - 1
#pragma unroll
      for (int kk = 0; kk < F2_BK; kk += 4) {
        if (kk % KSTEP == 0 && kc + kk >= C) break;
        float4 x4[TM], k4[4], v4[4];
#pragma unroll
        for (int i = 0; i < TM; ++i) x4[i] = *(const float4*)(A + (rg + 32 * i) * F2_LDA + kk);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          k4[j] = *(const float4*)(Wk_s + (cg + 8 * j) * ldw + kc + kk);
          v4[j] = *(const float4*)(Wv_s + (cg + 8 * j) * ldw + kc + kk);
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            ak[i][j] = dot4(x4[i], k4[j], ak[i][j]);
            av[i][j] = dot4(x4[i], v4[j], av[i][j]);
          }
        }
      }
    }
    if (ks != KS - 1) continue;

    if (a == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          q2[i][j] = (ak[i][j] + bqr[j]) * scale;
          o[i][j] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < SUB; ++e) {
          mx[i][e] = -INFINITY;
          l[i][e] = 0.f;
        }
      }
      continue;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int e = 0; e < SUB; ++e) {  // head e: columns j of e JH <= j < (e + 1) JH
        float logit = 0.f;
#pragma unroll
        for (int j = e * JH; j < (e + 1) * JH; ++j) {
          logit = fmaf(q2[i][j], ak[i][j] + bkr[j], logit);
        }
        logit = xor8_sum(logit);  // the head's d columns
        const float mn = fmaxf(mx[i][e], logit);
        const float corr = expf(mx[i][e] - mn), p = expf(logit - mn);
        l[i][e] = l[i][e] * corr + p;
        mx[i][e] = mn;
#pragma unroll
        for (int j = e * JH; j < (e + 1) * JH; ++j) {
          o[i][j] = o[i][j] * corr + p * (av[i][j] + bvr[j]);
        }
      }
    }
    if (a == F) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int row = t0 + rg + 32 * i;
        if (row >= BN) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = col0 + cg + 8 * j;
          if (!PART || col < C) out[(size_t)row * C + col] = o[i][j] / l[i][j / JH];
        }
      }
    }
  }
  cp_async_wait<0>();
}

constexpr int MAX_DEVICES = 64;

// The index of a head width among the instantiated ones (8, 16, 32), or -1.
constexpr int width_index(int d) {
  return d == 8 ? 0 : d == 16 ? 1 : d == 32 ? 2 : -1;
}

// The dynamic shared memory each kernel has been allowed so far on a device,
// per head width (f32 stage 2: per width and PART).
struct SmemAllowed {
  size_t smem1[3] = {0, 0, 0}, smem2[3] = {0, 0, 0};
  size_t smem1_f32[3] = {0, 0, 0}, smem2_f32[3][2] = {{0, 0}, {0, 0}, {0, 0}};
};

SmemAllowed& smem_allowed(int dev) {
  static SmemAllowed allowed[MAX_DEVICES];  // once a device: a host-side cost per call
  return allowed[dev];
}

// Allows `kernel` `bytes` of dynamic shared memory unless it already may use
// as much (`allowed`, updated).
template <class Kernel>
cudaError_t raise_smem(Kernel kernel, size_t& allowed, size_t bytes) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, const void* wq, const void* bq,
                const void* wkv, const void* bkv, void* out, void* x_ws, void* xd_ws, int B,
                int N, int F, int H, float scale, cudaStream_t stream) {
  constexpr int wi = width_index(HD);
  const int n = N / F, C = H * HD;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = hopper::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  SmemAllowed& dc = smem_allowed(dev);
  const size_t smem1 = stage1_layout<HD>(n).total;
  err = raise_smem(traj_stage1_kernel<HD>, dc.smem1[wi], smem1);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid1((N + S1_TQ - 1) / S1_TQ, H, B);
  traj_stage1_kernel<HD><<<grid1, S1_WARPS * 32, smem1, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)x_ws, (bf16*)xd_ws, B, N, F, C,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long bn = (long long)B * N;
  if (bn * F > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int BN = (int)bn;
  CUtensorMap t_xd, t_x, t_wq, t_wkv;
  int status = hopper::make_map(&t_xd, xd_ws, BN, C, S2_BM);
  if (!status) status = hopper::make_map(&t_x, x_ws, F * BN, C, S2_BM);
  if (!status) status = hopper::make_map(&t_wq, wq, C, C, 2 * GW);
  if (!status) status = hopper::make_map(&t_wkv, wkv, 2 * C, C, GW);
  if (status) return status;
  const size_t smem2 = stage2_smem((C + hopper::BK - 1) / hopper::BK);
  err = raise_smem(traj_stage2_kernel<HD>, dc.smem2[wi], smem2);
  if (err != cudaSuccess) return (int)err;
  const long long units = (long long)((BN + S2_BM - 1) / S2_BM) * ((C + 2 * GW - 1) / (2 * GW));
  const int grid2 = (int)(units < sms ? units : sms);
  traj_stage2_kernel<HD><<<grid2, S2_THREADS, smem2, stream>>>(
      t_xd, t_x, t_wq, t_wkv, (const bf16*)bq, (const bf16*)bkv, (bf16*)out, BN, F, H, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_f32(const float* q, const float* k, const float* v, const float* wq, const float* bq,
               const float* wkv, const float* bkv, float* out, float* x_ws, float* xd_ws, int B,
               int N, int F, int H, float scale, cudaStream_t stream) {
  constexpr int wi = width_index(HD);
  const int n = N / F, C = H * HD;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = hopper::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  SmemAllowed& dc = smem_allowed(dev);
  const size_t smem1 = stage1_layout_f32<HD>(n).total;
  err = raise_smem(traj_stage1_f32_kernel<HD>, dc.smem1_f32[wi], smem1);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid1((N + F1_TQ - 1) / F1_TQ, H, B);
  traj_stage1_f32_kernel<HD><<<grid1, F1_THREADS, smem1, stream>>>(q, k, v, x_ws, xd_ws, B, N,
                                                                    F, C, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long bn = (long long)B * N;
  if (bn * F > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int BN = (int)bn;
  const size_t smem2 = stage2_smem_f32(C);
  const long long units = (long long)((BN + F2_BM - 1) / F2_BM) * ((C + GW - 1) / GW);
  const int grid2 = (int)(units < sms ? units : sms);
  if (C % GW == 0) {
    err = raise_smem(traj_stage2_f32_kernel<HD, false>, dc.smem2_f32[wi][0], smem2);
    if (err != cudaSuccess) return (int)err;
    traj_stage2_f32_kernel<HD, false><<<grid2, F2_THREADS, smem2, stream>>>(
        x_ws, xd_ws, wq, bq, wkv, bkv, out, BN, F, H, scale);
  } else if constexpr (HD < GW) {  // h d = 16 mod 32: d of 8 or 16
    err = raise_smem(traj_stage2_f32_kernel<HD, true>, dc.smem2_f32[wi][1], smem2);
    if (err != cudaSuccess) return (int)err;
    traj_stage2_f32_kernel<HD, true><<<grid2, F2_THREADS, smem2, stream>>>(
        x_ws, xd_ws, wq, bq, wkv, bkv, out, BN, F, H, scale);
  }
  return (int)cudaGetLastError();
}

// Whether the kernels take n tokens a frame, f frames and h heads of d: d an
// instantiated width, C = h d a multiple of 16.
bool takes(int n, int f, int h, int d) {
  return n > 0 && f > 0 && f <= MAX_F && h > 0 && h <= MAX_H && width_index(d) >= 0 &&
         (h * d) % 16 == 0;
}

size_t smem_bytes(int n, int d) {  // stage 1's shared memory, bf16
  return d == 8 ? stage1_layout<8>(n).total
                : d == 16 ? stage1_layout<16>(n).total : stage1_layout<32>(n).total;
}

size_t smem_bytes_f32(int n, int d) {  // stage 1's shared memory, f32
  return d == 8 ? stage1_layout_f32<8>(n).total
                : d == 16 ? stage1_layout_f32<16>(n).total : stage1_layout_f32<32>(n).total;
}

}  // namespace

// Shared memory the bf16 path needs for n tokens per frame, f frames, h heads
// of d: the larger of its two launches (-1 for a shape it does not take).
extern "C" int axvs_traj_smem_bytes(int n, int f, int h, int d) {
  if (!takes(n, f, h, d)) return -1;
  const size_t s1 = smem_bytes(n, d);
  const size_t s2 = stage2_smem((h * d + hopper::BK - 1) / hopper::BK);
  const size_t bytes = s1 > s2 ? s1 : s2;
  return bytes > 2147483647u ? -1 : (int)bytes;
}

// q, k, v, out (B, N, C); wq (C, C); bq (C,); wkv (2C, C); bkv (2C,): bf16,
// contiguous, 32-byte aligned; C = H D, D = 8, 16 or 32, C a multiple of 16;
// N = F n, tokens frame-major. x_ws (F, B N, C) and xd_ws (B N, C): bf16
// workspaces, 16-byte aligned, for the trajectory and its frame diagonal.
// Launches stage 1, then stage 2, on `stream` and returns 0 or the first CUDA
// error.
extern "C" int axvs_traj_fwd(const void* q, const void* k, const void* v,
                             const void* wq, const void* bq, const void* wkv,
                             const void* bkv, void* out, void* x_ws, void* xd_ws, int B,
                             int N, int F, int H, int D, float scale, void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || F <= 0 || N % F != 0 || !takes(N / F, F, H, D)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto launch = D == 8 ? launch_bf16<8> : D == 16 ? launch_bf16<16> : launch_bf16<32>;
  return launch(q, k, v, wq, bq, wkv, bkv, out, x_ws, xd_ws, B, N, F, H, scale,
                (cudaStream_t)stream);
}

// Shared memory the f32 path needs (-1 for a shape it does not take): the
// larger of its two launches.
extern "C" int axvs_traj_smem_bytes_f32(int n, int f, int h, int d) {
  if (!takes(n, f, h, d)) return -1;
  const size_t s1 = smem_bytes_f32(n, d);
  const size_t s2 = stage2_smem_f32(h * d);
  const size_t bytes = s1 > s2 ? s1 : s2;
  return bytes > 2147483647u ? -1 : (int)bytes;
}

// The same as axvs_traj_fwd with every tensor f32 (workspaces included),
// 16-byte aligned.
extern "C" int axvs_traj_fwd_f32(const void* q, const void* k, const void* v,
                                 const void* wq, const void* bq, const void* wkv,
                                 const void* bkv, void* out, void* x_ws, void* xd_ws, int B,
                                 int N, int F, int H, int D, float scale, void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || F <= 0 || N % F != 0 || !takes(N / F, F, H, D)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto launch = D == 8 ? launch_f32<8> : D == 16 ? launch_f32<16> : launch_f32<32>;
  return launch((const float*)q, (const float*)k, (const float*)v, (const float*)wq,
                (const float*)bq, (const float*)wkv, (const float*)bkv, (float*)out,
                (float*)x_ws, (float*)xd_ws, B, N, F, H, scale, (cudaStream_t)stream);
}
