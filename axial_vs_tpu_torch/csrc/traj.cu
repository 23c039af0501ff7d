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
// The f32 instantiation (the reference's default dtype) is a kernel of its
// own, traj_fwd_f32_kernel: one block of h warps (a warp per head) per 16
// tokens of a row, every product an f32 FMA on the CUDA cores (no TF32: the
// reference's f32 path is full f32). Stage 1 has lane j of a warp own keys
// j, j + 32, ...: it holds a key's 32 dims in registers and scores it
// against the 16 queries of the tile (the tile is in shared memory), then
// the exact softmax runs per query row and the PV product runs with lanes
// over the head dim. Stage 2 has lane i own output column i of the warp's
// head: it streams that column's rows of Wq and Wkv from L2 as float4s and
// reuses each against the 16 tokens' trajectory in shared memory; the
// softmax over the f frames is taken online.

#include "hopper.cuh"  // mbarriers, TMA, wgmma descriptors and products, the SM count

namespace {

namespace hopper = axvs_hopper;
typedef __nv_bfloat16 bf16;

constexpr int HD = 32;     // head dim
constexpr int TQ = 16;     // query tokens per block of the f32 kernel
constexpr int MAX_F = 8;   // frames
constexpr int MAX_H = 8;   // heads

// ---- bf16, stage 1 ----

constexpr int S1_WARPS = 4;
constexpr int S1_TQ = 16 * S1_WARPS;  // query tokens of a block
constexpr int KCH = 64;               // keys whose scores a warp holds at once
constexpr int K_LD = HD + 8;          // bf16 row of the staged keys: 20 words

// Shared memory of stage 1: one frame's keys of one head (n_pad x K_LD) and
// its values transposed (HD x vt_ld), zero past n. vt_ld / 2 words is 4
// more than a multiple of 8, so the 8 rows a B fragment reads fall on
// distinct banks; so does K_LD's 20.
struct Stage1Layout {
  int n_pad, vt_ld;
  size_t k, vt, total;
};

__host__ __device__ inline Stage1Layout stage1_layout(int n) {
  Stage1Layout L;
  L.n_pad = (n + 15) / 16 * 16;
  L.vt_ld = L.n_pad + 8;
  L.k = 0;
  L.vt = (size_t)L.n_pad * K_LD * 2;
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
__global__ void __launch_bounds__(S1_WARPS * 32)
traj_stage1_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ X,
                   bf16* __restrict__ XD, int B, int N, int F, int C, float scale) {
  extern __shared__ __align__(16) unsigned char smem1[];
  const int n = N / F;
  const Stage1Layout L = stage1_layout(n);
  bf16* Ks = (bf16*)(smem1 + L.k);
  bf16* Vt = (bf16*)(smem1 + L.vt);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int hc = blockIdx.y * HD;
  const int b = blockIdx.z;
  const size_t base = (size_t)b * N * C;
  const int sq = blockIdx.x * S1_TQ + warp * 16 + gq;  // rows sq and sq + 8

  uint32_t qa[2][4];  // this warp's 16 queries as A fragments, zero past N
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = sq + 8 * (i & 1);
      const int col = hc + 16 * kk + 2 * tq + 8 * (i >> 1);
      qa[kk][i] = s < N ? ld32(q + base + (size_t)s * C + col) : 0u;
    }
  }

  const int nch = (n + KCH - 1) / KCH;
  for (int g = 0; g < F; ++g) {
    __syncthreads();  // the previous frame's K and V are no longer read
    for (int i = threadIdx.x; i < L.n_pad * (HD / 8); i += blockDim.x) {
      const int j = i >> 2, ch = i & 3;  // key, 8-dim piece
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
          for (int kk = 0; kk < 2; ++kk) mma16816(acc, qa[kk], ld32(kr + 16 * kk), ld32(kr + 16 * kk + 8));
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
// slices of 64 columns: Wq rows of the head pair (64 x C), Wkv rows (k0, v0,
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
// (B' N / 64 tiles) x (head pairs) units, pair-major, so it reloads its
// weight rows only when the pair changes.
__global__ void __launch_bounds__(S2_THREADS, 1)
traj_stage2_kernel(const __grid_constant__ CUtensorMap t_xd,  // (B' N, C), boxes 64 x 64
                   const __grid_constant__ CUtensorMap t_x,   // (F B' N, C), boxes 64 x 64
                   const __grid_constant__ CUtensorMap t_wq,  // (C, C), boxes 64 x 64
                   const __grid_constant__ CUtensorMap t_wkv, // (2C, C), boxes 32 x 64
                   const bf16* __restrict__ bq, const bf16* __restrict__ bkv,
                   bf16* __restrict__ out, int BN, int F, int H, float scale) {
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
  const int units = tiles * ((H + 1) / 2);
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
            bf16* dst = Bkv + (2 * s + w) * SLICE;  // k rows, then v rows, of head 2 hp + w
            hopper::tma_load_2d(dst, &t_wkv, bfull, s * hopper::BK, (2 * hp + w) * HD);
            hopper::tma_load_2d(dst + SLICE / 2, &t_wkv, bfull, s * hopper::BK, C + (2 * hp + w) * HD);
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

  const int w = threadIdx.x >> 7;  // this warpgroup's head of the pair
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const bool leader = (threadIdx.x & 127) == 0;
  int it = 0, nb = 0, cur = -1, head = 0;
  __nv_bfloat162 b_q[4], b_k[4], b_v[4];  // this thread's 8 columns of the head
  for (int u = u0; u < u1; ++u) {
    const int hp = u / tiles, t0 = (u % tiles) * S2_BM;
    if (hp != cur) {
      if (cur >= 0 && leader) hopper::mbar_arrive(bempty);  // done with the last pair's rows
      hopper::mbar_wait(bfull, nb & 1);
      ++nb;
      cur = hp;
      head = 2 * hp + w;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = head * HD + 8 * j + 2 * tq;
        const __nv_bfloat162 z = __floats2bfloat162_rn(0.f, 0.f);
        b_q[j] = head < H ? *(const __nv_bfloat162*)(bq + col) : z;
        b_k[j] = head < H ? *(const __nv_bfloat162*)(bkv + col) : z;
        b_v[j] = head < H ? *(const __nv_bfloat162*)(bkv + C + col) : z;
      }
    }
    const bf16* bq_rows = Bq + w * 32 * hopper::BK;
    const bf16* bkv_rows = Bkv + w * SLICE;

    // q2 of this head: rows r0, r0 + 8; columns 8 j + 2 tq (+1)
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

    // per frame: k2 and v2 of this head, the logit, an online softmax and sum
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, o[4][2][2];
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
        float logit = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          logit = fmaf(q2s[j][r][0], add_bf16(acc[4 * j + 2 * r], __low2bfloat16(b_k[j])), logit);
          logit = fmaf(q2s[j][r][1], add_bf16(acc[4 * j + 2 * r + 1], __high2bfloat16(b_k[j])),
                       logit);
        }
        logit = quad_sum(logit);
        const float mn = fmaxf(m[r], logit);
        const float corr = expf(m[r] - mn), p = expf(logit - mn);
        l[r] = l[r] * corr + p;
        m[r] = mn;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float v0 = add_bf16(acc[16 + 4 * j + 2 * r], __low2bfloat16(b_v[j]));
          const float v1 = add_bf16(acc[16 + 4 * j + 2 * r + 1], __high2bfloat16(b_v[j]));
          o[j][r][0] = o[j][r][0] * corr + p * v0;
          o[j][r][1] = o[j][r][1] * corr + p * v1;
        }
      }
    }

    if (head < H) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = t0 + warp * 16 + (lane >> 2) + 8 * r;
        if (row >= BN) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          *(__nv_bfloat162*)(out + (size_t)row * C + head * HD + 8 * j + 2 * tq) =
              __floats2bfloat162_rn(o[j][r][0] / l[r], o[j][r][1] / l[r]);
        }
      }
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

constexpr int MAX_DEVICES = 64;

// The dynamic shared memory each kernel has been allowed so far on a device.
struct SmemAllowed {
  size_t smem1 = 0, smem2 = 0;
};

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

int launch_bf16(const void* q, const void* k, const void* v, const void* wq, const void* bq,
                const void* wkv, const void* bkv, void* out, void* x_ws, void* xd_ws, int B,
                int N, int F, int H, float scale, cudaStream_t stream) {
  const int n = N / F, C = H * HD;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = hopper::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  static SmemAllowed allowed[MAX_DEVICES];  // once a device: a host-side cost per call
  SmemAllowed& dc = allowed[dev];
  const size_t smem1 = stage1_layout(n).total;
  err = raise_smem(traj_stage1_kernel, dc.smem1, smem1);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid1((N + S1_TQ - 1) / S1_TQ, H, B);
  traj_stage1_kernel<<<grid1, S1_WARPS * 32, smem1, stream>>>(
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
  if (!status) status = hopper::make_map(&t_wq, wq, C, C, 64);
  if (!status) status = hopper::make_map(&t_wkv, wkv, 2 * C, C, HD);
  if (status) return status;
  const size_t smem2 = stage2_smem((C + hopper::BK - 1) / hopper::BK);
  err = raise_smem(traj_stage2_kernel, dc.smem2, smem2);
  if (err != cudaSuccess) return (int)err;
  const long long units = (long long)((BN + S2_BM - 1) / S2_BM) * ((H + 1) / 2);
  const int grid2 = (int)(units < sms ? units : sms);
  traj_stage2_kernel<<<grid2, S2_THREADS, smem2, stream>>>(
      t_xd, t_x, t_wq, t_wkv, (const bf16*)bq, (const bf16*)bkv, (bf16*)out, BN, F, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory the bf16 path needs for n tokens per frame, f frames, h heads
// of 32: the larger of its two launches (-1 for a shape it does not take).
extern "C" int axvs_traj_smem_bytes(int n, int f, int h) {
  if (n <= 0 || f <= 0 || f > MAX_F || h <= 0 || h > MAX_H) return -1;
  const size_t s1 = stage1_layout(n).total;
  const size_t s2 = stage2_smem((h * HD + hopper::BK - 1) / hopper::BK);
  const size_t bytes = s1 > s2 ? s1 : s2;
  return bytes > 2147483647u ? -1 : (int)bytes;
}

// q, k, v, out (B, N, C); wq (C, C); bq (C,); wkv (2C, C); bkv (2C,): bf16,
// contiguous, 32-byte aligned; C = 32 H; N = F n, tokens frame-major. x_ws
// (F, B N, C) and xd_ws (B N, C): bf16 workspaces, 16-byte aligned, for the
// trajectory and its frame diagonal. Launches stage 1, then stage 2, on
// `stream` and returns 0 or the first CUDA error.
extern "C" int axvs_traj_fwd(const void* q, const void* k, const void* v,
                             const void* wq, const void* bq, const void* wkv,
                             const void* bkv, void* out, void* x_ws, void* xd_ws, int B,
                             int N, int F, int H, float scale, void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || F <= 0 || F > MAX_F || N % F != 0 ||
      H <= 0 || H > MAX_H) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_bf16(q, k, v, wq, bq, wkv, bkv, out, x_ws, xd_ws, B, N, F, H, scale,
                     (cudaStream_t)stream);
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
