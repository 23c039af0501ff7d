// Multi-scale deformable attention, forward, bf16 or f32 value and weights.
//
// Replaces the TPU kernel axial_vs_tpu/ops/msda_pallas.py::
// weighted_corner_reduce_v4 (Pallas body `_v4_kernel`) together with the
// corner-table gathers around it in axial_vs_tpu/ops/msda.py::ms_deform_attn:
//   out[b, q, m, :] = sum_{l, p} w[b, q, m, l, p] *
//                     bilinear(value[b, level l, :, m, :], loc[b, q, m, l, p])
// with zero padding and align_corners=False, as F.grid_sample samples.
//
// What bounds it on an H100: the gather. At the within-clip shape (value
// 2 x 21168 x 8 x 32 bf16 = 21.7 MB, 2 x 21168 x 8 query rows, 3 levels x 4
// points) each row reads 12 samples x 4 corners x 64 B = 3 KB of value, about
// 1 GB of 32-byte sectors per call (sizes computed from the shapes), while
// value itself fits in the 50 MB L2. Device memory sees each input once; the
// corner reads are served by L1 and L2, and what limits the kernel is how
// many of them a warp keeps in flight, and the instructions around each.
//
// The first design gave a (b, q, m) row to a warp, lanes over the head dim:
// at D = 32 bf16 a lane loaded 2 bytes a corner, every lane repeated the
// row's coordinate math, and a data-dependent branch per sample kept the
// loads of one sample from overlapping the next. This design:
//  - Rows and lanes. A row goes to a group of G lanes, each lane owning VEC
//    = 16 / sizeof(T) channels through 16-byte loads (8 bf16, 4 f32); G is
//    the power of two >= D / VEC, so at D = 32 a bf16 warp holds 8 rows of
//    4 lanes and an f32 warp 4 rows of 8. Each lane sums its own channels
//    over all samples in a fixed order: no cross-lane sum, and the result is
//    the same bits on every run.
//  - Coordinates once per row. Lane j of a group computes samples j, j + G,
//    ... : the bilinear corner weights (attention weight folded in, zero for
//    a corner outside the level, NaN and far-outside locations included) and
//    the corners' pixel index, clamped into the level so that every load is
//    in bounds and the loads carry no branch. __shfl_sync passes each
//    sample's 5 words to the group.
//  - Loads before FMAs. Specialised by template for L = 3 levels and P = 4
//    points (the WC module's and the Tube-Link pixel decoder's), all corner
//    loads of a level (16 x 16 bytes a lane) are issued before their FMAs,
//    through the read-only, L1-cached path; with no branch between levels
//    the compiler may hoist the next level's loads too.
//  - Row order. A block of 256 threads holds 256 / G rows, either all heads
//    of a run of tokens (`order` 0, the memory order) or a run of tokens of
//    one head (`order` 1). Neighbouring tokens of a head share most of their
//    corners (the layer samples a few pixels around each token's own), which
//    order 1 keeps together. On the layers' own locations order 0 measured
//    a few percent faster in bf16 (64 rows a block), order 1 in f32 (32);
//    the wrapper takes those. A persistent grid that walked one contiguous
//    range of rows per SM, for more L1 hits, measured slower in both.
//  - At most 64 registers a thread (4 blocks of 256 an SM; ptxas spills a
//    few words to local memory): as fast in bf16 as the 78 registers it
//    took unbounded, and faster in f32.
//  - Other shapes. A generic instantiation (any L <= 8 and P, runtime G)
//    computes a chunk of G samples at a time. With `vec` 0 it runs one
//    channel a lane, up to 32 lanes a row and passes over D: the path for D
//    not a multiple of VEC, or value, loc or out not aligned for vectors.
// The sum over levels, points and corners accumulates in f32 and is rounded
// once. The f32 instantiation (the reference's default dtype) reads f32
// value and weights and writes f32, with the same arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

struct Levels {
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int start[MAX_LEVELS];
};

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

// One sample's corners: the pixel index (in S) of its top-left corner, times
// 4, plus 1 if the right corner is one pixel over and 2 if the bottom one is
// one row down (else a clamped corner repeats the pixel), and the four
// weights (top-left, top-right, bottom-left, bottom-right), zero for a corner
// outside the level.
struct Sample {
  int pk;
  float w[4];
};

__device__ __forceinline__ Sample make_sample(float lx, float ly, float aw, int hl, int wl,
                                              int start) {
  float ix = lx * (float)wl - 0.5f;
  float iy = ly * (float)hl - 0.5f;
  // no corner inside the level (NaN included): weight 0, corner 0
  const bool any = ix > -1.f && ix < (float)wl && iy > -1.f && iy < (float)hl;
  ix = any ? ix : 0.f;
  iy = any ? iy : 0.f;
  aw = any ? aw : 0.f;
  const float fx = floorf(ix), fy = floorf(iy);
  const int x0 = (int)fx, y0 = (int)fy;  // in [-1, w - 1] and [-1, h - 1]
  const float tx = ix - fx, ty = iy - fy;
  const bool xin0 = x0 >= 0, xin1 = x0 + 1 < wl;
  const bool yin0 = y0 >= 0, yin1 = y0 + 1 < hl;
  const float ax0 = xin0 ? 1.f - tx : 0.f, ax1 = xin1 ? tx : 0.f;
  const float ay0 = yin0 ? (1.f - ty) * aw : 0.f, ay1 = yin1 ? ty * aw : 0.f;
  Sample s;
  s.w[0] = ay0 * ax0;
  s.w[1] = ay0 * ax1;
  s.w[2] = ay1 * ax0;
  s.w[3] = ay1 * ax1;
  const int cx = max(x0, 0), cy = max(y0, 0);
  s.pk = ((start + cy * wl + cx) << 2) | ((xin0 && xin1) ? 1 : 0) | ((yin0 && yin1) ? 2 : 0);
  return s;
}

__device__ __forceinline__ Sample shfl(const Sample& s, int src) {
  Sample r;
  r.pk = __shfl_sync(FULL, s.pk, src);
#pragma unroll
  for (int c = 0; c < 4; ++c) r.w[c] = __shfl_sync(FULL, s.w[c], src);
  return r;
}

// The corners' offsets in elements from the row's value base, in the order
// of Sample::w.
__device__ __forceinline__ void corner_offsets(int pk, int wl, size_t pix, size_t (&off)[4]) {
  const size_t p = (size_t)(pk >> 2);
  const size_t dx = (size_t)(pk & 1);
  const size_t dy = (pk & 2) ? (size_t)wl : 0;
  off[0] = p * pix;
  off[1] = (p + dx) * pix;
  off[2] = (p + dy) * pix;
  off[3] = (p + dy + dx) * pix;
}

// acc[0 .. 16 / sizeof(T)) += w * the 16 bytes at raw, as f32
__device__ __forceinline__ void fma16(float (&acc)[8], float w, uint4 raw) {
  const uint32_t u[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[2 * i] = fmaf(w, __uint_as_float(u[i] << 16), acc[2 * i]);
    acc[2 * i + 1] = fmaf(w, __uint_as_float(u[i] & 0xffff0000u), acc[2 * i + 1]);
  }
}

__device__ __forceinline__ void fma16(float (&acc)[4], float w, uint4 raw) {
  acc[0] = fmaf(w, __uint_as_float(raw.x), acc[0]);
  acc[1] = fmaf(w, __uint_as_float(raw.y), acc[1]);
  acc[2] = fmaf(w, __uint_as_float(raw.z), acc[2]);
  acc[3] = fmaf(w, __uint_as_float(raw.w), acc[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&acc)[8]) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
    u[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
}

__device__ __forceinline__ void store16(float* p, const float (&acc)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(acc[0], acc[1], acc[2], acc[3]);
}

// The row a thread's group works on: rows are (b, q, m) in memory order; in
// `order` 1 the r-th row of the launch is the r-th of (b, m, q) order.
__device__ __forceinline__ long long row_of(long long r, int order, int Lq, int M) {
  if (order == 0) return r;
  const long long per_b = (long long)Lq * M;
  const long long b = r / per_b, rem = r % per_b;
  const int m = (int)(rem / Lq), q = (int)(rem % Lq);
  return (b * Lq + q) * M + m;
}

// a[l] for l < NL by selects: a runtime index into the kernel's parameters
// would copy them to local memory
template <int NL>
__device__ __forceinline__ int pick(const int (&a)[MAX_LEVELS], int l) {
  int r = a[0];
#pragma unroll
  for (int i = 1; i < NL; ++i) r = l == i ? a[i] : r;
  return r;
}

// The vector path for NL levels and NP points: G lanes a row, VEC channels a
// lane, G * VEC >= D.
template <typename T, int G, int NL, int NP>
__global__ void __launch_bounds__(THREADS, 4)
msda_fixed_kernel(const T* __restrict__ value,  // (B, S, M, D)
                  const float* __restrict__ loc,  // (B, Lq, M, L, P, 2)
                  const T* __restrict__ attw,     // (B, Lq, M, L, P)
                  T* __restrict__ out,            // (B, Lq, M, D)
                  Levels lv, int S, int Lq, int M, int D, int order, long long rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int LP = NL * NP;
  constexpr int NS = (LP + G - 1) / G;  // samples whose coordinates a lane computes
  const int lane = threadIdx.x & 31;
  const int j = lane & (G - 1);
  const int g0 = lane & ~(G - 1);  // the group's first lane
  const long long r = ((long long)blockIdx.x * THREADS + threadIdx.x) / G;
  const bool live = r < rows;  // dead rows still take part in the shuffles
  const long long row = row_of(live ? r : rows - 1, order, Lq, M);
  const int m = (int)(row % M);
  const long long b = row / M / Lq;
  const float* lp = loc + row * LP * 2;
  const T* ap = attw + row * LP;

  Sample own[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int k = s * G + j;
    if (k < LP) {
      const int l = k / NP;
      const float2 xy = __ldg(reinterpret_cast<const float2*>(lp) + k);
      own[s] = make_sample(xy.x, xy.y, to_f32(ap[k]), pick<NL>(lv.h, l), pick<NL>(lv.w, l),
                           pick<NL>(lv.start, l));
    } else {
      own[s].pk = 0;
      own[s].w[0] = own[s].w[1] = own[s].w[2] = own[s].w[3] = 0.f;
    }
  }

  const int c0 = j * VEC;
  const bool on = live && c0 < D;
  const size_t pix = (size_t)M * D;  // elements between two pixels
  const T* vb = value + (size_t)b * S * pix + (size_t)m * D + c0;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    Sample smp[NP];
    uint4 raw[NP][4];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int k = l * NP + p;
      smp[p] = G == 1 ? own[k] : shfl(own[k / G], g0 + k % G);
    }
    if (on) {
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        size_t off[4];
        corner_offsets(smp[p].pk, lv.w[l], pix, off);
#pragma unroll
        for (int c = 0; c < 4; ++c) raw[p][c] = __ldg(reinterpret_cast<const uint4*>(vb + off[c]));
      }
#pragma unroll
      for (int p = 0; p < NP; ++p) {
#pragma unroll
        for (int c = 0; c < 4; ++c) fma16(acc, smp[p].w[c], raw[p][c]);
      }
    }
  }
  if (on) store16(out + row * D + c0, acc);
}

// Any L <= MAX_LEVELS and P: G = 1 << glog lanes a row; a chunk of G samples
// at a time, sample k0 + j computed by lane j. VEC = 16 / sizeof(T) (16-byte
// loads) or 1 (the scalar path, passes over D when D > 32).
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
msda_generic_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                    const T* __restrict__ attw, T* __restrict__ out, Levels lv, int L, int P,
                    int S, int Lq, int M, int D, int glog, int order, long long rows) {
  const int G = 1 << glog;
  const int lane = threadIdx.x & 31;
  const int j = lane & (G - 1);
  const int g0 = lane & ~(G - 1);
  const long long r = ((long long)blockIdx.x * THREADS + threadIdx.x) >> glog;
  const bool live = r < rows;
  const long long row = row_of(live ? r : rows - 1, order, Lq, M);
  const int m = (int)(row % M);
  const long long b = row / M / Lq;
  const int LP = L * P;
  const float* lp = loc + row * LP * 2;
  const T* ap = attw + row * LP;
  const size_t pix = (size_t)M * D;

  for (int pass = 0; pass < D; pass += G * VEC) {
    const int c0 = pass + j * VEC;
    const bool on = live && c0 < D;
    const T* vb = value + (size_t)b * S * pix + (size_t)m * D + c0;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    for (int k0 = 0; k0 < LP; k0 += G) {
      Sample own;
      const int k = k0 + j;
      if (k < LP) {
        const int l = k / P;
        own = make_sample(lp[2 * k], lp[2 * k + 1], to_f32(ap[k]), lv.h[l], lv.w[l],
                          lv.start[l]);
      } else {
        own.pk = 0;
        own.w[0] = own.w[1] = own.w[2] = own.w[3] = 0.f;
      }
      const int cnt = min(G, LP - k0);
      for (int kk = 0; kk < cnt; ++kk) {
        const Sample smp = shfl(own, g0 + kk);
        if (on) {
          size_t off[4];
          corner_offsets(smp.pk, lv.w[(k0 + kk) / P], pix, off);
          if constexpr (VEC == 1) {
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[0] = fmaf(smp.w[c], to_f32(vb[off[c]]), acc[0]);
          } else {
            uint4 raw[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) raw[c] = __ldg(reinterpret_cast<const uint4*>(vb + off[c]));
#pragma unroll
            for (int c = 0; c < 4; ++c) fma16(acc, smp.w[c], raw[c]);
          }
        }
      }
    }
    if (on) {
      if constexpr (VEC == 1) {
        store1(out + row * D + c0, acc[0]);
      } else {
        store16(out + row * D + c0, acc);
      }
    }
  }
}

int ceil_log2(int x) {
  int g = 0;
  while ((1 << g) < x) ++g;
  return g;
}

template <typename T, int G>
void launch_fixed(unsigned blocks, cudaStream_t stream, const T* value, const float* loc,
                  const T* attw, T* out, const Levels& lv, int S, int Lq, int M, int D,
                  int order, long long rows) {
  msda_fixed_kernel<T, G, 3, 4><<<blocks, THREADS, 0, stream>>>(value, loc, attw, out, lv, S,
                                                                 Lq, M, D, order, rows);
}

template <typename T>
int launch(const void* value_, const void* loc_, const void* attw_, void* out_,
           const int* levels, int L, int B, int S, int Lq, int M, int D, int P, int vec,
           int order, void* stream_) {
  constexpr int VEC = 16 / sizeof(T);
  const T* value = (const T*)value_;
  const float* loc = (const float*)loc_;
  const T* attw = (const T*)attw_;
  T* out = (T*)out_;
  cudaStream_t stream = (cudaStream_t)stream_;
  // pixel indices travel times 4 in an int
  if (L <= 0 || L > MAX_LEVELS || B <= 0 || S <= 0 || S >= (1 << 29) || Lq <= 0 || M <= 0 ||
      D <= 0 || P <= 0 || (order != 0 && order != 1) || (vec != 0 && vec != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (vec && (D % VEC != 0 || D / VEC > 32 || (uintptr_t)value % 16 || (uintptr_t)out % 16 ||
              (uintptr_t)loc % 8)) {
    return (int)cudaErrorMisalignedAddress;
  }
  Levels lv;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = levels[3 * l];
    lv.w[l] = levels[3 * l + 1];
    lv.start[l] = levels[3 * l + 2];
    if (lv.h[l] <= 0 || lv.w[l] <= 0 || lv.start[l] < 0 ||
        (long long)lv.start[l] + (long long)lv.h[l] * lv.w[l] > S) {
      return (int)cudaErrorInvalidValue;
    }
  }
  const int glog = ceil_log2(vec ? D / VEC : (D < 32 ? D : 32));
  const long long rows = (long long)B * Lq * M;
  const long long rows_per_block = THREADS >> glog;
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const unsigned nb = (unsigned)blocks;
  if (vec && L == 3 && P == 4 && glog <= 3) {
    switch (glog) {
      case 0: launch_fixed<T, 1>(nb, stream, value, loc, attw, out, lv, S, Lq, M, D, order, rows); break;
      case 1: launch_fixed<T, 2>(nb, stream, value, loc, attw, out, lv, S, Lq, M, D, order, rows); break;
      case 2: launch_fixed<T, 4>(nb, stream, value, loc, attw, out, lv, S, Lq, M, D, order, rows); break;
      default: launch_fixed<T, 8>(nb, stream, value, loc, attw, out, lv, S, Lq, M, D, order, rows);
    }
  } else if (vec) {
    msda_generic_kernel<T, VEC><<<nb, THREADS, 0, stream>>>(value, loc, attw, out, lv, L, P, S,
                                                             Lq, M, D, glog, order, rows);
  } else {
    msda_generic_kernel<T, 1><<<nb, THREADS, 0, stream>>>(value, loc, attw, out, lv, L, P, S,
                                                           Lq, M, D, glog, order, rows);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// value (B, S, M, D), attw (B, Lq, M, L, P), out (B, Lq, M, D): bf16;
// loc (B, Lq, M, L, P, 2): f32; all contiguous. levels: host array of
// 3 * L ints, (h, w, start) per level. vec 1: the 16-byte path (D a multiple
// of 8 and at most 256, value and out 16-byte aligned, loc 8-byte aligned),
// 0: one channel a lane. order 0: a block's rows are all heads of a run of
// tokens, 1: a run of tokens of one head. Launches on `stream` and returns
// cudaGetLastError() (or an error for arguments it does not take).
extern "C" int axvs_msda_fwd(const void* value, const void* loc, const void* attw,
                             void* out, const int* levels, int L, int B, int S,
                             int Lq, int M, int D, int P, int vec, int order, void* stream) {
  return launch<__nv_bfloat16>(value, loc, attw, out, levels, L, B, S, Lq, M, D, P, vec,
                               order, stream);
}

// The same with f32 value, attw and out (vec 1: D a multiple of 4, at most
// 128).
extern "C" int axvs_msda_fwd_f32(const void* value, const void* loc,
                                 const void* attw, void* out, const int* levels,
                                 int L, int B, int S, int Lq, int M, int D,
                                 int P, int vec, int order, void* stream) {
  return launch<float>(value, loc, attw, out, levels, L, B, S, Lq, M, D, P, vec, order,
                       stream);
}
