// Multi-scale deformable attention, forward, bf16 value and weights.
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
// 1 GB per call (sizes computed from the shapes), while value itself fits in
// the 50 MB L2. So the kernel is bound by L2 gather bandwidth, not by device
// memory or arithmetic.
//
// Design: one warp per (b, q, m) row, lanes over the head dim D, so each
// corner is one coalesced 64-byte read of 32 bf16 lanes. Locations and
// weights of the row are read by all lanes from the same cache line. The
// bilinear corner weights are computed in f32 per sample; corners outside
// the level are masked (no clamp and no packed corner table: the TPU's table
// and slot remap exist only for its row-count-bound gather). The sum over
// levels, points and corners accumulates in f32 and is rounded to bf16 once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int WARPS_PER_BLOCK = 8;

struct Levels {
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int start[MAX_LEVELS];
};

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
msda_fwd_kernel(const __nv_bfloat16* __restrict__ value,  // (B, S, M, D)
                const float* __restrict__ loc,            // (B, Lq, M, L, P, 2)
                const __nv_bfloat16* __restrict__ attw,   // (B, Lq, M, L, P)
                __nv_bfloat16* __restrict__ out,          // (B, Lq, M, D)
                Levels lv, int num_levels, int S, int Lq, int M, int D, int P,
                long long rows) {
  const long long row =
      (long long)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int m = (int)(row % M);
  const long long b = row / M / Lq;
  const int LP = num_levels * P;
  const float* lp = loc + row * LP * 2;
  const __nv_bfloat16* ap = attw + row * LP;
  const size_t pix = (size_t)M * D;  // stride of one spatial position
  const __nv_bfloat16* vb = value + (size_t)b * S * pix + (size_t)m * D;

  for (int d = lane; d - lane < D; d += 32) {
    const bool on = d < D;
    float acc = 0.f;
    for (int l = 0; l < num_levels; ++l) {
      const int hl = lv.h[l];
      const int wl = lv.w[l];
      const __nv_bfloat16* vl = vb + (size_t)lv.start[l] * pix;
      for (int p = 0; p < P; ++p) {
        const int k = l * P + p;
        const float ix = lp[2 * k] * (float)wl - 0.5f;
        const float iy = lp[2 * k + 1] * (float)hl - 0.5f;
        // a sample with no corner inside the level contributes 0 (this
        // also keeps the int conversions below in range, and drops NaNs)
        if (!(ix > -1.f && ix < (float)wl && iy > -1.f && iy < (float)hl)) {
          continue;
        }
        const float fx = floorf(ix);
        const float fy = floorf(iy);
        const int x0 = (int)fx;
        const int y0 = (int)fy;
        const float tx = ix - fx;
        const float ty = iy - fy;
        const float aw = __bfloat162float(ap[k]);
        float v = 0.f;
        if (on) {
          const bool xin0 = x0 >= 0, xin1 = x0 + 1 < wl;
          const bool yin0 = y0 >= 0, yin1 = y0 + 1 < hl;
          // signed offsets: x0 or y0 may be -1 (that corner is masked)
          const long long spix = (long long)pix;
          const __nv_bfloat16* r0 =
              vl + ((long long)y0 * wl + x0) * spix + d;
          const __nv_bfloat16* r1 = r0 + (long long)wl * spix;
          if (yin0 && xin0) v += (1.f - ty) * (1.f - tx) * __bfloat162float(r0[0]);
          if (yin0 && xin1) v += (1.f - ty) * tx * __bfloat162float(r0[pix]);
          if (yin1 && xin0) v += ty * (1.f - tx) * __bfloat162float(r1[0]);
          if (yin1 && xin1) v += ty * tx * __bfloat162float(r1[pix]);
        }
        acc = fmaf(aw, v, acc);
      }
    }
    if (on) out[row * D + d] = __float2bfloat16_rn(acc);
  }
}

}  // namespace

// value (B, S, M, D), attw (B, Lq, M, L, P), out (B, Lq, M, D): bf16;
// loc (B, Lq, M, L, P, 2): f32; all contiguous. levels: host array of
// 3 * L ints, (h, w, start) per level. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int axvs_msda_fwd(const void* value, const void* loc, const void* attw,
                             void* out, const int* levels, int L, int B, int S,
                             int Lq, int M, int D, int P, void* stream) {
  if (L <= 0 || L > MAX_LEVELS || B <= 0 || S <= 0 || Lq <= 0 || M <= 0 ||
      D <= 0 || P <= 0) {
    return (int)cudaErrorInvalidValue;
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
  const long long rows = (long long)B * Lq * M;
  const long long blocks = (rows + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  msda_fwd_kernel<<<(unsigned)blocks, WARPS_PER_BLOCK * 32, 0,
                    (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)value, (const float*)loc,
      (const __nv_bfloat16*)attw, (__nv_bfloat16*)out, lv, L, S, Lq, M, D, P,
      rows);
  return (int)cudaGetLastError();
}
