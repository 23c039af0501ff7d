// Weighted 4-corner reduces over gathered rows (K6, K7) and the packed
// corner table (K8), bf16.
//
// Replaces three TPU kernels of axial_vs_tpu/ops/msda_pallas.py, the pieces
// of MSDA's table-then-gather-then-reduce formulation:
//   K6 weighted_corner_reduce_multi (Pallas body `_multi_kernel`):
//        out[r, d] = fold_k sum_s bf16(g_s[r, k*D + d] * w[r, s*4 + k])
//      N gathered arrays g_s (R, 4D), sample-major weights w (R, 4N); each
//      product is rounded to bf16 before it is summed in f32.
//   K7 weighted_corner_reduce_v5 (Pallas body `_v5_kernel`):
//        out[r, d] = fold_k sum_{l, p} g_l[r, p*4D + k*D + d] * w[r, col]
//      L arrays g_l (R, P*4D) holding P samples side by side, sample
//      si = l*P + p at column si*4 + k (or k*N + si when slot-major); f32
//      products of the bf16 weights. With P = 1 it is the v4 reduce.
//   K8 pack_corner_table (Pallas body `_pack_kernel`):
//        out[b, s, m*4D + k*D + d] = v[b, (s + off_k) mod S, m*D + d]
//      off = (0, 1, W, W+1) for one level of S = H*W pixels: the 2x2
//      neighbourhood of every pixel, wrapped within the batch row as the
//      roll-based build (pack_corner_table_ref) wraps; the TPU kernel left
//      junk in those rows instead.
// "fold_k" is ((a_0 + a_1) + a_2) + a_3 in f32, a_k summed over the samples
// in order; the result is rounded to bf16 once. Sums and products use the
// _rn intrinsics so that no multiply-add is contracted: the plain versions
// in ops/msda_reduce.py round at the same points.
//
// What bounds them on an H100: bytes. At the within-clip bench shape
// (R = 338,688 rows, N = 12 samples, D = 32) K6 and K7 read 1.04 GB of
// gathered rows and 33 MB of weights to write 22 MB, 96 f32 operations per
// output element: about 0.33 ms at 3.35 TB/s against 0.016 ms of
// arithmetic. K8 reads 22 MB and writes 87 MB per layer (all levels).
//
// Design: one thread per 8-channel (16-byte) vector of one output row, so
// a warp's load of one corner slot covers whole 64-byte row segments (D =
// 32: 8 rows a warp) and every byte of a gathered row is read once, in four
// 16-byte loads per sample. The 4 x 8 f32 accumulators stay in registers.
// The input pointers travel by value in a struct of at most 16, and the
// loops over them are unrolled, so no pointer array lives in memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_INPUTS = 16;
constexpr int THREADS = 256;
constexpr int VEC = 8;  // bf16 channels in 16 bytes

struct Inputs {
  const __nv_bfloat16* p[MAX_INPUTS];
};

__device__ __forceinline__ void load8(const __nv_bfloat16* src,
                                      float (&x)[VEC]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// one sample's four corner slots at `g` (lanes k*D of the sample, this
// thread's vector) into the per-slot accumulators
template <bool ROUND_PRODUCT>
__device__ __forceinline__ void add_sample(const __nv_bfloat16* g, int D,
                                           const float (&wk)[4],
                                           float (&acc)[4][VEC]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float x[VEC];
    load8(g + (size_t)k * D, x);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float prod = __fmul_rn(x[j], wk[k]);
      if (ROUND_PRODUCT) prod = __bfloat162float(__float2bfloat16_rn(prod));
      acc[k][j] = __fadd_rn(acc[k][j], prod);
    }
  }
}

__device__ __forceinline__ void fold_store(const float (&acc)[4][VEC],
                                           __nv_bfloat16* dst) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    float y[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 2 * i + e;
      y[e] = __fadd_rn(__fadd_rn(__fadd_rn(acc[0][j], acc[1][j]), acc[2][j]),
                       acc[3][j]);
    }
    h[i] = __floats2bfloat162_rn(y[0], y[1]);
  }
  *reinterpret_cast<uint4*>(dst) = raw;
}

__global__ void __launch_bounds__(THREADS)
corner_reduce_multi_kernel(Inputs gs, int n,
                           const __nv_bfloat16* __restrict__ w,  // (R, 4N)
                           __nv_bfloat16* __restrict__ out,      // (R, D)
                           long long R, int D) {
  const int vecs = D / VEC;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= R * vecs) return;
  const long long r = t / vecs;
  const int v = (int)(t - r * vecs);
  const __nv_bfloat16* wr = w + r * 4 * n;
  const size_t row = (size_t)r * 4 * D + (size_t)v * VEC;
  float acc[4][VEC] = {};
#pragma unroll
  for (int s = 0; s < MAX_INPUTS; ++s) {
    if (s >= n) break;
    float wk[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) wk[k] = __bfloat162float(wr[s * 4 + k]);
    add_sample<true>(gs.p[s] + row, D, wk, acc);
  }
  fold_store(acc, out + r * D + v * VEC);
}

__global__ void __launch_bounds__(THREADS)
corner_reduce_v5_kernel(Inputs gs, int L, int P,
                        const __nv_bfloat16* __restrict__ w,  // (R, 4LP)
                        __nv_bfloat16* __restrict__ out,      // (R, D)
                        long long R, int D, int slot_major) {
  const int vecs = D / VEC;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= R * vecs) return;
  const long long r = t / vecs;
  const int v = (int)(t - r * vecs);
  const int n = L * P;
  const __nv_bfloat16* wr = w + r * 4 * n;
  const size_t row = (size_t)r * P * 4 * D + (size_t)v * VEC;
  float acc[4][VEC] = {};
#pragma unroll
  for (int l = 0; l < MAX_INPUTS; ++l) {
    if (l >= L) break;
    for (int p = 0; p < P; ++p) {
      const int si = l * P + p;
      float wk[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wk[k] = __bfloat162float(wr[slot_major ? k * n + si : si * 4 + k]);
      }
      add_sample<false>(gs.p[l] + row + (size_t)p * 4 * D, D, wk, acc);
    }
  }
  fold_store(acc, out + r * D + v * VEC);
}

__global__ void __launch_bounds__(THREADS)
pack_corner_table_kernel(const __nv_bfloat16* __restrict__ v,  // (B, S, M*D)
                         __nv_bfloat16* __restrict__ out,  // (B, S, M*4D)
                         long long B, int S, long long batch_stride, int M,
                         int D, int width) {
  // one thread per 16-byte vector of the output, lanes in (m, k, d) order
  const int vecs = D / VEC;
  const long long per_row = (long long)M * 4 * vecs;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= B * S * per_row) return;
  const long long row = t / per_row;
  int rem = (int)(t - row * per_row);
  const int m = rem / (4 * vecs);
  rem -= m * 4 * vecs;
  const int k = rem / vecs;
  const int dv = rem - k * vecs;
  const long long b = row / S;
  const int s = (int)(row - b * S);
  const long long off = k == 0 ? 0 : k == 1 ? 1 : k == 2 ? width : width + 1LL;
  const long long src = ((long long)s + off) % S;
  const __nv_bfloat16* from =
      v + b * batch_stride + src * M * D + (long long)m * D + dv * VEC;
  __nv_bfloat16* to = out + row * 4 * M * D + (long long)(m * 4 + k) * D +
                      dv * VEC;
  *reinterpret_cast<uint4*>(to) = __ldg(reinterpret_cast<const uint4*>(from));
}

int grid_for(long long threads, unsigned* blocks) {
  const long long n = (threads + THREADS - 1) / THREADS;
  if (threads <= 0 || n > 2147483647LL) return (int)cudaErrorInvalidValue;
  *blocks = (unsigned)n;
  return 0;
}

int gather_inputs(const void* const* ptrs, int count, Inputs* in) {
  if (count <= 0 || count > MAX_INPUTS) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < MAX_INPUTS; ++i) {
    in->p[i] = i < count ? (const __nv_bfloat16*)ptrs[i] : nullptr;
    if (i < count && (in->p[i] == nullptr || ((uintptr_t)in->p[i] & 15))) {
      return (int)cudaErrorInvalidValue;
    }
  }
  return 0;
}

}  // namespace

// gs: host array of n pointers to (R, 4D) bf16 rows; w (R, 4n) bf16; out
// (R, D) bf16; all contiguous, 16-byte aligned, D a multiple of 8.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int axvs_corner_reduce_multi(const void* const* gs, int n,
                                        const void* w, void* out, int R,
                                        int D, void* stream) {
  Inputs in;
  unsigned blocks = 0;
  if (D <= 0 || D % VEC || ((uintptr_t)out & 15) ||
      gather_inputs(gs, n, &in) ||
      grid_for((long long)R * (D / VEC), &blocks)) {
    return (int)cudaErrorInvalidValue;
  }
  corner_reduce_multi_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      in, n, (const __nv_bfloat16*)w, (__nv_bfloat16*)out, R, D);
  return (int)cudaGetLastError();
}

// gs: host array of L pointers to (R, P*4D) bf16 rows; w (R, 4LP) bf16,
// slot-major (column k*LP + si) when slot_major != 0, else sample-major
// (si*4 + k); out (R, D) bf16; contiguous, 16-byte aligned, D % 8 == 0.
extern "C" int axvs_corner_reduce_v5(const void* const* gs, int L, int P,
                                     const void* w, void* out, int R, int D,
                                     int slot_major, void* stream) {
  Inputs in;
  unsigned blocks = 0;
  if (P <= 0 || D <= 0 || D % VEC || ((uintptr_t)out & 15) ||
      gather_inputs(gs, L, &in) ||
      grid_for((long long)R * (D / VEC), &blocks)) {
    return (int)cudaErrorInvalidValue;
  }
  corner_reduce_v5_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      in, L, P, (const __nv_bfloat16*)w, (__nv_bfloat16*)out, R, D,
      slot_major);
  return (int)cudaGetLastError();
}

// v: (B, S, M*D) bf16 with rows contiguous and batch rows `batch_stride`
// elements apart (a level's slice of the whole value); out (B, S, M*4D)
// bf16, contiguous; 16-byte aligned, D and batch_stride multiples of 8.
extern "C" int axvs_pack_corner_table(const void* v, void* out, int B, int S,
                                      long long batch_stride, int M, int D,
                                      int width, void* stream) {
  unsigned blocks = 0;
  if (B <= 0 || S <= 0 || M <= 0 || D <= 0 || D % VEC || width <= 0 ||
      batch_stride % VEC || ((uintptr_t)v & 15) || ((uintptr_t)out & 15) ||
      grid_for((long long)B * S * M * 4 * (D / VEC), &blocks)) {
    return (int)cudaErrorInvalidValue;
  }
  pack_corner_table_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, B, S, batch_stride, M, D,
      width);
  return (int)cudaGetLastError();
}
