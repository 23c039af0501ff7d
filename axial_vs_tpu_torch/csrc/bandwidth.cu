// Streaming-bandwidth and column-gather probes (P4), bf16 / f32.
//
// Replaces the three TPU kernels of tools/bench_pallas_bw.py:
//   pallas_copy  (`_copy_kernel`):   out = 2 * x, bf16 (rows, 128)
//     -> scale_copy_kernel
//   pallas_sum12 (`_sum12_kernel`):  out = bf16(((x_0 + x_1) + ...) + x_11),
//     the inputs upcast to f32 and summed in order, one rounding
//     -> sum_n_kernel (up to 16 inputs)
//   vmem_gather  (`_gather_kernel`): out[i, j] = t[idx[i, j], j], the
//     take_along_axis of an (S, C) table on axis 0
//     -> column_gather_kernel, int32 indices, f32 or bf16 table. The TPU's
//     rule that a bf16 table needs int16 indices was Mosaic's own.
//
// What bounds them on an H100: bytes. At the default 338,688 rows (the WC
// MSDA's rows at 769x1345) one array is 86.7 MB: the copy moves 2 of them
// (0.0518 ms at 3.35 TB/s) and the 12-input sum 13 (0.3364 ms), one f32 add
// per input element against 2 bytes read. The gather's tables (S <= 16384
// rows of 128) sit in L2; its bytes are the indices and the output.
//
// Design: one thread per 16-byte vector (8 bf16) for the copy and the sum,
// neighbouring threads on neighbouring vectors, so each warp reads whole
// 512-byte segments; the sum's input pointers travel by value in a struct
// (as csrc/msda_reduce.cu passes its rows) and its loop is unrolled, so up to
// 16 independent 16-byte loads are in flight a thread. The gather runs one
// thread per output element: the loads of idx and out are coalesced, the
// table reads hit L2. Indices outside [0, S) give 0 (the TPU kernel promised
// them in bounds; the kernel keeps memory safe instead).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;  // bf16 per 16 bytes
constexpr int MAX_INPUTS = 16;

struct Inputs {
  const uint4* p[MAX_INPUTS];
};

__device__ __forceinline__ void unpack(const uint4& raw, float (&x)[VEC]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&x)[VEC]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  return raw;
}

__global__ void __launch_bounds__(THREADS)
scale_copy_kernel(const uint4* __restrict__ x, uint4* __restrict__ out, long long vecs) {
  const long long v = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (v >= vecs) return;
  float a[VEC];
  unpack(__ldg(x + v), a);
#pragma unroll
  for (int j = 0; j < VEC; ++j) a[j] *= 2.f;  // exact, as the bf16 multiply by 2
  out[v] = pack(a);
}

__global__ void __launch_bounds__(THREADS)
sum_n_kernel(Inputs xs, int n, uint4* __restrict__ out, long long vecs) {
  const long long v = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (v >= vecs) return;
  uint4 raw[MAX_INPUTS];
#pragma unroll
  for (int s = 0; s < MAX_INPUTS; ++s) {
    if (s < n) raw[s] = __ldg(xs.p[s] + v);  // all loads issued first
  }
  float acc[VEC];
  unpack(raw[0], acc);
#pragma unroll
  for (int s = 1; s < MAX_INPUTS; ++s) {
    if (s >= n) break;
    float x[VEC];
    unpack(raw[s], x);
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = __fadd_rn(acc[j], x[j]);
  }
  out[v] = pack(acc);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
column_gather_kernel(const T* __restrict__ t, const int* __restrict__ idx,
                     T* __restrict__ out, int S, long long elems, int C) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= elems) return;
  const int row = __ldg(idx + e);
  const int col = (int)(e % C);
  out[e] = (row >= 0 && row < S) ? t[(size_t)row * C + col] : T(0.f);
}

int grid_for(long long threads, unsigned* blocks) {
  const long long n = (threads + THREADS - 1) / THREADS;
  if (threads <= 0 || n > 2147483647LL) return (int)cudaErrorInvalidValue;
  *blocks = (unsigned)n;
  return 0;
}

bool misaligned(const void* p) { return ((uintptr_t)p & 15) != 0; }

}  // namespace

// x, out: `elems` bf16, contiguous, 16-byte aligned, elems % 8 == 0.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int axvs_scale_copy(const void* x, void* out, long long elems,
                               void* stream) {
  unsigned blocks = 0;
  if (elems % VEC || misaligned(x) || misaligned(out) ||
      grid_for(elems / VEC, &blocks)) {
    return (int)cudaErrorInvalidValue;
  }
  scale_copy_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)x, (uint4*)out, elems / VEC);
  return (int)cudaGetLastError();
}

// xs: host array of n (1..16) pointers to `elems` bf16 each; out `elems`
// bf16; contiguous, 16-byte aligned, elems % 8 == 0.
extern "C" int axvs_sum_n(const void* const* xs, int n, void* out,
                          long long elems, void* stream) {
  unsigned blocks = 0;
  if (n <= 0 || n > MAX_INPUTS || elems % VEC || misaligned(out) ||
      grid_for(elems / VEC, &blocks)) {
    return (int)cudaErrorInvalidValue;
  }
  Inputs in;
  for (int i = 0; i < MAX_INPUTS; ++i) {
    in.p[i] = i < n ? (const uint4*)xs[i] : nullptr;
    if (i < n && (xs[i] == nullptr || misaligned(xs[i]))) {
      return (int)cudaErrorInvalidValue;
    }
  }
  sum_n_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      in, n, (uint4*)out, elems / VEC);
  return (int)cudaGetLastError();
}

// t: (S, C) f32 (is_bf16 == 0) or bf16; idx: (N, C) int32; out: (N, C) in
// t's type; all contiguous.
extern "C" int axvs_column_gather(const void* t, const void* idx, void* out,
                                  int S, int N, int C, int is_bf16,
                                  void* stream) {
  unsigned blocks = 0;
  const long long elems = (long long)N * C;
  if (S <= 0 || C <= 0 || grid_for(elems, &blocks)) {
    return (int)cudaErrorInvalidValue;
  }
  if (is_bf16) {
    column_gather_kernel<__nv_bfloat16><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)t, (const int*)idx, (__nv_bfloat16*)out, S, elems, C);
  } else {
    column_gather_kernel<float><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)t, (const int*)idx, (float*)out, S, elems, C);
  }
  return (int)cudaGetLastError();
}
