// Weighted gather of P rows from one (S, 128) bf16 slab per query (P2).
//
// Replaces the TPU kernel of tools/exp_vmem_gather.py::run (Pallas body
// `_k_gather`, variants pl_u1 / pl_u4 / pl_u8):
//   out[q, :] = bf16(sum_p slab[idx[q, p], :] * w[q, p])
// with f32 products and an f32 sum, first point first, one rounding. It is
// the shape of MSDA's sampling: one (frame, head, level) slab of the corner
// table, 4 points a query.
//
// The TPU kernel held the whole slab in VMEM and read rows from it by a
// runtime index. The card's counterpart of VMEM for a slab of 0.92 MB
// (tube_l0) or 4.13 MB (kmax_l0) is the 50 MB L2, not a block's 227 KB of
// shared memory: so this kernel gathers through L2, and after the first
// touch every row read is an L2 hit. (A shared-memory slab cut into column
// slices, one slice a block, would be another probe.)
//
// What bounds it on an H100: bytes, at about 10 MB a call for kmax_l0 (the
// slab once, the indices, the weights and the output), 0.003 ms at 3.35
// TB/s; in practice the latency of dependent L2 reads (index, then row).
//
// Design: 16 threads own one query row, each one 16-byte vector (8 of the
// 128 lanes), so a half-warp reads one 256-byte slab row in one go. A group
// handles N consecutive query rows (the TPU's unroll): for each point p it
// issues the N rows' index loads and then their N row loads before it sums
// any of them, so N independent L2 reads are in flight a thread. A ragged
// NQ is masked here (the TPU version padded to its block and sliced).
// Products and sums use the _rn intrinsics: nothing is contracted into an
// FMA, so the kernel rounds where the plain version does. An index outside
// [0, S) reads a zero row (the TPU kernel's indices were promised in range).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int LANES = 128;
constexpr int VEC = 8;                       // bf16 per 16 bytes
constexpr int ROW_THREADS = LANES / VEC;     // 16 threads a query row
constexpr int GROUPS = THREADS / ROW_THREADS;  // 16 query rows in flight

template <int N>
__global__ void __launch_bounds__(THREADS)
slab_gather_kernel(const uint4* __restrict__ slab,  // (S, 128) bf16
                   const int* __restrict__ idx,     // (NQ, P)
                   const float* __restrict__ w,     // (NQ, P)
                   uint4* __restrict__ out,         // (NQ, 128) bf16
                   int S, int NQ, int P) {
  const int g = threadIdx.x / ROW_THREADS;
  const int v = threadIdx.x % ROW_THREADS;
  const long long q0 = ((long long)blockIdx.x * GROUPS + g) * N;
  float acc[N][VEC];
  for (int p = 0; p < P; ++p) {
    int row[N];
    float wt[N];
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const long long q = q0 + u;
      const bool valid = q < NQ;
      row[u] = valid ? __ldg(idx + q * P + p) : -1;
      wt[u] = valid ? __ldg(w + q * P + p) : 0.f;
    }
    uint4 raw[N];
#pragma unroll
    for (int u = 0; u < N; ++u) {
      raw[u] = make_uint4(0, 0, 0, 0);
      if (row[u] >= 0 && row[u] < S) {
        raw[u] = __ldg(slab + (size_t)row[u] * ROW_THREADS + v);
      }
    }
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw[u]);
#pragma unroll
      for (int i = 0; i < VEC / 2; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        const float a = __fmul_rn(f.x, wt[u]), b = __fmul_rn(f.y, wt[u]);
        acc[u][2 * i] = p == 0 ? a : __fadd_rn(acc[u][2 * i], a);
        acc[u][2 * i + 1] = p == 0 ? b : __fadd_rn(acc[u][2 * i + 1], b);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const long long q = q0 + u;
    if (q >= NQ) break;
    uint4 o;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      h[i] = __floats2bfloat162_rn(acc[u][2 * i], acc[u][2 * i + 1]);
    }
    out[q * ROW_THREADS + v] = o;
  }
}

template <int N>
void launch(const void* slab, const void* idx, const void* w, void* out,
            int S, int NQ, int P, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((NQ + GROUPS * N - 1) / (GROUPS * N));
  slab_gather_kernel<N><<<blocks, THREADS, 0, stream>>>(
      (const uint4*)slab, (const int*)idx, (const float*)w, (uint4*)out, S,
      NQ, P);
}

}  // namespace

// slab (S, 128) bf16, idx (NQ, P) int32, w (NQ, P) f32, out (NQ, 128) bf16;
// contiguous, slab and out 16-byte aligned; unroll N in {1, 4, 8} query rows
// a thread group. Launches on `stream` and returns cudaGetLastError().
extern "C" int axvs_slab_gather(const void* slab, const void* idx,
                                const void* w, void* out, int S, int NQ,
                                int P, int unroll, void* stream) {
  if (S <= 0 || NQ <= 0 || P <= 0 || ((uintptr_t)slab & 15) ||
      ((uintptr_t)out & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (unroll) {
    case 1: launch<1>(slab, idx, w, out, S, NQ, P, s); break;
    case 4: launch<4>(slab, idx, w, out, S, NQ, P, s); break;
    case 8: launch<8>(slab, idx, w, out, S, NQ, P, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
