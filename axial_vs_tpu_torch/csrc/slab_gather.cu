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
// shared memory (P4's gather measured on-chip tables losing to L2 on this
// card), so this kernel gathers through L2: after the first touch every
// row read is an L2 hit.
//
// What bounds it on an H100. The byte bound counts the slab once, with the
// indices, the weights and the output: 10.23 MB a call at kmax_l0, 0.0031 ms
// at 3.35 TB/s. But the kernel reads every sampled row, NQ * P rows of 256
// bytes: 21.7 MB at kmax_l0 and 4.87 MB at tube_l0, all through L2. Those
// bytes over L2's rate are its L2 floor, the nearer limit (chip_smoke.py
// takes the rate from P4's copy of a slab-sized array in a CUDA graph and
// prints the floor beside the bound).
//
// Design. 16 threads own one query row, each one 16-byte vector (8 of the
// 128 lanes), so a half-warp reads one 256-byte slab row in one go; a
// group carries N consecutive query rows (the TPU's unroll). Four points:
// 1. The block's indices and weights in one hop. A block takes a run of at
//    most QB = (threads / 16) * N consecutive queries. It first copies their
//    idx and w rows (contiguous in memory) into shared memory with 4-byte
//    cp.asyncs, neighbouring threads on neighbouring words, then passes one
//    barrier. Every thread reads its P indices and weights from there, one
//    broadcast a group: one global round trip a block, not one before each
//    point's row, and no thread loads an index another already has. 4-byte
//    copies take any P: P = 3 gives 12-byte rows, which rule out 16-byte
//    vectors.
// 2. All P * N row loads in flight. P is a template parameter (1 to 8), so
//    the loops unroll. A thread issues all P * N of its 16-byte row loads,
//    as cp.async.cg copies (L2 only, no L1 line) into its own slots of
//    shared memory, before it sums any: in flight they take no registers.
//    Each query's P rows are one commit group, so the thread sums query u,
//    point by point in order, as soon as group u has landed, while the
//    later queries' rows are still on their way. (Rows loaded into
//    registers spill at N = 8; one wait for all rows leaves a block's sums
//    and stores behind all its loads; L1-allocating copies, .ca, hold L1
//    lines for rows no other thread reads. All three measured slower at
//    N = 4 and 8.)
// 3. A grid that fills the card for every N, with equal shares
//    (exp_vmem_gather.py::launch_shape). The block: the most threads, 256
//    down to 32, whose grid still has 4 blocks an SM, and whose row slots
//    stay within 32 KB (threads * P * N * 16 bytes; no opt-in above 48 KB).
//    The grid: that block count rounded up to a multiple of the SM count,
//    and the NQ queries spread evenly over it, so that blocks differ by at
//    most one query. All-resident grids then give every SM the same number
//    of blocks, and longer ones hand out blocks as SMs free up: no SM takes
//    half again another's work once a block holds 3 queries or more (both
//    test shapes, every N). Chosen over a persistent
//    grid-stride loop: each of its iterations would wait for its rows
//    before the next index hop and pass a barrier before it reuses the
//    shared indices; one block, one run of queries, one hop keeps all of a
//    block's loads in flight at once. Blocks of one 16-thread group (half a
//    warp) measured slower than 32 threads.
// 4. Streaming stores (st.global.cs) for the output, so that its 5.4 MB
//    (kmax_l0) does not evict slab lines from L2.
// Products and sums use the _rn intrinsics: nothing is contracted into an
// FMA, so the kernel rounds where the plain version does and equals it
// bitwise. An index outside [0, S) reads a zero row (the copy's source
// size 0 fills zeros; the TPU kernel's indices were promised in range). A
// ragged NQ is spread over the blocks (the TPU version padded to its block
// and sliced).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MIN_THREADS = 32;
constexpr int MAX_THREADS = 256;
constexpr int LANES = 128;
constexpr int VEC = 8;                    // bf16 per 16 bytes
constexpr int ROW_THREADS = LANES / VEC;  // 16 threads a query row
constexpr int MAX_P = 8;
constexpr int MAX_ROW_SLOTS = 32 * 1024;  // bytes of row slots a block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// 16 bytes from src, or zeros where !in (source size 0: nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(K) : "memory");
}

// Waits until at most `pending` of the thread's commit groups are in
// flight; `pending` is a constant once the caller's loop is unrolled.
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

__device__ __forceinline__ void store_streaming(uint4* dst, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(dst), "r"(v.x),
               "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

template <int N, int P>
__global__ void __launch_bounds__(MAX_THREADS)
slab_gather_kernel(const uint4* __restrict__ slab,  // (S, 128) bf16
                   const int* __restrict__ idx,     // (NQ, P)
                   const float* __restrict__ w,     // (NQ, P)
                   uint4* __restrict__ out,         // (NQ, 128) bf16
                   int S, int NQ) {
  // row slots [N][P][threads] of 16 bytes, then QB * P indices and weights
  extern __shared__ __align__(16) unsigned char shared[];
  const int threads = blockDim.x;
  const int qb = threads / ROW_THREADS * N;
  uint4* s_rows = reinterpret_cast<uint4*>(shared);
  int* s_idx = reinterpret_cast<int*>(s_rows + N * P * threads);
  float* s_w = reinterpret_cast<float*>(s_idx + qb * P);
  // this block's run of queries: NQ spread evenly over the grid (<= QB)
  const long long q0 = (long long)blockIdx.x * NQ / gridDim.x;
  const int nq = (int)((long long)(blockIdx.x + 1) * NQ / gridDim.x - q0);

  // 1. the block's idx and w rows, one coalesced pass, one barrier
  const int* gi = idx + q0 * P;
  const float* gw = w + q0 * P;
  for (int i = threadIdx.x; i < nq * P; i += threads) {
    cp_async4(s_idx + i, gi + i);
    cp_async4(s_w + i, gw + i);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // 2. every row copy of the thread issued before any sum, a commit group
  // a query
  const int g = threadIdx.x / ROW_THREADS;
  const int v = threadIdx.x % ROW_THREADS;
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int ql = g * N + u;
    if (ql < nq) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int row = s_idx[ql * P + p];
        const bool in = row >= 0 && row < S;
        cp_async16(s_rows + (u * P + p) * threads + threadIdx.x,
                   slab + (size_t)(in ? row : 0) * ROW_THREADS + v, in);
      }
    }
    cp_async_commit();
  }

#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int ql = g * N + u;
    cp_async_wait_pending(N - 1 - u);  // query u's rows have landed
    if (ql < nq) {
      float acc[VEC];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float wt = s_w[ql * P + p];
        const uint4 r = s_rows[(u * P + p) * threads + threadIdx.x];
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
        for (int i = 0; i < VEC / 2; ++i) {
          const float2 f = __bfloat1622float2(h[i]);
          const float a = __fmul_rn(f.x, wt), b = __fmul_rn(f.y, wt);
          acc[2 * i] = p == 0 ? a : __fadd_rn(acc[2 * i], a);
          acc[2 * i + 1] = p == 0 ? b : __fadd_rn(acc[2 * i + 1], b);
        }
      }
      uint4 o;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
      for (int i = 0; i < VEC / 2; ++i) {
        h[i] = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
      }
      // 4. streamed past L2, which keeps the slab
      store_streaming(out + (size_t)(q0 + ql) * ROW_THREADS + v, o);
    }
  }
}

template <int N, int P>
cudaError_t launch(const void* slab, const void* idx, const void* w, void* out, int S,
                   int NQ, int threads, int blocks, cudaStream_t stream) {
  const int qb = threads / ROW_THREADS * N;
  const size_t slots = (size_t)threads * N * P * sizeof(uint4);
  if (slots > MAX_ROW_SLOTS || (long long)blocks * qb < NQ) return cudaErrorInvalidValue;
  const size_t smem = slots + (size_t)qb * P * (sizeof(int) + sizeof(float));
  slab_gather_kernel<N, P><<<blocks, threads, smem, stream>>>(
      (const uint4*)slab, (const int*)idx, (const float*)w, (uint4*)out, S, NQ);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_p(const void* slab, const void* idx, const void* w, void* out, int S,
                     int NQ, int P, int threads, int blocks, cudaStream_t s) {
  switch (P) {
    case 1: return launch<N, 1>(slab, idx, w, out, S, NQ, threads, blocks, s);
    case 2: return launch<N, 2>(slab, idx, w, out, S, NQ, threads, blocks, s);
    case 3: return launch<N, 3>(slab, idx, w, out, S, NQ, threads, blocks, s);
    case 4: return launch<N, 4>(slab, idx, w, out, S, NQ, threads, blocks, s);
    case 5: return launch<N, 5>(slab, idx, w, out, S, NQ, threads, blocks, s);
    case 6: return launch<N, 6>(slab, idx, w, out, S, NQ, threads, blocks, s);
    case 7: return launch<N, 7>(slab, idx, w, out, S, NQ, threads, blocks, s);
    case 8: return launch<N, 8>(slab, idx, w, out, S, NQ, threads, blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// slab (S, 128) bf16, idx (NQ, P) int32, w (NQ, P) f32, out (NQ, 128) bf16;
// contiguous, slab and out 16-byte aligned; P in 1-8; unroll N in {1, 4, 8}
// query rows a thread group; threads a block a power of two in 32-256 with
// threads * N * P * 16 bytes of row slots at most 32 KB, and blocks enough
// for NQ (exp_vmem_gather.py::launch_shape). Launches on `stream` and
// returns cudaGetLastError(), or cudaErrorInvalidValue for what it does
// not take.
extern "C" int axvs_slab_gather(const void* slab, const void* idx, const void* w,
                                void* out, int S, int NQ, int P, int unroll, int threads,
                                int blocks, void* stream) {
  if (S <= 0 || NQ <= 0 || P < 1 || P > MAX_P || threads < MIN_THREADS ||
      threads > MAX_THREADS || (threads & (threads - 1)) || blocks <= 0 ||
      ((uintptr_t)slab & 15) || ((uintptr_t)out & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (unroll) {
    case 1: return (int)launch_p<1>(slab, idx, w, out, S, NQ, P, threads, blocks, s);
    case 4: return (int)launch_p<4>(slab, idx, w, out, S, NQ, P, threads, blocks, s);
    case 8: return (int)launch_p<8>(slab, idx, w, out, S, NQ, P, threads, blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
