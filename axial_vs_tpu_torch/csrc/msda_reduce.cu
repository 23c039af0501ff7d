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
// Design of K6 and K7: one thread per 8-channel (16-byte) vector of one
// output row, so a warp's load of one corner slot covers whole 64-byte row
// segments (D = 32: 8 rows a warp) and every byte of a gathered row is read
// once, in four 16-byte loads per sample. The 4 x 8 f32 accumulators stay in
// registers. The input pointers travel by value in a struct of at most 16,
// and the loops over them are unrolled, so no pointer array lives in memory.
//
// Design of K8, a staged row copy: its first version ran a thread per
// 16-byte output vector that found its source with 64-bit divisions and a
// modulo (dozens of instructions each, about as long as the vector's bytes
// take) and read every input row four times through L2. Now a block takes R
// output rows of one batch row, brings the two contiguous input runs they
// read (rows s0.. and s0 + W.., R + 1 each) into shared memory with TMA bulk
// copies, and writes each output row as M * 4 segments of D values with
// coalesced 16-byte stores; a thread's source is a fixed place in shared
// memory, found once. R keeps about 8 blocks an SM over a level (1 to 64).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"  // mbarriers, TMA bulk copies, the SM count

namespace {

constexpr int MAX_INPUTS = 16;
constexpr int THREADS = 256;
constexpr int VEC = 8;  // bf16 channels in 16 bytes
constexpr long long PACK_MAX_ROW = 16384;  // K8: M*D, two staged rows of each run
constexpr long long PACK_MAX_SMEM = 232448;  // a block's shared memory on an H100

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

// K8: a block copies a tile of R output rows [s0, s0 + R) of one batch row.
// One thread brings the two input runs it reads into shared memory by TMA
// bulk copies onto one mbarrier: rows [s0, s0 + R] (offsets 0 and 1) and
// [s0 + off, s0 + off + R] (offsets W and W + 1; off = W mod S), each split
// where it passes row S - 1 and goes on from row 0 of the batch row. Thread
// (qt, rt) then writes the output's 16-byte vector q = qt (+ QT, ...) of
// rows rt, rt + P, ...: lane vector q is slot (m, k) = (q / DV) / 4, % 4
// and vector q % DV of it (DV = D / 8), whose source in shared memory is a
// fixed place in run k / 2, row r + k % 2; one division a (thread, q), and
// 32-bit offsets from the tile's base.
__device__ __forceinline__ void bulk_run(__nv_bfloat16* dst, const __nv_bfloat16* vb,
                                         int start, int count, int S, int MD,
                                         uint64_t* bar) {
  while (count > 0) {
    const int n = min(count, S - start);
    axvs_hopper::bulk_load(dst, vb + (size_t)start * MD, (uint32_t)n * MD * 2, bar);
    dst += n * MD;
    count -= n;
    start = 0;
  }
}

__global__ void __launch_bounds__(1024)
pack_corner_table_kernel(const __nv_bfloat16* __restrict__ v,  // (B, S, M*D)
                         __nv_bfloat16* __restrict__ out,  // (B, S, M*4D)
                         int S, long long batch_stride, int MD, int D, int off,
                         int R, int tiles, int QT) {
  extern __shared__ uint4 pack_smem[];  // two runs of R + 1 rows, then the mbarrier
  const int b = (int)blockIdx.x / tiles;
  const int s0 = ((int)blockIdx.x - b * tiles) * R;
  const int rows = min(R, S - s0);
  __nv_bfloat16* run0 = reinterpret_cast<__nv_bfloat16*>(pack_smem);
  __nv_bfloat16* run1 = run0 + (R + 1) * MD;
  uint64_t* bar = reinterpret_cast<uint64_t*>(run1 + (R + 1) * MD);
  if (threadIdx.x == 0) {
    axvs_hopper::mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const __nv_bfloat16* vb = v + (size_t)b * batch_stride;
    axvs_hopper::mbar_expect_tx(bar, 2u * (uint32_t)(rows + 1) * MD * 2);
    bulk_run(run0, vb, s0, rows + 1, S, MD, bar);
    bulk_run(run1, vb, (s0 + off) % S, rows + 1, S, MD, bar);
  }
  const int vr = MD / 2;  // 16-byte vectors of an output row (4 * MD bf16)
  const int dvs = D / VEC;
  const int qt = threadIdx.x % QT, rt = threadIdx.x / QT, P = blockDim.x / QT;
  __nv_bfloat16* tile = out + ((size_t)b * S + s0) * 4 * MD;
  axvs_hopper::mbar_wait(bar, 0);
  for (int q = qt; q < vr; q += QT) {
    const int seg = q / dvs, dv = q - seg * dvs;
    const int m = seg >> 2, k = seg & 3;
    const __nv_bfloat16* src = (k < 2 ? run0 : run1) + (k & 1) * MD + m * D + dv * VEC;
    for (int r = rt; r < rows; r += P) {
      *reinterpret_cast<uint4*>(tile + r * 4 * MD + q * VEC) =
          *reinterpret_cast<const uint4*>(src + r * MD);
    }
  }
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
// bf16, contiguous; 16-byte aligned, D and batch_stride multiples of 8, M*D
// at most PACK_MAX_ROW. width: the level's W (offsets 0, 1, W, W + 1, taken
// mod S).
extern "C" int axvs_pack_corner_table(const void* v, void* out, int B, int S,
                                      long long batch_stride, int M, int D,
                                      int width, void* stream) {
  if (B <= 0 || S <= 0 || M <= 0 || D <= 0 || D % VEC || width <= 0 ||
      (long long)M * D > PACK_MAX_ROW || batch_stride % VEC ||
      ((uintptr_t)v & 15) || ((uintptr_t)out & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  const int MD = M * D;
  int sms = 0;
  cudaError_t err = axvs_hopper::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  // rows a tile: about 8 blocks an SM over the level, 1 to 64, and the two
  // runs within a block's shared memory
  const long long total = (long long)B * S;
  long long r = (total + 8LL * sms - 1) / (8LL * sms);
  const long long fit = (PACK_MAX_SMEM - 16) / (4LL * MD) - 1;
  r = r < 1 ? 1 : (r > 64 ? 64 : r);
  r = r > fit ? fit : r;
  const int R = (int)r;
  const long long tiles = (S + R - 1) / R;
  if (tiles * B > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int vr = MD / 2;
  const int QT = vr < 1024 ? vr : 1024;
  int P = 256 / QT;
  P = P < 1 ? 1 : (P > R ? R : P);
  const size_t smem = (size_t)2 * (R + 1) * MD * 2 + 16;
  static size_t allowed = 0;  // raised once, not at every launch (host time)
  if (smem > allowed) {
    err = cudaFuncSetAttribute(pack_corner_table_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  pack_corner_table_kernel<<<(unsigned)(tiles * B), QT * P, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, S, batch_stride, MD, D,
      (int)(width % S), R, (int)tiles, QT);
  return (int)cudaGetLastError();
}
