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
// per input element against 2 bytes read. The gather moves its table, its
// indices and its output once: 25.2 MB at S = 16384 f32 (0.0075 ms).
//
// Design of the copy and the sum: one thread per 16-byte vector (8 bf16),
// neighbouring threads on neighbouring vectors, so each warp reads whole
// 512-byte segments; the sum's input pointers travel by value in a struct
// (as csrc/msda_reduce.cu passes its rows) and its loop is unrolled, so up to
// 16 independent 16-byte loads are in flight a thread.
//
// Design of the gather: the table on chip, which is what the TPU probe
// asks about (does a gather from a table in on-chip memory run at a
// constant rate?). The table is cut into column slices of W = 8 columns
// over all S rows, so that a row's 8 indices are one 32-byte sector (its 8
// outputs one sector in f32, half of one in bf16). A CTA holds the slice's
// rows in shared memory, brought in by TMA boxes of up to 256 rows under one
// mbarrier, and looks its indices up there; eight lanes share an index row,
// a lane a column, so a warp reads and writes 4 whole rows at a time. A
// thread keeps 16 index rows' loads in flight, and issues the first 16
// before it waits for the table, so that the index stream overlaps the
// table's load. Where a slice fits a CTA's 128 KB (S <= 4096 in f32, 8192 in
// bf16), 4 CTAs each hold all of it and take a quarter of its index rows:
// 64 CTAs for 128 columns. A larger slice is cut into Q row ranges of a
// power of two rows (a row's range is a shift), one a CTA; each range's
// CTA scans half of the slice's index rows and writes the outputs whose
// rows it holds: 128 CTAs at S = 16384 f32 (Q = 4), each index read Q times
// from L2. Indices outside [0, S) give 0, written by range 0 (the TPU kernel
// promised them in bounds; the kernel keeps memory safe instead). A table
// of more than 8 ranges (S > 32768 in f32, 65536 in bf16) or whose columns
// are not a multiple of 8 is refused.
//
// Tried on an H100 and dropped (PERF.md, section 6): the slice split over a
// thread-block cluster, each lookup sent to its owner in distributed shared
// memory (mapa, ld.shared::cluster), about twice the row ranges' time at
// S = 16384 f32 and slower at every table; 8 CTAs holding each slice,
// slower than 4 (each copy is an L2 read of the slice). Even so the row
// ranges are slower than a gather through L2 at S = 16384.

#include "hopper.cuh"  // mbarriers, TMA loads, tensor-map encoding

namespace {

using axvs_hopper::smem_u32;

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

namespace gather {
constexpr int W = 8;                   // columns of a slice
constexpr int THREADS = 1024;          // W lanes an index row
constexpr int GROUPS = THREADS / W;    // index rows a pass
constexpr int U = 16;                  // passes in flight a thread
constexpr int BOX_ROWS = 256;          // TMA's limit on a box dimension
constexpr int MAX_BYTES = 128 * 1024;  // a CTA's rows of its slice
constexpr int MAX_RANGES = 8;          // row ranges a slice may be cut into
}  // namespace gather

// The column gather. CTA (slice, q, p) of the grid holds rows [q R, q R + R)
// (R = 1 << shift) of the slice's W columns in shared memory and scans index
// part p of P; with one range (RANGES false) it holds all S rows. An output
// goes out from the CTA that holds its row; indices outside [0, S) give 0,
// from range 0.
template <typename T, bool RANGES>
__global__ void __launch_bounds__(gather::THREADS, 1)
column_gather_kernel(const __grid_constant__ CUtensorMap table_map, const int* __restrict__ idx,
                     T* __restrict__ out, int S, int N, int C, int shift, int Q, int P,
                     int box_rows) {
  using gather::W;
  using gather::U;
  using gather::GROUPS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  const int R = 1 << shift;
  T* table = reinterpret_cast<T*>(base);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + (size_t)R * W * sizeof(T));
  const int j = (int)(blockIdx.x % (Q * P)), q = j % Q, p = j / Q;
  const int col0 = (int)(blockIdx.x / (Q * P)) * W;
  const int held = min(max(S - q * R, 0), R);  // table rows this CTA holds
  if (threadIdx.x == 0) {
    axvs_hopper::mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && held > 0) {
    const int boxes = (held + box_rows - 1) / box_rows;  // whole boxes, zeros past S
    axvs_hopper::mbar_expect_tx(bar, (uint32_t)(boxes * box_rows * W * sizeof(T)));
    for (int b = 0; b < boxes; ++b) {
      axvs_hopper::tma_load_2d(table + (size_t)b * box_rows * W, &table_map, bar, col0,
                               q * R + b * box_rows);
    }
  }
  const int per = (N + P - 1) / P;
  const int i0 = p * per, i1 = min(N, i0 + per);
  const int k = threadIdx.x % W, g = threadIdx.x / W, col = col0 + k;
  int row[U];
  bool first = true;  // the first pass's indices load while the table lands
  for (int b = i0; b < i1; b += GROUPS * U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = b + u * GROUPS + g;
      row[u] = i < i1 ? __ldg(idx + (size_t)i * C + col) : -1;
    }
    if (first && held > 0) axvs_hopper::mbar_wait(bar, 0);
    first = false;
    T v[U];
    bool mine[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = row[u];
      const bool in = (unsigned)r < (unsigned)S;
      mine[u] = !RANGES || (in ? (r >> shift) == q : q == 0);
      v[u] = in && mine[u] ? table[(size_t)(r & (R - 1)) * W + k] : T(0.f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = b + u * GROUPS + g;
      if (i < i1 && mine[u]) out[(size_t)i * C + col] = v[u];
    }
  }
  if (first && held > 0) axvs_hopper::mbar_wait(bar, 0);  // no exit while TMA writes here
}

// A tensor map of the (S, C) table with boxes of W columns x box_rows rows,
// no swizzle, zeros past the ends. 0 or a CUDA error.
int make_table_map(CUtensorMap* map, const void* t, int S, int C, int elem_bytes, int box_rows) {
  axvs_hopper::EncodeTiledFn encode = axvs_hopper::encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)S};
  const cuuint64_t strides[1] = {(cuuint64_t)C * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)gather::W, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, const_cast<void*>(t), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_gather(const void* t, const void* idx, void* out, int S, int N, int C,
                  cudaStream_t stream) {
  using namespace gather;
  // the fewest row ranges (a power of two) whose rows fit a CTA: R >= 8
  int Q = 1, shift = 3;
  for (;;) {
    shift = 3;
    while ((1LL << shift) * Q < S) ++shift;
    if ((1LL << shift) * W * (long long)sizeof(T) <= MAX_BYTES) break;
    if ((Q *= 2) > MAX_RANGES) return (int)cudaErrorInvalidValue;
  }
  // index parts, the CTAs of a range: the fastest measured on an H100 at the
  // TPU probe's four tables (PERF.md, section 6)
  const int P = Q == 1 ? 4 : 2;
  const long long R = 1LL << shift;
  const int box_rows = (int)(R < BOX_ROWS ? R : BOX_ROWS);
  CUtensorMap map;
  int err = make_table_map(&map, t, S, C, (int)sizeof(T), box_rows);
  if (err) return err;
  const size_t smem = (size_t)(R * W * sizeof(T)) + 8 + 128;  // the mbarrier, the alignment
  void (*kernel)(CUtensorMap, const int*, T*, int, int, int, int, int, int, int) =
      Q > 1 ? column_gather_kernel<T, true> : column_gather_kernel<T, false>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(C / W) * Q * P, gather::THREADS, smem, stream>>>(map, (const int*)idx, (T*)out,
                                                              S, N, C, shift, Q, P, box_rows);
  return (int)cudaGetLastError();
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
// t's type; all contiguous and 16-byte aligned; C a multiple of 8; S at
// most 8 ranges of 128 KB of a slice (32768 rows in f32, 65536 in bf16).
extern "C" int axvs_column_gather(const void* t, const void* idx, void* out, int S, int N,
                                  int C, int is_bf16, void* stream) {
  if (S <= 0 || N <= 0 || C <= 0 || C % gather::W || misaligned(t) || misaligned(idx) ||
      misaligned(out)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch_gather<__nv_bfloat16>(t, idx, out, S, N, C, s)
                 : launch_gather<float>(t, idx, out, S, N, C, s);
}
