// Does an SM overlap CUDA-core work with tensor-core work? (P3)
//
// Replaces the TPU kernels of tools/bench_overlap.py::run (its
// `pallas_call` over the bodies k_vpu, k_mxu, k_both and k_interleave), a
// probe of whether a fused ConvNeXt block can hide its depthwise conv
// under its MLP. At stage 2's tile (TH x W x C = 8 x 84 x 768, so TOKENS =
// 672 rows of C), for each of 27 tiles:
//   vpu         out = bf16(49 dependent f32 steps acc = acc + x * 0.01(i+1))
//   mxu         h = bf16(t @ w1) (f32 sums), out = bf16(h @ w2) (f32 sums);
//               t (672, 768), w1 (768, 3072), w2 (3072, 768), bf16
//   both        both of them on independent inputs in one kernel
//   interleave  both of them in one instruction stream
// Every tile reads the same inputs and writes its own (TOKENS, C) slice.
//
// The mapping. The TPU call gives its grid no dimension semantics, so its
// 27 steps run one after another on one TensorCore, each with the whole
// core's matrix and vector units. The card's counterpart of that core is
// the whole card: every kernel here spreads the 27 tiles' work over all
// SMs, and every SM that runs `both` or `interleave` runs both kinds of
// work, so what is measured is still the overlap inside an SM.
//
// What bounds them on an H100: operations. mxu: 27 x 6.34 GFLOP of bf16
// tensor-core products, 0.173 ms at 989 TFLOP/s; vpu: 27 x 50.6 MFLOP of
// f32, 0.020 ms at 67 TFLOP/s. The bytes (the A operand's 27.9 MB copy,
// 9.4 MB of weights, 27.9 MB of outputs a kind) are less.
//
// Design.
// - mxu: the two GEMM phases of convnext_mlp.cuh (the K4/K5 core: TMA ring
//   under mbarriers, wgmma from 128-byte-swizzled slices, one persistent
//   block an SM) over all 18,144 rows of the 27 tiles, with the Bf16Store
//   epilogue:
//     phase 1 (ping-pong, 128 x 128 tiles): h = bf16(t @ w1) into a
//       (27 x 672, 4C) workspace,
//     phase 2 (cooperative, 128 x 192 tiles): out = bf16(h @ w2).
//   The core computes A B^T with K-major operands, so it takes w1^T
//   (4C, C) and w2^T (C, 4C), and its A operand is a (27 x 672, C) copy of
//   t; the caller makes all three once (bench_overlap.py::mxu_operands).
//   The TPU body fused the two products and kept h in VMEM, whose limit it
//   raised to 100 MB. Here they stay two phases: h for one 128-row tile is
//   768 KB, more than an SM's shared memory, and a 64 x 768 f32 output
//   accumulator would take 192 registers a thread over two warpgroups
//   before any of h.
// - vpu: one thread a 16-byte vector (8 bf16, 8 independent chains) over
//   all 27 tiles' vectors.
// - both: the same two phases with a fourth warpgroup in each persistent
//   block (registers 40 producer, 40 vpu, 216 for each consumer: 512 x 128
//   = the SM's 65,536). Phase 1 carries the first half of the 27 tiles'
//   vpu vectors and phase 2 the second; within a phase, block b's vpu
//   warpgroup takes vectors b x 128 + i, striding by the grid, while the
//   consumers run wgmma.
// - interleave: the same two phases, three warpgroups; the same halves of
//   the vpu vectors, shared out over the consumer threads of all blocks.
//   After issuing each K slice's wgmma group and before waiting for it, a
//   consumer thread runs its next vpu vectors, spread evenly over its K
//   slices of the launch: Hopper's counterpart of the TPU body's single
//   instruction stream over 4 row chunks.
//   A consumer thread loads each of its vectors one vector ahead.

#include "convnext_mlp.cuh"

namespace {

using axvs_hopper::bf16;

constexpr int STEPS = 49;
constexpr int VEC = 8;           // bf16 a 16-byte vector
constexpr int VPU_THREADS = 256;

// The 49-step chain on 8 elements.
__device__ __forceinline__ uint4 vpu_chain(const uint4& raw) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float a[VEC], acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    a[2 * i] = f.x;
    a[2 * i + 1] = f.y;
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
#pragma unroll
  for (int i = 0; i < STEPS; ++i) {
    const float c = (float)(0.01 * (i + 1));  // np.float32(0.01 * (i + 1))
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = fmaf(a[j], c, acc[j]);
  }
  uint4 o;
  __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) oh[i] = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
  return o;
}

// Vectors [begin, end) of the (tiles x xvecs) vpu output: out[v] =
// chain(x[v % xvecs]).
struct VpuShare {
  const uint4* x;
  uint4* out;
  unsigned xvecs, begin, end;
  __device__ __forceinline__ uint4 load(unsigned v) const { return __ldg(x + v % xvecs); }
};

// A thread's vectors v, v + stride, ... below w.end, each loaded one vector
// ahead of its chain, so that a load's latency passes under what the thread
// runs before it.
struct VpuWalk {
  VpuShare w;
  unsigned v, stride;
  uint4 next;
  __device__ __forceinline__ VpuWalk(const VpuShare& share, unsigned first, unsigned step)
      : w(share), v(first), stride(step) {
    if (v < w.end) next = w.load(v);
  }
  __device__ __forceinline__ void run_one() {
    const uint4 raw = next;
    const unsigned cur = v;
    v += stride;
    if (v < w.end) next = w.load(v);
    w.out[cur] = vpu_chain(raw);
  }
};

// `both`: warpgroup 3 of every block runs the block's share of the vectors.
struct SideWarpgroup {
  static constexpr int WARPGROUPS = 4;
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 216, SIDE_REGS = 40;
  VpuShare w;
  __device__ __forceinline__ void warpgroup() const {  // no prefetch: 40 registers
    const unsigned stride = gridDim.x * 128u;
    for (unsigned v = w.begin + blockIdx.x * 128u + (threadIdx.x - 384u); v < w.end; v += stride) {
      w.out[v] = vpu_chain(w.load(v));
    }
  }
  using Slice = axvs_mlp::NoSide::Slice;
  __device__ __forceinline__ Slice consumer(int) const { return Slice{}; }
};

// `interleave`: each consumer thread's `n` vectors, striding by all consumer
// threads of the grid, spread evenly over its `steps` K slices.
struct InterleaveSlice {
  VpuWalk walk;
  int n, steps, step_i, done;
  __device__ __forceinline__ void step() {
    const int target = (int)((long long)++step_i * n / steps);
    for (; done < target; ++done) walk.run_one();
  }
  __device__ __forceinline__ void finish() {
    for (; done < n; ++done) walk.run_one();
  }
};

struct SideInterleave {
  static constexpr int WARPGROUPS = 3;
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  VpuShare w;
  using Slice = InterleaveSlice;
  __device__ __forceinline__ Slice consumer(int steps) const {
    const unsigned stride = gridDim.x * 256u, v = w.begin + blockIdx.x * 256u + threadIdx.x;
    const int n = v < w.end ? (int)((w.end - v + stride - 1) / stride) : 0;
    return Slice{VpuWalk(w, v, stride), n, steps > 0 ? steps : 1, 0, 0};
  }
};

__global__ void __launch_bounds__(VPU_THREADS)
vpu_kernel(const uint4* __restrict__ x, uint4* __restrict__ out, unsigned xvecs) {
  const unsigned xv = blockIdx.x * VPU_THREADS + threadIdx.x;
  if (xv < xvecs) out[blockIdx.y * xvecs + xv] = vpu_chain(__ldg(x + xv));
}

bool misaligned(const void* p) { return ((uintptr_t)p & 15) != 0; }

// The two GEMM phases: a (rows, C) @ w1t^T -> h (rows, HID), h @ w2t^T ->
// out (rows, C), with `side` (one per phase) beside the products.
template <class Side>
int mxu_phases(const void* a, const void* w1t, const void* w2t, void* h, void* out, int rows,
               int C, int HID, const Side& side1, const Side& side2, cudaStream_t stream) {
  using namespace axvs_mlp;
  const Bf16Store store_h{(bf16*)h, HID};
  int err = launch_gemm<128>(gemm_pingpong_kernel<128, Bf16Store, Side>, a, w1t, rows, HID, C,
                             store_h, stream, side1);
  if (err) return err;
  const Bf16Store store_out{(bf16*)out, C};
  return launch_gemm<192>(gemm_cooperative_kernel<192, Bf16Store, Side>, h, w2t, rows, C, HID,
                          store_out, stream, side2);
}

// The GEMM phases' operands: rows of C and HID that the core takes.
int check_mxu(const void* const* ptrs, int n, int rows, int C, int HID) {
  if (rows <= 0 || C <= 0 || C % 16 || C > axvs_mlp::MAX_C || HID <= 0 || HID % 16) {
    return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < n; ++i) {
    if (ptrs[i] == nullptr || misaligned(ptrs[i])) return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// x: (tokens, C) bf16; out: (tiles, tokens, C) bf16; tokens * C % 8 == 0,
// 16-byte aligned, tiles <= 65535. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int axvs_overlap_vpu(const void* x, void* out, int tokens, int C, int tiles,
                                void* stream) {
  const long long elems = (long long)tokens * C;
  if (tokens <= 0 || C <= 0 || elems % VEC || tiles <= 0 || tiles > 65535 ||
      elems / VEC * tiles > 2147483647LL || misaligned(x) || misaligned(out)) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned xvecs = (unsigned)(elems / VEC);
  const dim3 grid((xvecs + VPU_THREADS - 1) / VPU_THREADS, tiles);
  vpu_kernel<<<grid, VPU_THREADS, 0, (cudaStream_t)stream>>>((const uint4*)x, (uint4*)out,
                                                            xvecs);
  return (int)cudaGetLastError();
}

// a: (rows, C), the tiles' rows of t; w1t: (HID, C); w2t: (C, HID); h: a
// (rows, HID) workspace; out: (rows, C); all bf16, contiguous, 16-byte
// aligned; C a multiple of 16 up to 1536, HID a multiple of 16.
extern "C" int axvs_overlap_mxu(const void* a, const void* w1t, const void* w2t, void* h,
                                void* out, int rows, int C, int HID, void* stream) {
  const void* ptrs[] = {a, w1t, w2t, h, out};
  const int err = check_mxu(ptrs, 5, rows, C, HID);
  if (err) return err;
  const axvs_mlp::NoSide none{};
  return mxu_phases(a, w1t, w2t, h, out, rows, C, HID, none, none, (cudaStream_t)stream);
}

// x: (tokens, C), the vpu input; a, w1t, w2t, h as for axvs_overlap_mxu
// with rows = tiles * tokens; ov, om: (tiles, tokens, C), the vpu and mxu
// outputs; bf16. `interleave` != 0 runs the vpu work in the consumer
// warpgroups, else in a fourth warpgroup.
extern "C" int axvs_overlap_both(const void* x, const void* a, const void* w1t,
                                 const void* w2t, void* h, void* ov, void* om, int tokens,
                                 int tiles, int C, int HID, int interleave, void* stream) {
  const long long rows = (long long)tokens * tiles;
  const void* ptrs[] = {x, a, w1t, w2t, h, ov, om};
  if (tokens <= 0 || tiles <= 0 || rows > 2147483647LL || rows * C / VEC > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  const int err = check_mxu(ptrs, 7, (int)rows, C, HID);
  if (err) return err;
  const unsigned xvecs = (unsigned)((long long)tokens * C / VEC);
  const unsigned vecs = (unsigned)(rows * C / VEC), half = vecs / 2;
  const VpuShare first{(const uint4*)x, (uint4*)ov, xvecs, 0u, half};
  const VpuShare second{(const uint4*)x, (uint4*)ov, xvecs, half, vecs};
  cudaStream_t s = (cudaStream_t)stream;
  if (interleave) {
    return mxu_phases(a, w1t, w2t, h, om, (int)rows, C, HID, SideInterleave{first},
                      SideInterleave{second}, s);
  }
  return mxu_phases(a, w1t, w2t, h, om, (int)rows, C, HID, SideWarpgroup{first},
                    SideWarpgroup{second}, s);
}
