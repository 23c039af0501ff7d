// Does one SM overlap CUDA-core work with tensor-core work? (P3)
//
// Replaces the TPU kernels of tools/bench_overlap.py::run (its
// `pallas_call` over the bodies k_vpu, k_mxu, k_both and k_interleave), a
// probe of whether a fused ConvNeXt block can hide its depthwise conv
// under its MLP. At stage 2's tile (TH x W x C = 8 x 84 x 768, so TOKENS =
// 672 rows of C) each kernel computes, per tile:
//   vpu         out = bf16(49 dependent f32 steps acc = acc + x * 0.01(i+1))
//   mxu         h = bf16(t @ w1) (f32 sums), out = bf16(h @ w2) (f32 sums);
//               t (672, 768), w1 (768, 3072), w2 (3072, 768), bf16
//   both        both of them on independent inputs in one block: warps 0-7
//               run the mxu work, warps 8-15 the vpu work (warp
//               specialisation, how a fused block would hide its dwconv)
//   interleave  4 row chunks of 168; every warp runs chunk j's mxu work and,
//               between its matrix steps, slices of chunk j's vpu work, in
//               one instruction stream
// The grid is 27 tiles, one block each, all reading the same whole arrays
// (as the TPU grid did), each writing its own (TOKENS, C) slice of the
// output. With 27 blocks on 132 SMs no two tiles share an SM, so the
// overlap measured is the overlap within one SM.
//
// What bounds them on an H100: operations. mxu: 27 x 6.34 GFLOP of bf16
// tensor-core work, 0.173 ms at 989 TFLOP/s for the whole card and 0.85 ms
// on the 27 SMs the grid occupies; vpu: 27 x 50.6 MFLOP of f32, 0.020 ms
// (0.10 ms on 27 SMs). The bytes (10 MB of inputs, 28 MB of outputs) are
// less.
//
// Design: the mxu work walks the rows in tiles of R = 32 (the last one
// masked). A tile of t sits in shared memory; 8 warps walk the hidden axis
// in chunks of 128 columns: each warp computes one 16-column slice of h for
// the tile (wmma bf16 16x16x16, f32 accumulators), rounds it to bf16 into
// shared memory, and after a barrier adds h_chunk @ w2_chunk into the 6
// output tiles it owns, whose f32 sums stay in fragments (12 a thread) for
// the whole hidden loop. Weight fragments come from device memory (L2),
// (in, out) layout, row-major B. The mxu warps synchronise with a named
// barrier (id 1, 256 threads), so in `both` the vpu warps never wait on
// them. The mxu work wants about 216 registers a thread; `both` launches
// 512 threads at 128 (all of the SM's 65,536), then the vpu warpgroups give
// up 88 each with setmaxnreg.dec and the mxu warpgroups take them with
// setmaxnreg.inc, Hopper's way to balance a warp-specialised block. The vpu
// work is one thread per 8 elements (a 16-byte load), the 8
// chains independent. No cuBLAS: the kernels issue their own mma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int WARPS = 8;               // warps of the mxu work
constexpr int MXU_THREADS = WARPS * 32;
constexpr int RT = 2;                  // 16-row tiles a row tile
constexpr int R = 16 * RT;
constexpr int HC = WARPS * 16;         // hidden columns a chunk
constexpr int MAXT = 6;                // output tiles a warp: C <= 768
constexpr int PAD = 8;                 // bf16 padding of a shared row
constexpr int NC = 4;                  // interleave's row chunks
constexpr int STEPS = 49;
constexpr int VEC = 8;
constexpr int VPU_REGS = 40;   // `both`: registers a vpu thread keeps
constexpr int MXU_REGS = 216;  // and an mxu thread takes: 256 * (40 + 216)

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) / 128 * 128; }

__host__ __device__ inline size_t t_bytes(int C) { return align128((size_t)R * (C + PAD) * 2); }
__host__ __device__ inline size_t h_bytes() { return align128((size_t)R * (HC + PAD) * 2); }
__host__ __device__ inline size_t smem_bytes(int C) {
  return t_bytes(C) + h_bytes() + (size_t)WARPS * 256 * 4;
}

__device__ __forceinline__ void mxu_barrier() {
  asm volatile("bar.sync 1, %0;" ::"r"(MXU_THREADS) : "memory");
}

// The 49-step chain on the 8 elements of vector v of x, into out.
__device__ __forceinline__ void vpu_vector(const uint4* __restrict__ x,
                                           uint4* __restrict__ out, long long v) {
  const uint4 raw = __ldg(x + v);
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
  out[v] = o;
}

// vpu work on vectors [v0, v1) by `n` threads, this one `tid`.
__device__ __forceinline__ void vpu_range(const uint4* x, uint4* out, long long v0,
                                          long long v1, int tid, int n) {
  for (long long v = v0 + tid; v < v1; v += n) vpu_vector(x, out, v);
}

// mxu work on rows [r0, r1) by the 8 mxu warps (tid < 256). Between its
// matrix steps, each thread also runs vpu vector vb + s * 256 + tid of the
// range [vb, ve) at step s (interleave; an empty range otherwise), and the
// rest of the range after the last step.
__device__ void mxu_rows(const bf16* __restrict__ t, const bf16* __restrict__ w1,
                         const bf16* __restrict__ w2, bf16* __restrict__ out,
                         int r0, int r1, int C, int HID, unsigned char* smem,
                         const uint4* vx, uint4* vout, long long vb, long long ve) {
  const int tid = threadIdx.x % MXU_THREADS;
  const int warp = tid >> 5, lane = tid & 31;
  bf16* ts = reinterpret_cast<bf16*>(smem);
  bf16* hs = reinterpret_cast<bf16*>(smem + t_bytes(C));
  float* stage = reinterpret_cast<float*>(smem + t_bytes(C) + h_bytes()) + warp * 256;
  const int tld = C + PAD, hld = HC + PAD;
  const int cvecs = C / VEC;
  long long vnext = vb + tid;

  for (int rb = r0; rb < r1; rb += R) {
    const int nvalid = min(R, r1 - rb);
    for (int i = tid; i < R * cvecs; i += MXU_THREADS) {
      const int r = i / cvecs, cv = i - r * cvecs;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < nvalid) v = __ldg(reinterpret_cast<const uint4*>(t + (size_t)(rb + r) * C) + cv);
      *reinterpret_cast<uint4*>(ts + r * tld + cv * VEC) = v;
    }
    mxu_barrier();

    FragC acc[RT][MAXT];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int k = 0; k < MAXT; ++k) wmma::fill_fragment(acc[rt][k], 0.f);

    for (int h0 = 0; h0 < HID; h0 += HC) {
      // this warp's 16 columns of h = bf16(t @ w1)
      FragC hacc[RT];
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) wmma::fill_fragment(hacc[rt], 0.f);
      for (int k = 0; k < C / 16; ++k) {
        FragB wf;
        wmma::load_matrix_sync(wf, w1 + (size_t)k * 16 * HID + h0 + warp * 16, HID);
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
          FragA ta;
          wmma::load_matrix_sync(ta, ts + rt * 16 * tld + k * 16, tld);
          wmma::mma_sync(hacc[rt], ta, wf, hacc[rt]);
        }
      }
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
        wmma::store_matrix_sync(stage, hacc[rt], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          hs[(rt * 16 + (e >> 4)) * hld + warp * 16 + (e & 15)] = __float2bfloat16_rn(stage[e]);
        }
        __syncwarp();
      }
      mxu_barrier();  // the chunk's h is complete

      // out[:, j] += h_chunk @ w2[h0:h0+HC, j] for this warp's tiles j
      for (int kk = 0; kk < HC / 16; ++kk) {
        FragA ha[RT];
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) wmma::load_matrix_sync(ha[rt], hs + rt * 16 * hld + kk * 16, hld);
#pragma unroll
        for (int k = 0; k < MAXT; ++k) {
          const int j = warp + WARPS * k;
          if (j * 16 < C) {
            FragB wf;
            wmma::load_matrix_sync(wf, w2 + (size_t)(h0 + kk * 16) * C + j * 16, C);
#pragma unroll
            for (int rt = 0; rt < RT; ++rt) wmma::mma_sync(acc[rt][k], ha[rt], wf, acc[rt][k]);
          }
        }
      }
      if (vnext < ve) {  // interleave: one vpu vector beside each step
        vpu_vector(vx, vout, vnext);
        vnext += MXU_THREADS;
      }
      mxu_barrier();  // hs is rewritten by the next chunk
    }

#pragma unroll
    for (int k = 0; k < MAXT; ++k) {
      const int j = warp + WARPS * k;
      if (j * 16 >= C) continue;
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
        wmma::store_matrix_sync(stage, acc[rt][k], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int row = rt * 16 + (e >> 4);
          if (row < nvalid) {
            out[(size_t)(rb + row) * C + j * 16 + (e & 15)] = __float2bfloat16_rn(stage[e]);
          }
        }
        __syncwarp();
      }
    }
    mxu_barrier();  // ts is rewritten by the next row tile
  }
  for (; vnext < ve; vnext += MXU_THREADS) vpu_vector(vx, vout, vnext);
}

__global__ void __launch_bounds__(MXU_THREADS)
vpu_kernel(const uint4* __restrict__ x, uint4* __restrict__ out, long long vecs) {
  vpu_range(x, out + blockIdx.x * vecs, 0, vecs, threadIdx.x, blockDim.x);
}

__global__ void __launch_bounds__(MXU_THREADS)
mxu_kernel(const bf16* __restrict__ t, const bf16* __restrict__ w1,
           const bf16* __restrict__ w2, bf16* __restrict__ out, int tokens,
           int C, int HID) {
  extern __shared__ __align__(128) unsigned char smem[];
  mxu_rows(t, w1, w2, out + (size_t)blockIdx.x * tokens * C, 0, tokens, C,
           HID, smem, nullptr, nullptr, 0, 0);
}

__global__ void __launch_bounds__(2 * MXU_THREADS, 1)
both_kernel(const uint4* __restrict__ x, const bf16* __restrict__ t,
            const bf16* __restrict__ w1, const bf16* __restrict__ w2,
            uint4* __restrict__ ov, bf16* __restrict__ om, int tokens, int C,
            int HID) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long long vecs = (long long)tokens * C / VEC;
  // 512 threads launch with 128 registers each (the SM's 65,536); the vpu
  // warpgroups give 88 of theirs to the mxu warpgroups
  if (threadIdx.x < MXU_THREADS) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(MXU_REGS));
    mxu_rows(t, w1, w2, om + (size_t)blockIdx.x * tokens * C, 0, tokens, C,
             HID, smem, nullptr, nullptr, 0, 0);
  } else {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(VPU_REGS));
    vpu_range(x, ov + blockIdx.x * vecs, 0, vecs, threadIdx.x - MXU_THREADS,
              MXU_THREADS);
  }
}

__global__ void __launch_bounds__(MXU_THREADS)
interleave_kernel(const uint4* __restrict__ x, const bf16* __restrict__ t,
                  const bf16* __restrict__ w1, const bf16* __restrict__ w2,
                  uint4* __restrict__ ov, bf16* __restrict__ om, int tokens,
                  int C, int HID) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long long vecs = (long long)tokens * C / VEC;
  const int rows = tokens / NC;
  const long long chunk = (long long)rows * C / VEC;
  for (int j = 0; j < NC; ++j) {
    mxu_rows(t, w1, w2, om + (size_t)blockIdx.x * tokens * C, j * rows,
             (j + 1) * rows, C, HID, smem, x, ov + blockIdx.x * vecs,
             j * chunk, (j + 1) * chunk);
  }
}

bool misaligned(const void* p, uintptr_t bytes) { return ((uintptr_t)p % bytes) != 0; }

int check_mxu(const void* t, const void* w1, const void* w2, const void* om,
              int tokens, int C, int HID) {
  if (tokens <= 0 || C <= 0 || C % 16 || C > 16 * WARPS * MAXT || HID <= 0 ||
      HID % HC || misaligned(t, 32) || misaligned(w1, 32) ||
      misaligned(w2, 32) || misaligned(om, 16)) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace

// x: (tokens, C) bf16; out: (tiles, tokens, C) bf16; tokens * C % 8 == 0,
// 16-byte aligned. Launches on `stream` and returns cudaGetLastError().
extern "C" int axvs_overlap_vpu(const void* x, void* out, int tokens, int C,
                                int tiles, void* stream) {
  const long long elems = (long long)tokens * C;
  if (tokens <= 0 || C <= 0 || elems % VEC || tiles <= 0 || misaligned(x, 16) ||
      misaligned(out, 16)) {
    return (int)cudaErrorInvalidValue;
  }
  vpu_kernel<<<tiles, MXU_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)x, (uint4*)out, elems / VEC);
  return (int)cudaGetLastError();
}

// t: (tokens, C), w1: (C, HID), w2: (HID, C), out: (tiles, tokens, C), all
// bf16, contiguous; C a multiple of 16 up to 768, HID a multiple of 128.
extern "C" int axvs_overlap_mxu(const void* t, const void* w1, const void* w2,
                                void* out, int tokens, int C, int HID,
                                int tiles, void* stream) {
  const size_t smem = smem_bytes(C);
  int err = check_mxu(t, w1, w2, out, tokens, C, HID);
  if (err || tiles <= 0) return (int)cudaErrorInvalidValue;
  if ((err = allow_smem(mxu_kernel, smem))) return err;
  mxu_kernel<<<tiles, MXU_THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)t, (const bf16*)w1, (const bf16*)w2, (bf16*)out, tokens, C, HID);
  return (int)cudaGetLastError();
}

// x and t: (tokens, C); w1, w2 as for the mxu kernel; ov, om: (tiles,
// tokens, C); bf16. `interleave` != 0 runs the interleaved kernel (tokens a
// multiple of 4), else the warp-specialised one.
extern "C" int axvs_overlap_both(const void* x, const void* t, const void* w1,
                                 const void* w2, void* ov, void* om,
                                 int tokens, int C, int HID, int tiles,
                                 int interleave, void* stream) {
  const size_t smem = smem_bytes(C);
  int err = check_mxu(t, w1, w2, om, tokens, C, HID);
  if (err || tiles <= 0 || misaligned(x, 16) || misaligned(ov, 16) ||
      (interleave && tokens % NC)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (interleave) {
    if ((err = allow_smem(interleave_kernel, smem))) return err;
    interleave_kernel<<<tiles, MXU_THREADS, smem, s>>>(
        (const uint4*)x, (const bf16*)t, (const bf16*)w1, (const bf16*)w2,
        (uint4*)ov, (bf16*)om, tokens, C, HID);
  } else {
    if ((err = allow_smem(both_kernel, smem))) return err;
    both_kernel<<<tiles, 2 * MXU_THREADS, smem, s>>>(
        (const uint4*)x, (const bf16*)t, (const bf16*)w1, (const bf16*)w2,
        (uint4*)ov, (bf16*)om, tokens, C, HID);
  }
  return (int)cudaGetLastError();
}
