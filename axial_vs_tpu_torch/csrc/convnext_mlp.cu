// Fused ConvNeXt block tail (inference), bf16 rows in and out:
//   out = shortcut + gamma * (gelu_tanh(x @ W1^T + b1) @ W2^T + b2)
//
// Replaces the TPU kernel axial_vs_tpu/ops/convnext_pallas.py::
// convnext_mlp_residual (Pallas body `_mlp_kernel`), with its rounding points
// (see convnext_mlp.cuh).
//
// What bounds it on an H100: operations. Each call does 4 P C HID FLOPs
// (16 P C^2 in ConvNeXt, 76 GFLOP per call at every ConvNeXt-L stage of a
// 2x769x1345 clip) against 3 P C + 2 C HID bf16 elements of x, shortcut, out
// and weights: several thousand FLOPs per byte, far above the card's ~295
// bf16 ridge.
//
// Design: one block of 8 warps per tile of R = 16 RT consecutive rows. The
// tile of x is copied to shared memory once (rows past P are zero), then the
// shared MLP body runs the hidden axis in 128-column chunks on the tensor
// cores with the R x C f32 accumulator in registers, and the epilogue adds the
// scaled result to the shortcut. RT is 4 for C <= 384, 2 at C = 768 and 1 at
// C = 1536, so that the accumulator stays within 96 registers a thread; the
// weights are re-read from L2 once per tile, which is what a later version
// with larger tiles (wgmma, a cluster sharing the weights) would cut.

#include "convnext_mlp.cuh"

namespace {

using namespace axvs_mlp;

template <int RT, int MAXT>
__global__ void __launch_bounds__(THREADS)
mlp_residual_kernel(const bf16* __restrict__ x, const bf16* __restrict__ sc,
                    const bf16* __restrict__ w1, const float* __restrict__ b1,
                    const bf16* __restrict__ w2, const float* __restrict__ b2,
                    const float* __restrict__ gamma, bf16* __restrict__ out,
                    int P, int C, int HID) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int R = 16 * RT;
  const int xld = C + PAD;
  bf16* xs = (bf16*)smem;
  bf16* hs = (bf16*)(smem + align128((size_t)R * xld * 2));
  float* stage = (float*)((unsigned char*)hs + hidden_bytes(R)) + (threadIdx.x >> 5) * 256;

  const size_t p0 = (size_t)blockIdx.x * R;
  const int nvalid = P - (int)p0 < R ? P - (int)p0 : R;
  const int chunks = C / 8;  // 16-byte pieces of one row
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < R * chunks; i += THREADS) {
    const int r = i / chunks, ch = i % chunks;
    uint4 v = zero;
    if (r < nvalid) v = *(const uint4*)(x + (p0 + r) * C + ch * 8);
    *(uint4*)(xs + r * xld + ch * 8) = v;
  }
  __syncthreads();

  FragC acc[RT][MAXT];
  mlp_accumulate<RT, MAXT>(xs, xld, hs, stage, w1, b1, w2, C, HID, acc);
  mlp_store<RT, MAXT>(acc, stage, b2, gamma, sc, out, p0, nvalid, C);
}

size_t smem_bytes(int rt, int C) {
  const int rows = 16 * rt;
  return align128((size_t)rows * (C + PAD) * 2) + hidden_bytes(rows) + stage_bytes();
}

template <int RT, int MAXT>
int launch(const void* x, const void* sc, const void* w1, const void* b1,
           const void* w2, const void* b2, const void* gamma, void* out, int P,
           int C, int HID, cudaStream_t stream) {
  const size_t smem = smem_bytes(RT, C);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_residual_kernel<RT, MAXT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((P + 16 * RT - 1) / (16 * RT));
  mlp_residual_kernel<RT, MAXT><<<blocks, THREADS, smem, stream>>>(
      (const bf16*)x, (const bf16*)sc, (const bf16*)w1, (const float*)b1,
      (const bf16*)w2, (const float*)b2, (const float*)gamma, (bf16*)out, P, C,
      HID);
  return (int)cudaGetLastError();
}

}  // namespace

// x, shortcut, out: (P, C) bf16, contiguous; w1 (HID, C), w2 (C, HID) bf16;
// b1 (HID,), b2, gamma (C,) f32. C and HID multiples of 16, C <= 1536; every
// pointer 32-byte aligned. Launches on `stream`, returns cudaGetLastError().
extern "C" int axvs_convnext_mlp(const void* x, const void* sc, const void* w1,
                                 const void* b1, const void* w2, const void* b2,
                                 const void* gamma, void* out, int P, int C,
                                 int HID, void* stream) {
  if (P <= 0 || C <= 0 || C % 16 || C > MAX_C || HID <= 0 || HID % 16) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (tiles_per_warp(C)) {
    case 1: return launch<4, 1>(x, sc, w1, b1, w2, b2, gamma, out, P, C, HID, s);
    case 2: return launch<4, 2>(x, sc, w1, b1, w2, b2, gamma, out, P, C, HID, s);
    case 3: return launch<4, 3>(x, sc, w1, b1, w2, b2, gamma, out, P, C, HID, s);
    case 4: return launch<3, 4>(x, sc, w1, b1, w2, b2, gamma, out, P, C, HID, s);
    case 6: return launch<2, 6>(x, sc, w1, b1, w2, b2, gamma, out, P, C, HID, s);
    case 8: return launch<1, 8>(x, sc, w1, b1, w2, b2, gamma, out, P, C, HID, s);
    default: return launch<1, 12>(x, sc, w1, b1, w2, b2, gamma, out, P, C, HID, s);
  }
}
