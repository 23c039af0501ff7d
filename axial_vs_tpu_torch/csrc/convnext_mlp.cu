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
// bf16 ridge. The hidden activation's round trip through the workspace adds
// 4 P HID bytes, at most about 1.4 ms of device-memory time a clip against
// 2.77 ms of tensor-core time.
//
// Design: the two GEMM phases of convnext_mlp.cuh (TMA, an mbarrier ring,
// wgmma), launched back to back from this one entry point.

#include "convnext_mlp.cuh"

// x, shortcut, out: (P, C) bf16, contiguous; w1 (HID, C), w2 (C, HID) bf16;
// b1 (HID,), b2, gamma (C,) f32; h: a (P, HID) bf16 workspace. C and HID
// multiples of 16, C <= 1536; every pointer 16-byte aligned. Launches both
// phases on `stream` and returns 0 or the first CUDA error.
extern "C" int axvs_convnext_mlp(const void* x, const void* sc, const void* w1,
                                 const void* b1, const void* w2, const void* b2,
                                 const void* gamma, void* out, void* h, int P, int C,
                                 int HID, void* stream) {
  if (P <= 0 || C <= 0 || C % 16 || C > axvs_mlp::MAX_C || HID <= 0 || HID % 16) {
    return (int)cudaErrorInvalidValue;
  }
  return axvs_mlp::run(x, sc, w1, b1, w2, b2, gamma, out, h, P, C, HID,
                       (cudaStream_t)stream);
}
