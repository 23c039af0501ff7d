// Whole ConvNeXt block (inference), NHWC bf16 in and out:
//   y   = LayerNorm_C(dwconv7x7_same(x) + dw_bias) * ln_w + ln_b   (f32, cast bf16)
//   out = x + gamma * (gelu_tanh(y @ W1^T + b1) @ W2^T + b2)
//
// Replaces the TPU kernel axial_vs_tpu/ops/convnext_pallas.py::
// convnext_block_fused (Pallas body `_block_kernel`). Its rounding points are
// the TPU kernel's: f32 taps and LayerNorm, the normalised tile stored bf16
// (the TPU kernel's `dbuf`), then the MLP tail of convnext_mlp.cuh. So the
// result is K1's rounding followed by K5's.
//
// What bounds it on an H100: operations, as for the MLP alone (16 P C^2
// FLOPs, 76 GFLOP per call at every ConvNeXt-L stage of a 2x769x1345 clip);
// the 49-tap depthwise conv adds 98 P C f32 operations on the CUDA cores.
//
// Design, the first version for this card: three phases from one entry
// point. The depthwise conv and LayerNorm are K1's device code
// (dwconv_ln.cu, through its launcher), which writes y once into a bf16
// workspace; then the two GEMM phases of convnext_mlp.cuh (TMA, an mbarrier
// ring, wgmma) with the residual x. The TPU kernel hid the dw part under the
// MLP of the previous tile (a VPU/MXU pipeline). Here the two run one after
// the other: whether the CUDA cores' dw work can hide beside a wgmma MLP is
// the question the overlap probe (P3) must answer again against this MLP
// before that is tried.

#include "convnext_mlp.cuh"

// K1's launcher (dwconv_ln.cu): bf16 NHWC in and out, (7, 7, C) taps, f32
// sums and LayerNorm.
extern "C" int axvs_dwconv7x7_ln(const void* x, const void* wt, const void* bias,
                                 const void* ln_w, const void* ln_b, void* out, int N,
                                 int H, int W, int C, float eps, void* stream);

// x, out, y: (N, H, W, C) bf16, contiguous (y a workspace); wt: the
// depthwise taps tap-major, (7, 7, C) bf16, as K1 takes them; dw_bias,
// ln_w, ln_b, b2, gamma: (C,) f32; w1 (HID, C), w2 (C, HID) bf16; b1
// (HID,) f32; h: a (N H W, HID) bf16 workspace. C and HID
// multiples of 16, C <= 1536; every pointer 16-byte aligned. Launches the
// three phases on `stream` and returns 0 or the first CUDA error.
extern "C" int axvs_convnext_block(const void* x, const void* wt, const void* dwb,
                                   const void* ln_w, const void* ln_b,
                                   const void* w1, const void* b1, const void* w2,
                                   const void* b2, const void* gamma, void* out, void* y,
                                   void* h, int N, int H, int W, int C, int HID, float eps,
                                   void* stream) {
  if (N <= 0 || N > 65535 || H <= 0 || H > 65535 || W <= 0 || C <= 0 || C % 16 ||
      C > axvs_mlp::MAX_C || HID <= 0 || HID % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const int err = axvs_dwconv7x7_ln(x, wt, dwb, ln_w, ln_b, y, N, H, W, C, eps, stream);
  if (err) return err;
  const long long P = (long long)N * H * W;
  if (P > 2147483647LL) return (int)cudaErrorInvalidValue;
  return axvs_mlp::run(y, x, w1, b1, w2, b2, gamma, out, h, (int)P, C, HID,
                       (cudaStream_t)stream);
}
