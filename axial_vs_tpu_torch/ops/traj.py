"""Middle section of two-stage trajectory attention (kernel K3), forward
and backward.

Counterpart of ``axial_vs_tpu/ops/traj_pallas.py::fused_trajectory_attention``
(its math is ``_traj_math``): everything between the q/k/v projections and
the output projection of ``layers/trajectory_attention.py``. Per head:

1. a spatial softmax over each frame's n keys (scaled by d^-0.5, in f32),
   aggregating that frame's values: the trajectory x (B, N, f, C);
2. the frame diagonal: token s keeps its own frame's aggregation;
3. the stage-2 projections ``proj_q`` (of the diagonal) and ``proj_kv``
   (of every frame's aggregation);
4. a temporal softmax over the f frames (f32) and the weighted sum of v2.

Rounding points are the TPU kernel's: the spatial probabilities are cast to
the input dtype before the AV product; the AV product and the projections
accumulate in f32 and are cast once, and the projections then get their bias
added in the input dtype; the temporal logits, softmax and sum stay in f32,
with one cast at the end. In f32 every cast is exact.

The CUDA kernel is ``csrc/traj.cu``; ``trajectory_attention_core_plain`` is
its plain PyTorch version. It runs as two launches joined by two workspaces
in q's dtype that the wrapper allocates: the trajectory x (f, B N, C) and its
frame diagonal (B N, C). In bf16 stage 1 runs on ``mma.sync`` and stage 2 is
a TMA-fed ``wgmma`` GEMM with the temporal softmax in its epilogue; in f32
both are register-tiled on the CUDA cores (every product an f32 FMA, no
TF32), stage 2 a persistent SGEMM with one 32-column group's weights
resident. The kernels take heads of d = 8, 16 or 32 channels (a template on
d; stage 2 works in groups of 32 columns, 32 / d heads each, with a softmax
a head in its epilogue) and C = h d a multiple of 16, which the wrapper
checks on every device. The wrapper takes the plain version for a tensor on
the CPU only; a CUDA tensor launches the kernel or raises.

Under autograd the card's path is ``_TrajectoryAttentionCore``, a
``torch.autograd.Function`` (the port of the JAX package's custom VJP of
``fused_trajectory_attention``): its forward launches K3; its backward
recomputes ``trajectory_attention_core_plain`` from the saved inputs (the
stage-2 weights in their own dtypes, so f32 master weights get f32
gradients) and returns that function's VJP. The kernel's two workspaces are
not saved.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import native

#: the kernels' limits: head dims, frames, heads, and the shared memory one
#: block may use on sm_90. Head dims: the WC and Tube-Link layers run 32, the
#: overfit tools' modules 8 and 16 (``csrc/traj.cu`` instantiates each);
#: C = h d must be a multiple of ``CHANNEL_MULTIPLE`` on every device (the
#: kernels' TMA row pitch and 16-column steps). Frames: the within-clip and
#: Tube-Link layers run 2-5, the cross-clip module one a clip of the video
#: (``csrc/traj.cu``'s ``MAX_F``)
KERNEL_HEAD_DIMS = (8, 16, 32)
CHANNEL_MULTIPLE = 16
KERNEL_MAX_FRAMES = 256
KERNEL_MAX_HEADS = 8
MAX_SHARED_BYTES = 232448
#: the dtypes the CUDA kernel takes: bf16 (tensor cores) or f32 (kernels of
#: their own with every product an f32 FMA on the CUDA cores, no TF32)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
#: bound on |kernel - plain| in bf16 ulps of max|out|. Both round at the
#: same points but sum in another order (and the bf16 kernel takes the
#: spatial probabilities as e * (1 / sum), within an f32 ulp of e / sum), so
#: a cast may round the other way:
#: the output cast by 1 ulp of its value, and a flipped x, q2, k2 or v2
#: element moves the f32 sum before that cast by much less than 1 ulp (it
#: enters a convex combination, or one of 256 products). 2 ulp leaves room
#: for both; it is 2^-6 of max|out| at most.
TRAJ_ULPS = 2
#: the profiler range of K3's backward (the plain version's VJP)
BACKWARD_RANGE = "K3 backward (plain VJP)"


def trajectory_attention_core_plain(q, k, v, wq, bq, wkv, bkv,
                                    num_frames: int, num_heads: int):
    """Same contract as ``trajectory_attention_core``: f32 products, the
    TPU kernel's casts to q's dtype."""
    b, nt, c = q.shape
    f, h = num_frames, num_heads
    n, d = nt // f, c // h
    scale = d ** -0.5
    dt = q.dtype

    # stage 1: spatial softmax per frame -> per-frame aggregation
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float().reshape(b, nt, h, d),
                          k.float().reshape(b, nt, h, d))
    attn = F.softmax(scale * logits.reshape(b, h, nt, f, n), -1).to(dt)
    traj = torch.einsum("bhqfn,bfnhd->bqfhd", attn.float(),
                        v.float().reshape(b, f, n, h, d)).to(dt)
    x = traj.reshape(b, nt, f, c)

    # stage 2: the query is token s of frame g's own-frame aggregation
    x_diag = torch.diagonal(x.reshape(b, f, n, f, c), dim1=1, dim2=3)
    x_diag = x_diag.permute(0, 3, 1, 2).reshape(b, nt, c)
    q2 = (x_diag.float() @ wq.float().T).to(dt) + bq.to(dt)
    kv2 = (x.float() @ wkv.float().T).to(dt) + bkv.to(dt)
    k2, v2 = kv2.chunk(2, dim=-1)
    q2 = (q2 * scale).float().reshape(b, nt, h, d)
    t_logits = torch.einsum("bshd,bsfhd->bshf", q2,
                            k2.float().reshape(b, nt, f, h, d))
    t_attn = F.softmax(t_logits, -1)
    out = torch.einsum("bshf,bsfhd->bshd", t_attn,
                       v2.float().reshape(b, nt, f, h, d))
    return out.reshape(b, nt, c).to(dt)


def trajectory_attention_core(q, k, v, wq, bq, wkv, bkv, num_frames: int,
                              num_heads: int):
    """q, k, v (B, N, C) after their projections, tokens frame-major
    (N = num_frames * n); wq (C, C), bq (C,), wkv (2C, C), bkv (2C,): the
    ``proj_q`` and ``proj_kv`` Linear parameters in torch's (out, in)
    layout; on the card q, k, v are all bf16 or all f32. Returns (B, N, C)
    in q's dtype, before the output projection."""
    b, nt, c = q.shape
    f, h = int(num_frames), int(num_heads)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} differ")
    if f <= 0 or nt % f or c % h:
        raise ValueError(f"N={nt} tokens, C={c}: not {f} frames of whole "
                         f"rows, or not {h} whole heads")
    if (wq.shape != (c, c) or bq.shape != (c,) or wkv.shape != (2 * c, c)
            or bkv.shape != (2 * c,)):
        raise ValueError("stage-2 weights do not match C")
    if c % CHANNEL_MULTIPLE:
        raise ValueError(f"C={c}: K3 takes C a multiple of {CHANNEL_MULTIPLE}")
    if native.on_cpu([q, k, v]):
        return trajectory_attention_core_plain(q, k, v, wq, bq, wkv, bkv, f, h)
    dt = q.dtype
    for t in (q, k, v):
        if t.dtype not in KERNEL_DTYPES or t.dtype != dt:
            raise TypeError("the CUDA kernel takes q, k, v all bf16 or all "
                            f"f32, got {q.dtype} / {k.dtype} / {v.dtype}")
        if not t.is_contiguous():
            raise ValueError("q, k, v must be contiguous")
    if (c // h not in KERNEL_HEAD_DIMS or h > KERNEL_MAX_HEADS
            or f > KERNEL_MAX_FRAMES):
        raise ValueError(f"the CUDA kernel takes head dims {KERNEL_HEAD_DIMS}, "
                         f"at most {KERNEL_MAX_HEADS} heads and "
                         f"{KERNEL_MAX_FRAMES} frames; got d={c // h}, h={h}, "
                         f"f={f}")
    suffix = "" if dt == torch.bfloat16 else "_f32"
    smem = getattr(native.library(), "axvs_traj_smem_bytes" + suffix)(
        nt // f, f, h, c // h)
    if not 0 < smem <= MAX_SHARED_BYTES:
        raise ValueError(f"n={nt // f} tokens per frame at f={f} need {smem} B "
                         f"of shared memory, more than {MAX_SHARED_BYTES}")
    weights = (wq, bq, wkv, bkv)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, *weights)):
        return _TrajectoryAttentionCore.apply(q, k, v, *weights, f, h)
    return _launch(q, k, v, *weights, f, h)


def _launch(q, k, v, wq, bq, wkv, bkv, f: int, h: int):
    """K3 on checked card tensors; counts the launch. The stage-2 weights
    are cast to q's dtype (no-ops for matrices kept in it at rest)."""
    b, nt, c = q.shape
    dt = q.dtype
    wq, bq, wkv, bkv = (t.detach().to(device=q.device, dtype=dt).contiguous()
                        for t in (wq, bq, wkv, bkv))
    tensors = (q, k, v, wq, bq, wkv, bkv)
    if any(t.data_ptr() % 32 for t in tensors):
        raise ValueError("the CUDA kernel needs 32-byte aligned tensors")
    suffix = "" if dt == torch.bfloat16 else "_f32"
    out = torch.empty_like(q)
    scale = float((c // h) ** -0.5)
    x_ws = torch.empty(f, b * nt, c, dtype=dt, device=q.device)
    xd_ws = torch.empty(b * nt, c, dtype=dt, device=q.device)
    native.launch("axvs_traj_fwd" + suffix, *(t.data_ptr() for t in tensors),
                  out.data_ptr(), x_ws.data_ptr(), xd_ws.data_ptr(), b, nt, f, h,
                  c // h, scale, device=q.device)
    trajectory_attention_core.launches += 1
    return out


class _TrajectoryAttentionCore(torch.autograd.Function):
    """K3 forward; backward = the VJP of ``trajectory_attention_core_plain``,
    recomputed from the saved inputs (as ``_fta_bwd`` takes the VJP of
    ``_traj_math``)."""

    @staticmethod
    def forward(ctx, q, k, v, wq, bq, wkv, bkv, f, h):
        ctx.save_for_backward(q, k, v, wq, bq, wkv, bkv)
        ctx.fh = (f, h)
        return _launch(q, k, v, wq, bq, wkv, bkv, f, h)

    @staticmethod
    def backward(ctx, grad_out):
        f, h = ctx.fh
        return (*native.plain_vjp(
            lambda *a: trajectory_attention_core_plain(*a, f, h),
            ctx.saved_tensors, grad_out, BACKWARD_RANGE), None, None)


#: kernel launches since the count was last set to 0
trajectory_attention_core.launches = 0
