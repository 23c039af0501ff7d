"""What the port's probe and bench tools share: the device check, the
timers and the bf16 tolerance unit."""
from __future__ import annotations

import math
import time

import torch


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    card is present (the tools run on the CPU only when asked)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "host")
    return device


def time_ms(fn, device, iters: int) -> float:
    """ms per call over ``iters`` back-to-back calls after one warm-up:
    CUDA events on the card, the host clock on the CPU."""
    fn()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def graph_ms(fn, device, iters: int):
    """Device ms per call without the host's launch cost: ``iters`` calls
    captured in one CUDA graph (after a warm-up call on a side stream), then
    one replay between CUDA events. None on the CPU. A wrapper counts each
    captured call once; the replays launch again uncounted."""
    if torch.device(device).type != "cuda":
        return None
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bf16_ulp(x: float) -> float:
    """One bf16 unit in the last place at magnitude x (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(x, 1e-30))) - 7)


def max_diff(got, want) -> tuple[float, float]:
    """(max |got - want|, max |want|), in f32."""
    want = want.float()
    return ((got.float() - want).abs().max().item(),
            want.abs().max().item())
