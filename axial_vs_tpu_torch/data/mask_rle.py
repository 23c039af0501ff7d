"""COCO-compatible run-length mask codec (counterpart of
``axial_vs_tpu/data/mask_rle.py``; numpy only, no pycocotools).

Format (the public COCO spec): masks are run-length encoded in column-major
(Fortran) order starting with the count of zeros; compressed strings pack
counts as base-6-bit LEB128-style chars offset by 48, with counts[i]
(i > 2) stored as the difference from counts[i-2].
"""
from __future__ import annotations

import numpy as np


def mask_to_rle_counts(mask: np.ndarray) -> list[int]:
    """(H, W) {0,1} -> uncompressed counts (column-major). The changes of
    the column-major order are found without its transposed copy: down
    each column (row r + 1 against row r) and across each column's end
    (row 0 of column c + 1 against row H - 1 of column c)."""
    m = np.asarray(mask, np.uint8)
    if m.ndim != 2:  # one column: its order is the array's column-major one
        m = m.reshape(-1, 1, order="F")
    h, w = m.shape
    n = h * w
    if n == 0:
        return [0]
    r, c = np.divmod(np.flatnonzero(m[1:] != m[:-1]), w)
    across = np.flatnonzero(m[0, 1:] != m[-1, :-1])
    change = np.sort(np.concatenate([c * h + r + 1, (across + 1) * h]))
    runs = np.diff(np.concatenate([[0], change, [n]])).tolist()
    if m[0, 0] == 1:
        runs = [0] + runs
    return runs


def rle_counts_to_mask(counts, shape) -> np.ndarray:
    h, w = shape
    runs = np.repeat((np.arange(len(counts)) & 1).astype(np.uint8),
                     np.asarray(counts, np.int64))
    flat = np.zeros(h * w, np.uint8)
    flat[:min(runs.size, flat.size)] = runs[:flat.size]
    return flat.reshape((h, w), order="F")


def rle_encode_string(counts) -> str:
    """counts -> compressed char string (pycocotools rleToString): each
    count (less the one two before it, past the third) in 5-bit groups,
    low first, 0x20 on every group but the last, which ends where the rest
    is the sign extension of its bit 0x10. All counts a step at a time."""
    x = np.array(counts, np.int64)
    x[3:] -= np.array(counts[1:-2], np.int64)
    chars, emitted = [], []
    active = np.ones(x.size, bool)
    while active.any():
        c = x & 0x1F
        x >>= 5
        sign = (c & 0x10) != 0
        more = ~(((x == -1) & sign) | ((x == 0) & ~sign))
        chars.append(np.where(more, c | 0x20, c) + 48)
        emitted.append(active.copy())
        active &= more
    if not chars:
        return ""
    return np.stack(chars, 1)[np.stack(emitted, 1)].astype(np.uint8).tobytes(
        ).decode("ascii")


def rle_decode_string(s) -> list[int]:
    """compressed string -> counts (pycocotools rleFrString): the 5-bit
    groups of each count summed in place, the sign extended from the last
    group's 0x10, then each count past the third plus the one two before
    it (a running sum along each parity)."""
    if isinstance(s, str):
        s = s.encode("ascii")
    b = np.frombuffer(s, np.uint8).astype(np.int64) - 48
    if b.size == 0:
        return []
    last = np.flatnonzero((b & 0x20) == 0)  # each count's last group
    first = np.concatenate([[0], last[:-1] + 1])
    groups = last - first + 1
    shift = 5 * (np.arange(b.size) - np.repeat(first, groups))
    x = np.add.reduceat((b & 0x1F) << shift, first)
    x = np.where((b[last] & 0x10) != 0, x | (-1 << (5 * groups)), x)
    x[2::2] = np.cumsum(x[2::2])
    x[1::2] = np.cumsum(x[1::2])
    return x.tolist()


def decode(rle: dict) -> np.ndarray:
    """{'size': [h, w], 'counts': str|bytes|list} -> (H, W) uint8."""
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = rle_decode_string(counts)
    return rle_counts_to_mask(counts, rle["size"])


def encode(mask: np.ndarray) -> dict:
    return {
        "size": list(mask.shape),
        "counts": rle_encode_string(mask_to_rle_counts(mask)),
    }


def area(rle: dict) -> int:
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = rle_decode_string(counts)
    return int(sum(counts[1::2]))


def iou_rle(a: dict, b: dict) -> float:
    ma, mb = decode(a), decode(b)
    inter = int(np.logical_and(ma, mb).sum())
    union = int(np.logical_or(ma, mb).sum())
    return inter / union if union else 0.0
