"""RGB <-> id encoding of panoptic PNGs, panopticapi's ``rgb2id`` and
``id2rgb`` (counterpart of ``axial_vs_tpu/data/panoptic_utils.py``)."""
from __future__ import annotations

import numpy as np


def rgb2id(color: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W) int32: id = R + G*256 + B*256^2."""
    color = color.astype(np.int64)
    return (color[..., 0] + 256 * color[..., 1]
            + 256 * 256 * color[..., 2]).astype(np.int32)


def id2rgb(id_map: np.ndarray) -> np.ndarray:
    """(H, W) int -> (H, W, 3) uint8."""
    id_map = id_map.astype(np.int64)
    rgb = np.zeros(id_map.shape + (3,), np.uint8)
    rgb[..., 0] = id_map % 256
    rgb[..., 1] = (id_map // 256) % 256
    rgb[..., 2] = (id_map // (256 * 256)) % 256
    return rgb
