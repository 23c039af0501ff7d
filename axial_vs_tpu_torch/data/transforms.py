"""Clip-consistent augmentations in numpy (a copy of
``axial_vs_tpu/data/transforms.py``; outputs bit-identical to it).

The reference's augmentation recipe
(`vipseg_panoptic_maxtron_dataset_mapper.py:22-55`): ResizeScale ->
SSD-style color jitter -> RandomCrop -> RandomFlip, with parameters sampled
ONCE on the first frame of a clip and replayed on the rest (ref :170-177).

Each transform is a small object: ``sample(rng, hw)`` freezes parameters,
``apply_image`` / ``apply_segmentation`` replay them deterministically.
Images are channels-last uint8; segmentation maps use nearest resampling.
"""
from __future__ import annotations

import numpy as np

from ..ops.resize import resize_bilinear_np


def _resize_image(img: np.ndarray, hw, nearest=False) -> np.ndarray:
    h, w = hw
    if img.shape[:2] == (h, w):
        return img
    if nearest:
        ys = (np.arange(h) * img.shape[0] / h).astype(np.int64)
        xs = (np.arange(w) * img.shape[1] / w).astype(np.int64)
        return img[ys][:, xs]
    out = resize_bilinear_np(img.astype(np.float32), (h, w))
    return np.clip(out, 0, 255).astype(img.dtype) if img.dtype == np.uint8 else out


class ResizeScale:
    """Random scale in [min_scale, max_scale] of the target size, keeping
    aspect ratio (detectron2 T.ResizeScale semantics)."""

    def __init__(self, min_scale, max_scale, target_height, target_width):
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.target = (target_height, target_width)

    def sample(self, rng, hw):
        scale = rng.uniform(self.min_scale, self.max_scale)
        th, tw = self.target
        h, w = hw
        out_scale = min(scale * th / h, scale * tw / w)
        self._out_hw = (int(h * out_scale), int(w * out_scale))

    def apply_image(self, img):
        return _resize_image(img, self._out_hw)

    def apply_segmentation(self, seg):
        return _resize_image(seg, self._out_hw, nearest=True)


class ColorAugSSD:
    """SSD photometric distortion: brightness, contrast, saturation, hue —
    parameters frozen per clip."""

    def __init__(self, brightness_delta=32, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta=18):
        self.brightness_delta = brightness_delta
        self.contrast_range = contrast_range
        self.saturation_range = saturation_range
        self.hue_delta = hue_delta

    def sample(self, rng, hw):
        self._do_b = rng.rand() < 0.5
        self._b = rng.uniform(-self.brightness_delta, self.brightness_delta)
        self._contrast_first = rng.rand() < 0.5
        self._do_c = rng.rand() < 0.5
        self._c = rng.uniform(*self.contrast_range)
        self._do_s = rng.rand() < 0.5
        self._s = rng.uniform(*self.saturation_range)
        self._do_h = rng.rand() < 0.5
        self._h = rng.uniform(-self.hue_delta, self.hue_delta)

    def _brightness(self, img):
        return np.clip(img.astype(np.float32) + self._b, 0, 255) if self._do_b else img

    def _contrast(self, img):
        return np.clip(img.astype(np.float32) * self._c, 0, 255) if self._do_c else img

    def _saturation_hue(self, img):
        if not (self._do_s or self._do_h):
            return img
        # vectorized RGB->HSV->RGB
        x = np.asarray(img, np.float32) / 255.0
        maxc = x.max(-1)
        minc = x.min(-1)
        v = maxc
        s = np.where(maxc > 0, (maxc - minc) / np.maximum(maxc, 1e-8), 0)
        rc = (maxc - x[..., 0]) / np.maximum(maxc - minc, 1e-8)
        gc = (maxc - x[..., 1]) / np.maximum(maxc - minc, 1e-8)
        bc = (maxc - x[..., 2]) / np.maximum(maxc - minc, 1e-8)
        h = np.where(
            maxc == x[..., 0], bc - gc,
            np.where(maxc == x[..., 1], 2.0 + rc - bc, 4.0 + gc - rc),
        )
        h = (h / 6.0) % 1.0
        h = np.where(maxc == minc, 0.0, h)
        if self._do_s:
            s = np.clip(s * self._s, 0, 1)
        if self._do_h:
            h = (h + self._h / 360.0) % 1.0
        i = np.floor(h * 6.0)
        f = h * 6.0 - i
        p = v * (1 - s)
        q = v * (1 - s * f)
        t = v * (1 - s * (1 - f))
        i = i.astype(np.int32) % 6
        rgb = np.zeros_like(x)
        conds = [i == k for k in range(6)]
        comps = [
            (v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)
        ]
        for cond, (r_, g_, b_) in zip(conds, comps):
            rgb[..., 0] = np.where(cond, r_, rgb[..., 0])
            rgb[..., 1] = np.where(cond, g_, rgb[..., 1])
            rgb[..., 2] = np.where(cond, b_, rgb[..., 2])
        return np.clip(rgb * 255.0, 0, 255)

    def apply_image(self, img):
        out = img
        if self._contrast_first:
            out = self._contrast(out)
            out = self._brightness(out)
            out = self._saturation_hue(out)
        else:
            out = self._brightness(out)
            out = self._saturation_hue(out)
            out = self._contrast(out)
        return out.astype(np.uint8)

    def apply_segmentation(self, seg):
        return seg


class RandomCrop:
    """Absolute random crop to min(size, image size)."""

    def __init__(self, crop_size):
        self.crop_size = crop_size

    def sample(self, rng, hw):
        h, w = hw
        ch = min(self.crop_size[0], h)
        cw = min(self.crop_size[1], w)
        self._y0 = rng.randint(0, h - ch + 1)
        self._x0 = rng.randint(0, w - cw + 1)
        self._ch, self._cw = ch, cw

    def apply_image(self, img):
        return img[self._y0 : self._y0 + self._ch, self._x0 : self._x0 + self._cw]

    apply_segmentation = apply_image


class RandomFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def sample(self, rng, hw):
        self._flip = rng.rand() < self.prob

    def apply_image(self, img):
        return img[:, ::-1] if self._flip else img

    apply_segmentation = apply_image


class ClipTransform:
    """Samples every transform on the first frame's size, replays on all."""

    def __init__(self, transforms):
        self.transforms = transforms

    def sample(self, rng, hw):
        for t in self.transforms:
            t.sample(rng, hw)
            # chained transforms see the running output size
            probe = np.zeros(tuple(hw) + (3,), np.uint8)
            hw = t.apply_image(probe).shape[:2]

    def apply_image(self, img):
        for t in self.transforms:
            img = t.apply_image(img)
        return img

    def apply_segmentation(self, seg):
        for t in self.transforms:
            seg = t.apply_segmentation(seg)
        return seg


def build_train_transforms(image_size, min_scale, max_scale):
    return ClipTransform([
        ResizeScale(min_scale, max_scale, image_size[0], image_size[1]),
        ColorAugSSD(),
        RandomCrop((image_size[0], image_size[1])),
        RandomFlip(),
    ])
