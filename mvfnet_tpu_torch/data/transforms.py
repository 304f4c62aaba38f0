"""Spatial/format transforms for the host-side data pipeline (counterpart of
``mvfnet_tpu/data/transforms.py``, the same ops on numpy + cv2).

Behavior-parity rebuild of the reference pipeline vocabulary
(``codes/datasets/pipelines/augmentations.py`` and
``formating.py``) on plain numpy + cv2 (no mmcv). Images flow through as
HWC uint8 BGR (cv2 convention, like the reference) until Normalize.

Key behavioral notes:
- ``Resize(scale=(inf, 256), keep_ratio=True)`` rescales the short side to
  256 using mmcv's rounding (``int(dim * factor + 0.5)``), bilinear.
- ``ThreeCrop`` produces crop-major frame order: [crop0 frames..., crop1
  frames..., crop2 frames...] (``augmentations.py:514-529``) — the model's
  clip regrouping depends on this order.
- ``FormatShape`` supports the channels-last 'NHWC'/'NTHWC' layouts in addition
  to the reference's 'NCHW'/'NCTHW'; NHWC needs no per-image transpose.
- Random ops draw from ``results['rng']`` (a ``numpy.random.Generator``)
  when present, else a module default — reference used global
  random/np.random state.
"""

from __future__ import annotations

import math
from typing import Tuple

import cv2
import numpy as np

from .builder import PIPELINES

_DEFAULT_RNG = np.random.default_rng()


def _rng(results) -> np.random.Generator:
    return results.get('rng') or _DEFAULT_RNG


# ---------------------------------------------------------------- cv2 helpers

_INTERP = {'nearest': cv2.INTER_NEAREST, 'bilinear': cv2.INTER_LINEAR,
           'bicubic': cv2.INTER_CUBIC, 'area': cv2.INTER_AREA,
           'lanczos': cv2.INTER_LANCZOS4}


def imresize(img: np.ndarray, size_wh: Tuple[int, int],
             interpolation: str = 'bilinear') -> np.ndarray:
    """mmcv.imresize: size is (w, h)."""
    return cv2.resize(img, size_wh, interpolation=_INTERP[interpolation])


def rescale_size(old_wh: Tuple[int, int], scale) -> Tuple[int, int, float]:
    """mmcv.rescale_size semantics: scale is a number, or a (long, short)
    max-edge tuple (np.inf allowed)."""
    w, h = old_wh
    if isinstance(scale, (float, int)) and not isinstance(scale, bool):
        scale_factor = float(scale)
    else:
        max_long_edge = max(scale)
        max_short_edge = min(scale)
        scale_factor = min(max_long_edge / max(h, w),
                           max_short_edge / min(h, w))
    new_w = int(w * scale_factor + 0.5)
    new_h = int(h * scale_factor + 0.5)
    return new_w, new_h, scale_factor


def imrescale(img: np.ndarray, scale,
              interpolation: str = 'bilinear') -> Tuple[np.ndarray, float]:
    h, w = img.shape[:2]
    new_w, new_h, factor = rescale_size((w, h), scale)
    return imresize(img, (new_w, new_h), interpolation), factor


def imcrop(img: np.ndarray, box: np.ndarray) -> np.ndarray:
    """mmcv.imcrop with inclusive [x1, y1, x2, y2], clipped to bounds."""
    x1, y1, x2, y2 = [int(v) for v in box]
    h, w = img.shape[:2]
    x1, x2 = max(x1, 0), min(x2, w - 1)
    y1, y2 = max(y1, 0), min(y2, h - 1)
    return np.ascontiguousarray(img[y1:y2 + 1, x1:x2 + 1])


def imflip(img: np.ndarray, direction: str = 'horizontal') -> np.ndarray:
    if direction == 'horizontal':
        return np.ascontiguousarray(img[:, ::-1])
    return np.ascontiguousarray(img[::-1])


def iminvert(img: np.ndarray) -> np.ndarray:
    return np.full_like(img, 255) - img


# ------------------------------------------------------------------ pipeline


@PIPELINES.register_module
class Resize:
    """Resize (augmentations.py:12-67): keep_ratio -> imrescale else fixed."""

    def __init__(self, scale, keep_ratio: bool = True,
                 interpolation: str = 'bilinear'):
        self.scale = tuple(scale) if isinstance(scale, (list, tuple)) \
            else scale
        self.keep_ratio = keep_ratio
        self.interpolation = interpolation

    def __call__(self, results):
        img_group = results['img_group']
        if self.keep_ratio:
            pairs = [imrescale(img, self.scale, self.interpolation)
                     for img in img_group]
            img_group = [p[0] for p in pairs]
            scale_factor = pairs[0][1]
        else:
            size_wh = (int(self.scale[0]), int(self.scale[1]))
            img_group = [imresize(img, size_wh, self.interpolation)
                         for img in img_group]
            scale_factor = None
        results['img_group'] = img_group
        results['img_shape'] = img_group[0].shape
        results['keep_ratio'] = self.keep_ratio
        results['scale_factor'] = scale_factor
        return results


@PIPELINES.register_module
class CenterCrop:
    """augmentations.py:427-462."""

    def __init__(self, crop_size=224):
        self.crop_size = (crop_size, crop_size) if isinstance(crop_size, int)\
            else tuple(crop_size)

    def __call__(self, results):
        img_group = results['img_group']
        img_h, img_w = img_group[0].shape[:2]
        crop_w, crop_h = self.crop_size
        x1 = (img_w - crop_w) // 2
        y1 = (img_h - crop_h) // 2
        box = np.array([x1, y1, x1 + crop_w - 1, y1 + crop_h - 1])
        results['img_group'] = [imcrop(img, box) for img in img_group]
        results['crop_bbox'] = box
        results['img_shape'] = results['img_group'][0].shape
        return results


@PIPELINES.register_module
class ThreeCrop:
    """3 crops along the long side at full short-side resolution
    (augmentations.py:465-535). Output frame order is crop-major."""

    def __init__(self, crop_size):
        self.crop_size = (crop_size, crop_size) if isinstance(crop_size, int)\
            else tuple(crop_size)

    def __call__(self, results):
        img_group = results['img_group']
        img_h, img_w = img_group[0].shape[:2]
        crop_w, crop_h = self.crop_size
        if crop_h == img_h:
            w_step = (img_w - crop_w) // 2
            offsets = [(0, 0), (2 * w_step, 0), (w_step, 0)]
        elif crop_w == img_w:
            h_step = (img_h - crop_h) // 2
            offsets = [(0, 0), (0, 2 * h_step), (0, h_step)]
        else:
            w_step = (img_w - crop_w) // 4
            h_step = (img_h - crop_h) // 4
            offsets = [(0, 2 * h_step), (4 * w_step, 2 * h_step),
                       (2 * w_step, 2 * h_step)]
        out = []
        for o_w, o_h in offsets:
            for img in img_group:
                out.append(imcrop(img, np.array(
                    [o_w, o_h, o_w + crop_w - 1, o_h + crop_h - 1])))
        results['img_group'] = out
        results['crop_bbox'] = None
        results['img_shape'] = out[0].shape
        return results


@PIPELINES.register_module
class TenCrop:
    """5 fixed corner/center crops + horizontal flips
    (augmentations.py:543-591). Order: [crop frames..., flipped frames...] x5."""

    def __init__(self, crop_size=224):
        self.crop_size = (crop_size, crop_size) if isinstance(crop_size, int)\
            else tuple(crop_size)

    def __call__(self, results):
        img_group = results['img_group']
        img_h, img_w = img_group[0].shape[:2]
        crop_w, crop_h = self.crop_size
        offsets = MultiScaleCrop.fill_fix_offset(False, img_w, img_h,
                                                 crop_w, crop_h)
        out = []
        for o_w, o_h in offsets:
            normal, flipped = [], []
            for i, img in enumerate(img_group):
                crop = imcrop(img, np.array(
                    [o_w, o_h, o_w + crop_w - 1, o_h + crop_h - 1]))
                normal.append(crop)
                fc = imflip(crop)
                if results.get('modality') == 'Flow' and i % 2 == 0:
                    fc = iminvert(fc)
                flipped.append(fc)
            out.extend(normal)
            out.extend(flipped)
        results['img_group'] = out
        results['crop_bbox'] = None
        results['img_shape'] = out[0].shape
        return results


@PIPELINES.register_module
class MultiScaleCrop:
    """TSN-style fixed-offset multi-scale crop (augmentations.py:70-192)."""

    def __init__(self, input_size, scales=None, max_distort=1,
                 fix_crop=True, more_fix_crop=True):
        self.input_size = (input_size, input_size) \
            if isinstance(input_size, int) else tuple(input_size)
        self.scales = scales if scales is not None else [1, .875, .75, .66]
        self.max_distort = max_distort
        self.fix_crop = fix_crop
        self.more_fix_crop = more_fix_crop

    @staticmethod
    def fill_fix_offset(more_fix_crop, image_w, image_h, crop_w, crop_h):
        w_step = (image_w - crop_w) // 4
        h_step = (image_h - crop_h) // 4
        ret = [(0, 0), (4 * w_step, 0), (0, 4 * h_step),
               (4 * w_step, 4 * h_step), (2 * w_step, 2 * h_step)]
        if more_fix_crop:
            ret += [(0, 2 * h_step), (4 * w_step, 2 * h_step),
                    (2 * w_step, 4 * h_step), (2 * w_step, 0),
                    (1 * w_step, 1 * h_step), (3 * w_step, 1 * h_step),
                    (1 * w_step, 3 * h_step), (3 * w_step, 3 * h_step)]
        return ret

    def _sample_crop_size(self, im_size, rng):
        image_w, image_h = im_size
        base_size = min(image_w, image_h)
        crop_sizes = [int(base_size * x) for x in self.scales]
        crop_h = [self.input_size[1] if abs(x - self.input_size[1]) < 3
                  else x for x in crop_sizes]
        crop_w = [self.input_size[0] if abs(x - self.input_size[0]) < 3
                  else x for x in crop_sizes]
        pairs = [(w, h) for i, h in enumerate(crop_h)
                 for j, w in enumerate(crop_w)
                 if abs(i - j) <= self.max_distort]
        crop_pair = pairs[int(rng.integers(0, len(pairs)))]
        if not self.fix_crop:
            w_offset = int(rng.integers(0, image_w - crop_pair[0] + 1))
            h_offset = int(rng.integers(0, image_h - crop_pair[1] + 1))
        else:
            offsets = self.fill_fix_offset(self.more_fix_crop, image_w,
                                           image_h, crop_pair[0],
                                           crop_pair[1])
            w_offset, h_offset = offsets[int(rng.integers(0, len(offsets)))]
        return crop_pair, (w_offset, h_offset)

    def __call__(self, results):
        img_group = results['img_group']
        img_h, img_w = img_group[0].shape[:2]
        (crop_w, crop_h), (o_w, o_h) = self._sample_crop_size(
            (img_w, img_h), _rng(results))
        box = np.array([o_w, o_h, o_w + crop_w - 1, o_h + crop_h - 1])
        results['img_group'] = [
            imresize(imcrop(img, box), self.input_size)
            for img in img_group]
        results['crop_bbox'] = box
        results['img_shape'] = results['img_group'][0].shape
        results['scales'] = self.scales
        return results


@PIPELINES.register_module
class RandomResizedCrop:
    """Inception-style area/aspect crop -> resize (augmentations.py:600-668).

    Uses the standard (torchvision) height/width convention; the reference's
    implementation swaps H/W in its bounds checks (``augmentations.py:635-637``)
    which merely skews the sampling distribution — outputs are equivalent
    augmentation draws.
    """

    def __init__(self, input_size, scale=(0.08, 1.0),
                 ratio=(3. / 4., 4. / 3.)):
        self.input_size = (input_size, input_size) \
            if isinstance(input_size, int) else tuple(input_size)
        self.scale = scale
        self.ratio = ratio

    def get_params(self, img, rng):
        height, width = img.shape[:2]
        area = height * width
        for _ in range(10):
            target_area = rng.uniform(*self.scale) * area
            aspect_ratio = rng.uniform(*self.ratio)
            w = int(round(math.sqrt(target_area * aspect_ratio)))
            h = int(round(math.sqrt(target_area / aspect_ratio)))
            if rng.random() < 0.5:
                w, h = h, w
            if w <= width and h <= height:
                x1 = int(rng.integers(0, width - w + 1))
                y1 = int(rng.integers(0, height - h + 1))
                return x1, y1, w, h
        # fallback: center square
        s = min(height, width)
        return (width - s) // 2, (height - s) // 2, s, s

    def __call__(self, results):
        img_group = results['img_group']
        x1, y1, w, h = self.get_params(img_group[0], _rng(results))
        box = np.array([x1, y1, x1 + w - 1, y1 + h - 1])
        results['img_group'] = [imresize(imcrop(img, box), self.input_size)
                                for img in img_group]
        results['crop_bbox'] = box
        results['img_shape'] = results['img_group'][0].shape
        return results


@PIPELINES.register_module
class RandomRescaledCrop:
    """SlowFast-style: random short-edge in ``scale``, then random crop
    (augmentations.py:671-707)."""

    def __init__(self, input_size, scale=(256, 320)):
        self.input_size = (input_size, input_size) \
            if isinstance(input_size, int) else tuple(input_size)
        self.scale = scale

    def __call__(self, results):
        rng = _rng(results)
        img_group = results['img_group']
        shortedge = float(rng.integers(self.scale[0], self.scale[1] + 1))
        h, w = img_group[0].shape[:2]
        factor = max(shortedge / h, shortedge / w)
        img_group = [imrescale(img, factor)[0] for img in img_group]
        h, w = img_group[0].shape[:2]
        y_off = int(rng.integers(0, h - self.input_size[1] + 1))
        x_off = int(rng.integers(0, w - self.input_size[0] + 1))
        results['img_group'] = [
            img[y_off: y_off + self.input_size[1],
                x_off: x_off + self.input_size[0]] for img in img_group]
        results['crop_bbox'] = np.array(
            [x_off, y_off, x_off + self.input_size[0] - 1,
             y_off + self.input_size[1] - 1], dtype=np.float32)
        results['img_shape'] = results['img_group'][0].shape
        return results


@PIPELINES.register_module
class Flip:
    """Probability flip; Flow x-channels inverted (augmentations.py:195-228)."""

    def __init__(self, flip_ratio=0.5, direction='horizontal'):
        assert direction in ['horizontal', 'vertical']
        self.flip_ratio = flip_ratio
        self.direction = direction

    def __call__(self, results):
        rng = _rng(results)
        flip = bool(rng.random() < self.flip_ratio)
        img_group = results['img_group']
        if flip:
            img_group = [imflip(img, self.direction) for img in img_group]
        if results.get('modality') == 'Flow':
            for i in range(0, len(img_group), 2):
                img_group[i] = iminvert(img_group[i])
        results['flip'] = flip
        results['flip_direction'] = self.direction
        results['img_group'] = img_group
        return results


@PIPELINES.register_module
class ColorJitter:
    """Brightness/contrast/saturation/hue + PCA lighting noise
    (augmentations.py:237-333). BGR inputs in [0, 255]."""

    def __init__(self, color_space_aug=False, alphastd=0.1,
                 eigval=None, eigvec=None):
        self.eigval = np.array(eigval if eigval is not None
                               else [55.46, 4.794, 1.148])
        self.eigvec = np.array(eigvec if eigvec is not None else
                               [[-0.5675, 0.7192, 0.4009],
                                [-0.5808, -0.0045, -0.8140],
                                [-0.5836, -0.6948, 0.4203]])
        self.alphastd = alphastd
        self.color_space_aug = color_space_aug

    @staticmethod
    def saturation(img, alpha):
        gray = img * np.array([0.299, 0.587, 0.114], dtype=np.float32)
        gray = np.sum(gray, 2, keepdims=True) * (1.0 - alpha)
        return img * alpha + gray

    @staticmethod
    def hue(img, alpha):
        u = np.cos(alpha * np.pi)
        v = np.sin(alpha * np.pi)
        bt = np.array([[1.0, 0.0, 0.0], [0.0, u, -v], [0.0, v, u]])
        tyiq = np.array([[0.299, 0.587, 0.114],
                         [0.596, -0.274, -0.321],
                         [0.211, -0.523, 0.311]])
        ityiq = np.array([[1.0, 0.956, 0.621],
                          [1.0, -0.272, -0.647],
                          [1.0, -1.107, 1.705]])
        t = np.dot(np.dot(ityiq, bt), tyiq).T.astype(np.float32)
        return np.dot(img, t)

    def __call__(self, results):
        rng = _rng(results)
        img_group = [np.float32(img) for img in results['img_group']]
        if self.color_space_aug:
            bright_delta = rng.uniform(-32, 32)
            contrast_alpha = rng.uniform(0.6, 1.4)
            saturation_alpha = rng.uniform(0.6, 1.4)
            hue_alpha = rng.uniform(-18, 18)
            out = []
            for img in img_group:
                if rng.random() > 0.5:
                    img = img + np.float32(bright_delta)
                if rng.random() > 0.5:
                    ops = [lambda im: im * np.float32(contrast_alpha),
                           lambda im: self.saturation(im, saturation_alpha),
                           lambda im: self.hue(im, hue_alpha)]
                else:
                    ops = [lambda im: self.saturation(im, saturation_alpha),
                           lambda im: self.hue(im, hue_alpha),
                           lambda im: im * np.float32(contrast_alpha)]
                for op in ops:
                    if rng.random() > 0.5:
                        img = op(img)
                out.append(img)
            img_group = out
        alpha = rng.normal(0, self.alphastd, size=(3,))
        rgb = np.array(np.dot(self.eigvec * alpha, self.eigval),
                       dtype=np.float32)
        bgr = rgb[::-1][None, None, :]
        results['img_group'] = [img + bgr for img in img_group]
        return results


@PIPELINES.register_module
class Normalize:
    """(x - mean) / std with optional /255 and BGR->RGB
    (augmentations.py:342-390).

    ``device=True`` defers the arithmetic to the GPU: frames stay uint8
    through collation and the host-to-device copy (4x fewer bytes and less
    host RAM), and the eval/train step applies the same normalization on
    the device (see ``ops/normalize.py``).
    """

    def __init__(self, mean, std, div_255=False, to_rgb=False,
                 device=False):
        self.mean = np.array(mean, dtype=np.float32)
        self.std = np.array(std, dtype=np.float32)
        self.div_255 = div_255
        self.to_rgb = to_rgb
        self.device = device

    def _normalize(self, img):
        img = np.float32(img)
        if self.to_rgb and img.ndim == 3 and img.shape[2] == 3:
            img = img[..., ::-1]
        return (img - self.mean) / self.std

    def __call__(self, results):
        cfg = dict(mean=self.mean, std=self.std, div_255=self.div_255,
                   to_rgb=self.to_rgb, device=self.device)
        results['img_norm_cfg'] = cfg
        if self.device:
            # annotate only; frames remain uint8 for the device to consume
            return results
        img_group = results['img_group']
        if self.div_255:
            img_group = [np.float32(img) / 255 for img in img_group]
        results['img_group'] = [self._normalize(img) for img in img_group]
        return results


@PIPELINES.register_module
class Pad:
    """Pad bottom/right so edges are multiples of ``divisor``
    (augmentations.py:399-419)."""

    def __init__(self, divisor):
        self.divisor = divisor

    def __call__(self, results):
        out = []
        for img in results['img_group']:
            h, w = img.shape[:2]
            ph = (self.divisor - h % self.divisor) % self.divisor
            pw = (self.divisor - w % self.divisor) % self.divisor
            pad = [(0, ph), (0, pw)] + [(0, 0)] * (img.ndim - 2)
            out.append(np.pad(img, pad))
        results['img_group'] = out
        return results


@PIPELINES.register_module
class FormatShape:
    """Stack the image list into the model's input array
    (formating.py:133-185).

    input_format:
      'NHWC'  -> (M, H, W, C)         [channels-last default]
      'NTHWC' -> (M', T, H, W, C)     [channels-last 3-D]
      'NCHW'  -> (M, C, H, W)         [reference compat]
      'NCTHW' -> (M', C, T, H, W)     [reference compat]
    Flow frames (x/y grayscale pairs) become channel pairs. For the NHWC
    layouts, the stacked-modality channel fold (5 flow pairs -> 10 channels
    / 5 RGB diffs -> 15 channels) that the reference model performs as a
    free NCHW reshape (``recognizer2d.py:137``) is applied here explicitly
    — in channels-last it is a transpose, not a reshape.
    """

    MODALITY_LENGTH = 5  # frames folded per segment (recognizer2d.py:31-36)

    def __init__(self, input_format='NHWC'):
        assert input_format in ['NHWC', 'NTHWC', 'NCHW', 'NCTHW']
        self.input_format = input_format

    def _fold_channels(self, arr: np.ndarray) -> np.ndarray:
        """(M, H, W, C) -> (M/L, H, W, L*C), frame-major channel order
        matching the NCHW reshape."""
        L = self.MODALITY_LENGTH
        m, h, w, c = arr.shape
        assert m % L == 0, (m, L)
        arr = arr.reshape(m // L, L, h, w, c).transpose(0, 2, 3, 1, 4)
        return arr.reshape(m // L, h, w, L * c)

    def __call__(self, results):
        img_group = results['img_group']
        modality = results.get('modality')
        if modality == 'Flow':
            assert img_group[0].ndim == 2
            img_group = [np.stack((fx, fy), axis=2) for fx, fy in
                         zip(img_group[0::2], img_group[1::2])]
        arr = np.stack(img_group, axis=0)       # (M, H, W, C)
        num_clips = results['num_clips']
        clip_len = results['clip_len']
        if self.input_format == 'NHWC':
            if modality in ('Flow', 'RGBDiff'):
                arr = self._fold_channels(arr)
        elif self.input_format == 'NTHWC':
            if clip_len == 1 and num_clips > 1:
                arr = arr.reshape((-1, num_clips) + arr.shape[1:])
            else:
                arr = arr.reshape((-1, clip_len) + arr.shape[1:])
        elif self.input_format == 'NCHW':
            arr = arr.transpose(0, 3, 1, 2)
        elif self.input_format == 'NCTHW':
            if clip_len == 1 and num_clips > 1:
                arr = arr.reshape((-1, num_clips) + arr.shape[1:])
                arr = arr.transpose(0, 4, 1, 2, 3)
            else:
                arr = arr.reshape((-1, clip_len) + arr.shape[1:])
                arr = arr.transpose(0, 4, 1, 2, 3)
        results['img_group'] = np.ascontiguousarray(arr)
        results['input_shape'] = arr.shape
        return results


@PIPELINES.register_module
class Collect:
    """Final dict assembly (formating.py:80-126). Meta is a plain dict (no
    DataContainer: batches are dicts of numpy arrays)."""

    def __init__(self, keys, meta_keys=('label', 'ori_shape', 'img_shape',
                                        'modality', 'img_norm_cfg')):
        self.keys = keys
        self.meta_keys = meta_keys

    def __call__(self, results):
        data = {}
        if len(self.meta_keys) != 0:
            data['img_meta'] = {k: results.get(k) for k in self.meta_keys}
        for key in self.keys:
            data[key] = results[key]
        return data


@PIPELINES.register_module
class ToTensor:
    """ndarray passthrough kept for config compatibility: the loader
    collates numpy and the step uploads it (reference formating.py:33-45
    converted to torch)."""

    def __init__(self, keys):
        self.keys = keys

    def __call__(self, results):
        for key in self.keys:
            results[key] = np.asarray(results[key])
        return results


@PIPELINES.register_module
class ImageToTensor:
    """HWC -> CHW ndarray (reference compat)."""

    def __init__(self, keys):
        self.keys = keys

    def __call__(self, results):
        for key in self.keys:
            results[key] = np.ascontiguousarray(
                results[key].transpose(2, 0, 1))
        return results


@PIPELINES.register_module
class Transpose:
    def __init__(self, keys, order):
        self.keys = keys
        self.order = order

    def __call__(self, results):
        for key in self.keys:
            results[key] = results[key].transpose(self.order)
        return results
