"""Camera-intrinsics bookkeeping for crops/resizes + image ops.

The port's copy of `bevgen_tpu/data/camera_geometry.py` (same arrays for
the same inputs); cv2 and PIL are imported inside the functions that use
them. Pure-numpy equivalents of the reference's `NusceneCamGeometry`
(nuscenes_helper.py:66-135), the per-camera square-crop rules
(argoverse.py:275-283) and the Argoverse normalization
(argoverse.py:158-161, util.py denormalize_tensor).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

ARGOVERSE_MEAN = np.array([0.4265, 0.4489, 0.4769], np.float32)
ARGOVERSE_STD = np.array([0.2053, 0.2206, 0.2578], np.float32)


class CamIntrinsicAdjust:
    """Track how crop+rescale augmentation changes K
    (NusceneCamGeometry, nuscenes_helper.py:66). `rescale_first` selects
    whether the crop offset is applied before or after scaling — the
    Argoverse loader uses crop-first (argoverse.py:186)."""

    def __init__(self, rescale_first: bool = True):
        self.x_scale = 0.0
        self.y_scale = 0.0
        self.top_crop = 0.0
        self.left_crop = 0.0
        self.rescale_first = rescale_first

    def set_scale(self, x_scale: float, y_scale: float):
        self.x_scale = x_scale
        self.y_scale = y_scale

    def set_crop(self, top: float, left: float):
        self.top_crop = top
        self.left_crop = left

    def apply(self, K: np.ndarray) -> np.ndarray:
        K = np.array(K, np.float64, copy=True)
        if self.rescale_first:
            K[0, 0] *= self.x_scale
            K[0, 2] *= self.x_scale
            K[1, 1] *= self.y_scale
            K[1, 2] *= self.y_scale
            K[1, 2] -= self.top_crop
            K[0, 2] -= self.left_crop
        else:
            K[1, 2] -= self.top_crop
            K[0, 2] -= self.left_crop
            K[0, 0] *= self.x_scale
            K[0, 2] *= self.x_scale
            K[1, 1] *= self.y_scale
            K[1, 2] *= self.y_scale
        return K.astype(np.float32)


def square_crop(img: np.ndarray, cam_name: str) -> np.ndarray:
    """Per-camera square-crop rules (argoverse.py:275-283). `img` is
    (h, w, 3); for ring_front_center the raw image arrives transposed
    (w, h, 3) and is un-transposed then cropped from the top.

    The front-left/right crops keep the half adjacent to the center
    camera (maximizing overlap). The reference raises for every other
    camera (argoverse.py:283 `raise Exception()` — its shipped config
    uses only the 3 front cams); the side/rear ring cameras of the
    7-cam rig get a CENTER crop here, the neutral extension."""
    h, w = img.shape[:2]
    if cam_name == "ring_front_left":
        return img[:, w - h:]
    if cam_name == "ring_front_right":
        return img[:, : -(w - h)]
    if cam_name == "ring_front_center":
        img = img.transpose(1, 0, 2)
        return img[(img.shape[0] - img.shape[1]):]
    if w > h:
        left = (w - h) // 2
        return img[:, left:left + h]
    if h > w:
        top = (h - w) // 2
        return img[top:top + w]
    return img


def square_crop_offsets(cam_name: str, h: int, w: int) -> Tuple[int, int]:
    """(top, left) pixel offsets the square crop introduces, for
    intrinsics adjustment. (h, w) is the RAW stored image shape."""
    if cam_name == "ring_front_left":
        return 0, w - h
    if cam_name == "ring_front_right":
        return 0, 0
    if cam_name == "ring_front_center":
        # transposed: original (h, w) swaps; crop from top
        return w - h, 0
    if w > h:
        return 0, (w - h) // 2
    if h > w:
        return (h - w) // 2, 0
    return 0, 0


# ---------------------------------------------------------------------------
# training-time augmentation (argoverse.py:123,186-217,271)
# ---------------------------------------------------------------------------

_LUMA = np.array([0.299, 0.587, 0.114], np.float32)


def color_jitter_params(rng: np.random.Generator, brightness: float = 0.1,
                        contrast: float = 0.1, saturation: float = 0.1,
                        hue: float = 0.1):
    """Draw one set of jitter parameters (torchvision
    ColorJitter.get_params semantics: random op order + uniform factors).
    The reference draws this ONCE per multi-camera sample and applies the
    same parameters to every camera in the rig (argoverse.py:271)."""
    return (rng.permutation(4),
            float(rng.uniform(1 - brightness, 1 + brightness)),
            float(rng.uniform(1 - contrast, 1 + contrast)),
            float(rng.uniform(1 - saturation, 1 + saturation)),
            float(rng.uniform(-hue, hue)))


def adjust_brightness(img01: np.ndarray, factor: float) -> np.ndarray:
    return np.clip(img01 * factor, 0.0, 1.0)


def adjust_contrast(img01: np.ndarray, factor: float) -> np.ndarray:
    mean = float((img01 @ _LUMA).mean())
    return np.clip(factor * img01 + (1.0 - factor) * mean, 0.0, 1.0)


def adjust_saturation(img01: np.ndarray, factor: float) -> np.ndarray:
    gray = (img01 @ _LUMA)[..., None]
    return np.clip(factor * img01 + (1.0 - factor) * gray, 0.0, 1.0)


def adjust_hue(img01: np.ndarray, factor: float) -> np.ndarray:
    """Shift hue by `factor` (in turns, [-0.5, 0.5])."""
    import cv2
    hsv = cv2.cvtColor(img01.astype(np.float32), cv2.COLOR_RGB2HSV)
    hsv[..., 0] = np.mod(hsv[..., 0] + factor * 360.0, 360.0)
    return np.clip(cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB), 0.0, 1.0)


def apply_color_jitter(img01: np.ndarray, params) -> np.ndarray:
    """Apply jitter params from color_jitter_params in their drawn order
    (reference process_img, argoverse.py:193-206)."""
    fn_idx, b, c, s, h = params
    for fn_id in fn_idx:
        if fn_id == 0:
            img01 = adjust_brightness(img01, b)
        elif fn_id == 1:
            img01 = adjust_contrast(img01, c)
        elif fn_id == 2:
            img01 = adjust_saturation(img01, s)
        else:
            img01 = adjust_hue(img01, h)
    return img01


def random_crop_params(rng: np.random.Generator, h: int, w: int,
                       scale_max: float) -> Tuple[int, int, int, int]:
    """(top, left, new_h, new_w): uniform scale in [1-scale_max, 1]
    applied to both dims, then a random crop position — the reference's
    crop augmentation (argoverse.py:207-213; scale_max 0.1 multi-camera,
    0.25 single-camera)."""
    scale = float(rng.uniform(1.0 - scale_max, 1.0))
    nh, nw = max(1, int(h * scale)), max(1, int(w * scale))
    top = int(rng.integers(0, h - nh + 1))
    left = int(rng.integers(0, w - nw + 1))
    return top, left, nh, nw


def augment_bev(rng: np.random.Generator, seg: np.ndarray,
                shift_limit: float = 0.001, scale_limit: float = 0.01,
                rotate_limit: float = 0.0, p_ssr: float = 0.5,
                p_flip: float = 0.5) -> np.ndarray:
    """BEV raster augmentation: shift/scale/rotate + horizontal flip —
    numpy/cv2 equivalent of the reference's albumentations pipeline
    (argoverse.py:114 multi-camera; :164 single-camera adds
    shift/scale 0.075 + rotate 10deg)."""
    import cv2
    h, w = seg.shape[:2]
    if rng.uniform() < p_ssr:
        dx = float(rng.uniform(-shift_limit, shift_limit)) * w
        dy = float(rng.uniform(-shift_limit, shift_limit)) * h
        s = 1.0 + float(rng.uniform(-scale_limit, scale_limit))
        ang = float(rng.uniform(-rotate_limit, rotate_limit))
        M = cv2.getRotationMatrix2D((w / 2.0, h / 2.0), ang, s)
        M[:, 2] += [dx, dy]
        out = np.empty_like(seg)
        for c0 in range(0, seg.shape[2], 4):  # warpAffine: <=4 channels
            # albumentations ShiftScaleRotate defaults: BILINEAR with
            # reflected borders, applied to the raster in its NATIVE
            # dtype (the reference transforms the raw uint8 npz and
            # floats it after, argoverse.py:252 — cv2's uint8 rounding
            # is part of the augmentation distribution)
            out[..., c0:c0 + 4] = cv2.warpAffine(
                np.ascontiguousarray(seg[..., c0:c0 + 4]), M, (w, h),
                flags=cv2.INTER_LINEAR,
                borderMode=cv2.BORDER_REFLECT_101).reshape(h, w, -1)
        seg = out
    if rng.uniform() < p_flip:
        seg = seg[:, ::-1].copy()
    return seg


def resize_bicubic(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    import cv2
    return cv2.resize(img, (out_hw[1], out_hw[0]),
                      interpolation=cv2.INTER_CUBIC)


def resize_bicubic_uint8(img: np.ndarray,
                         out_hw: Tuple[int, int]) -> np.ndarray:
    """PIL-exact uint8 bicubic resize: the reference resizes the uint8
    PIL image BEFORE to_tensor (argoverse.py:214-216), so eval/parity
    loads must reproduce PIL's bicubic kernel and its per-pixel uint8
    rounding — cv2's INTER_CUBIC uses a different spline coefficient
    and float resizing skips the rounding step entirely."""
    from PIL import Image
    pil = Image.fromarray(np.ascontiguousarray(img))
    return np.asarray(pil.resize((out_hw[1], out_hw[0]), Image.BICUBIC))


def normalize_image(img01: np.ndarray) -> np.ndarray:
    """[0,1] float image -> normalized (argoverse.py:158-161)."""
    return ((img01 - ARGOVERSE_MEAN) / ARGOVERSE_STD).astype(np.float32)


def denormalize_image(img: np.ndarray) -> np.ndarray:
    """Inverse of normalize_image, clipped to [0,1]
    (util.py denormalize_tensor)."""
    out = img * ARGOVERSE_STD + ARGOVERSE_MEAN
    return np.clip(out, 0.0, 1.0).astype(np.float32)
