"""Lightweight image wrapper + helpers.

The port's copy of `bevgen_tpu/utils/image.py`, with PIL imported inside
the methods that use it. Equivalent surface of the author's external `image_utils.Im` package
(SURVEY §2.6: `.pil/.np`, `denormalize`, `add_border`, `write_text`)
that generate.py imports — numpy/PIL only, no torch.
"""
from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np

from bevgen_torch.data.camera_geometry import denormalize_image


def _is_pil(data) -> bool:
    """A PIL image, told without importing PIL where no caller has."""
    import sys
    pil = sys.modules.get("PIL.Image")
    return pil is not None and isinstance(data, pil.Image)


class Im:
    """Wraps (h, w, 3) float [0,1] / uint8 arrays or PIL images."""

    def __init__(self, data):
        if isinstance(data, Im):
            self._np = data._np
        elif _is_pil(data):
            self._np = np.asarray(data.convert("RGB"))
        else:
            arr = np.asarray(data)
            if arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[0] < arr.shape[-1]:
                arr = np.moveaxis(arr, 0, -1)  # chw -> hwc
            if arr.ndim == 3 and arr.shape[-1] == 1:
                arr = arr[..., 0]  # (h, w, 1) -> grayscale plane
            if arr.ndim == 2:
                arr = np.repeat(arr[..., None], 3, axis=-1)
            self._np = arr

    @property
    def np(self) -> np.ndarray:
        return self._np

    @property
    def uint8(self) -> np.ndarray:
        a = self._np
        if a.dtype == np.uint8:
            return a
        return (np.clip(a.astype(np.float32), 0, 1) * 255).astype(np.uint8)

    @property
    def pil(self):
        from PIL import Image
        return Image.fromarray(self.uint8)

    def denormalize(self) -> "Im":
        """Undo the Argoverse normalization (util.py denormalize_tensor)."""
        return Im(denormalize_image(self._np.astype(np.float32)))

    def add_border(self, width: int = 2, color=(255, 0, 0)) -> "Im":
        a = self.uint8.copy()
        a[:width], a[-width:] = color, color
        a[:, :width], a[:, -width:] = color, color
        return Im(a)

    def write_text(self, text: str, pos=(4, 4), color=(255, 255, 255)) -> "Im":
        from PIL import ImageDraw
        img = self.pil
        ImageDraw.Draw(img).text(pos, text, fill=color)
        return Im(img)

    def resize(self, h: int, w: int) -> "Im":
        from PIL import Image
        return Im(self.pil.resize((w, h), Image.BILINEAR))

    def save(self, path: Union[str, Path], quality: int = 95):
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        img = self.pil
        if path.suffix.lower() in (".jpg", ".jpeg"):
            img.save(path, quality=quality)
        else:
            img.save(path)
        return path


def make_grid(images, nrow: int = 2, pad: int = 2) -> np.ndarray:
    """Tile (n, h, w, 3) images into a grid (torchvision make_grid
    equivalent)."""
    imgs = [Im(i).uint8 for i in images]
    n = len(imgs)
    h, w = imgs[0].shape[:2]
    ncol = nrow
    nr = -(-n // ncol)
    out = np.zeros((nr * (h + pad) - pad, ncol * (w + pad) - pad, 3),
                   np.uint8)
    for i, img in enumerate(imgs):
        r, c = divmod(i, ncol)
        out[r * (h + pad): r * (h + pad) + h,
            c * (w + pad): c * (w + pad) + w] = img
    return out
