"""LPIPS perceptual distance: a VGG16 feature stack and learned linear heads.

Port of `bevgen_tpu/models/lpips.py` (the reference's vendored taming LPIPS
with `lpips/vgg.pth`). The weights load from the JAX package's npz layout
(`vgg/conv_{stage}_{c}/{kernel,bias}`, `lin_{i}/kernel`, flax HWIO
kernels), which `convert_lpips_weights` writes from a torchvision `vgg16`
state dict and the reference's `vgg.pth`; both packages read one file.
Inputs are NHWC in [-1, 1]; the convs run NCHW inside.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# (channels, convs) of the VGG16 conv stages
_VGG_SLICES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class VGG16Features(nn.Module):
    """The VGG16 conv stack: NCHW in, the activations after each stage's
    last ReLU out (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3)."""

    def __init__(self):
        super().__init__()
        cin = 3
        for stage, (ch, n_convs) in enumerate(_VGG_SLICES):
            for c in range(n_convs):
                self.add_module(f"conv_{stage}_{c}",
                                nn.Conv2d(cin, ch, 3, padding=1))
                cin = ch

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for stage, (_, n_convs) in enumerate(_VGG_SLICES):
            for c in range(n_convs):
                x = F.relu(getattr(self, f"conv_{stage}_{c}")(x))
            outs.append(x)
            if stage < len(_VGG_SLICES) - 1:
                x = F.max_pool2d(x, 2, 2)
        return outs


class LPIPS(nn.Module):
    """Perceptual distance d(x, y), (b,), of NHWC images in [-1, 1]."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, (ch, _) in enumerate(_VGG_SLICES):
            self.add_module(f"lin_{i}", nn.Conv2d(ch, 1, 1, bias=False))
        self.register_buffer("shift", torch.from_numpy(_SHIFT)[:, None, None],
                             persistent=False)
        self.register_buffer("scale", torch.from_numpy(_SCALE)[:, None, None],
                             persistent=False)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        fx = self.vgg((x.permute(0, 3, 1, 2) - self.shift) / self.scale)
        fy = self.vgg((y.permute(0, 3, 1, 2) - self.shift) / self.scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            a = a / (torch.linalg.vector_norm(a.float(), dim=1, keepdim=True)
                     + 1e-10)
            b = b / (torch.linalg.vector_norm(b.float(), dim=1, keepdim=True)
                     + 1e-10)
            total = total + getattr(self, f"lin_{i}")((a - b) ** 2).mean(
                dim=(1, 2, 3))
        return total


def convert_lpips_weights(vgg_pth: str, lpips_pth: str, out_npz: str) -> None:
    """A torchvision vgg16 state dict (or module) and the reference's
    `vgg.pth` linear heads -> the npz that `load_lpips_params` reads."""
    vgg_sd = torch.load(vgg_pth, map_location="cpu")
    if not isinstance(vgg_sd, dict):
        vgg_sd = vgg_sd.state_dict()
    lpips_sd = torch.load(lpips_pth, map_location="cpu")
    out = {}
    conv_ids = [i for i in range(31) if f"features.{i}.weight" in vgg_sd]
    stage, c = 0, 0
    for i in conv_ids:
        w = vgg_sd[f"features.{i}.weight"].numpy()
        out[f"vgg/conv_{stage}_{c}/kernel"] = np.transpose(w, (2, 3, 1, 0))
        out[f"vgg/conv_{stage}_{c}/bias"] = vgg_sd[f"features.{i}.bias"].numpy()
        c += 1
        if c == _VGG_SLICES[stage][1]:
            stage, c = stage + 1, 0
    for i in range(len(_VGG_SLICES)):
        w = lpips_sd[f"lin{i}.model.1.weight"].numpy()
        out[f"lin_{i}/kernel"] = np.transpose(w, (2, 3, 1, 0))
    np.savez_compressed(out_npz, **out)


def load_lpips_params(npz_path: str) -> Optional[Dict[str, Any]]:
    """The npz as a numpy tree ({"params": ...}) for `load_jax_params`, or
    None when the file is missing."""
    from bevgen_torch.core.checkpoint import load_npz_tree
    return load_npz_tree(npz_path, missing_ok=True)
