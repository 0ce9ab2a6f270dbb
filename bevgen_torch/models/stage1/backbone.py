"""Stage-1 conv backbone: taming-style ResNet encoder/decoder.

Port of `bevgen_tpu/models/stage1/backbone.py`. Activations are NCHW
inside (PyTorch's native conv layout); the public models in `vq.py` keep
the reference's NHWC at their boundary. Convolutions run in the model's
compute dtype, GroupNorm in fp32. Submodule names mirror the reference's
parameter tree (`down_{i}_block_{j}`, `norm1.norm`, ...), so
`core/convert.py` maps one onto the other by name.

The reference's `PaddedOutConv` (a TPU lane-padding of the 3/7-channel
output conv) is a plain 3x3 conv here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bevgen_torch.core.config import Stage1Config


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class GroupNorm32(nn.Module):
    """GroupNorm(min(32, C) groups, eps 1e-6) computed in fp32."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = nn.GroupNorm(min(32, channels), channels, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.norm
        return F.group_norm(x.float(), n.num_groups, n.weight, n.bias,
                            n.eps).to(x.dtype)


def conv3x3(cin: int, cout: int, dtype, stride: int = 1,
            padding: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=padding, dtype=dtype)


def conv1x1(cin: int, cout: int, dtype) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 1, dtype=dtype)


class ResnetBlock(nn.Module):
    """GN -> swish -> conv -> GN -> swish -> conv, + shortcut."""

    def __init__(self, cin: int, cout: int, dtype):
        super().__init__()
        self.norm1 = GroupNorm32(cin)
        self.conv1 = conv3x3(cin, cout, dtype)
        self.norm2 = GroupNorm32(cout)
        self.conv2 = conv3x3(cout, cout, dtype)
        if cin != cout:
            self.nin_shortcut = conv1x1(cin, cout, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(swish(self.norm1(x)))
        h = self.conv2(swish(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention at low resolution: plain matmul
    and softmax, scores in fp32."""

    def __init__(self, c: int, dtype):
        super().__init__()
        self.norm = GroupNorm32(c)
        self.q = conv1x1(c, c, dtype)
        self.k = conv1x1(c, c, dtype)
        self.v = conv1x1(c, c, dtype)
        self.proj_out = conv1x1(c, c, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        hn = self.norm(x)
        q = self.q(hn).reshape(b, c, h * w).transpose(1, 2)
        k = self.k(hn).reshape(b, c, h * w)
        v = self.v(hn).reshape(b, c, h * w).transpose(1, 2)
        attn = torch.bmm(q.float(), k.float()) * (c ** -0.5)
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.bmm(attn.float(), v.float()).to(x.dtype)
        out = out.transpose(1, 2).reshape(b, c, h, w)
        return x + self.proj_out(out)


class Downsample(nn.Module):
    """Asymmetric (0,1,0,1) pad, then a stride-2 valid 3x3 conv."""

    def __init__(self, c: int, dtype):
        super().__init__()
        self.conv = conv3x3(c, c, dtype, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    """Nearest x2, then a 3x3 conv."""

    def __init__(self, c: int, dtype):
        super().__init__()
        self.conv = conv3x3(c, c, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Encoder(nn.Module):
    """Image (b, C, H, W) -> z feature map, 2^(len(ch_mult)-1)x downsampled."""

    def __init__(self, cfg: Stage1Config, dtype):
        super().__init__()
        self.cfg = cfg
        self.conv_in = conv3x3(cfg.in_channels, cfg.ch, dtype)
        self.order = []
        curr_res, c = cfg.resolution, cfg.ch
        for i_level, mult in enumerate(cfg.ch_mult):
            block_out = cfg.ch * mult
            for i_block in range(cfg.num_res_blocks):
                self._add(f"down_{i_level}_block_{i_block}",
                          ResnetBlock(c, block_out, dtype))
                c = block_out
                if curr_res in cfg.attn_resolutions:
                    self._add(f"down_{i_level}_attn_{i_block}", AttnBlock(c, dtype))
            if i_level != len(cfg.ch_mult) - 1:
                self._add(f"down_{i_level}_downsample", Downsample(c, dtype))
                curr_res //= 2
        self._add("mid_block_1", ResnetBlock(c, c, dtype))
        self._add("mid_attn_1", AttnBlock(c, dtype))
        self._add("mid_block_2", ResnetBlock(c, c, dtype))
        self.norm_out = GroupNorm32(c)
        out_ch = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.conv_out = conv3x3(c, out_ch, dtype)

    def _add(self, name: str, module: nn.Module) -> None:
        self.add_module(name, module)
        self.order.append(name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for name in self.order:
            h = getattr(self, name)(h)
        return self.conv_out(swish(self.norm_out(h)))


class Decoder(nn.Module):
    """z feature map (b, z, h, w) -> image (b, out_ch, H, W)."""

    def __init__(self, cfg: Stage1Config, dtype):
        super().__init__()
        self.cfg = cfg
        num_res = len(cfg.ch_mult)
        c = cfg.ch * cfg.ch_mult[-1]
        curr_res = cfg.resolution // (2 ** (num_res - 1))
        self.conv_in = conv3x3(cfg.z_channels, c, dtype)
        self.order = []
        self._add("mid_block_1", ResnetBlock(c, c, dtype))
        self._add("mid_attn_1", AttnBlock(c, dtype))
        self._add("mid_block_2", ResnetBlock(c, c, dtype))
        for i_level in reversed(range(num_res)):
            block_out = cfg.ch * cfg.ch_mult[i_level]
            for i_block in range(cfg.num_res_blocks + 1):
                self._add(f"up_{i_level}_block_{i_block}",
                          ResnetBlock(c, block_out, dtype))
                c = block_out
                if curr_res in cfg.attn_resolutions:
                    self._add(f"up_{i_level}_attn_{i_block}", AttnBlock(c, dtype))
            if i_level != 0:
                self._add(f"up_{i_level}_upsample", Upsample(c, dtype))
                curr_res *= 2
        self.norm_out = GroupNorm32(c)
        self.conv_out = conv3x3(c, cfg.out_ch, dtype)

    _add = Encoder._add

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z)
        for name in self.order:
            h = getattr(self, name)(h)
        return self.conv_out(swish(self.norm_out(h)))
