"""PatchGAN discriminator with BatchNorm or ActNorm.

Port of `bevgen_tpu/models/discriminator.py` (the reference's
`NLayerDiscriminator`: 4x4 convs, stride 2, then stride 1, padding 1,
LeakyReLU 0.2). Input NHWC, as the stage-1 models take it; the convs run
NCHW inside. Module names follow the flax tree (`conv_0`, `conv_{n}`,
`norm_{n}`, `conv_out`), so `core/convert.py:load_jax_params` fills them.
The norms compute in fp32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class ActNorm(nn.Module):
    """Per-channel affine, scale * (x + loc). The reference's data-dependent
    initialisation is a plain parameter initialisation here (loc 0,
    scale 1)."""

    def __init__(self, channels: int):
        super().__init__()
        self.loc = nn.Parameter(torch.zeros(channels))
        self.scale = nn.Parameter(torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        loc, scale = self.loc[:, None, None], self.scale[:, None, None]
        return (scale * (x.float() + loc)).to(x.dtype)


class BatchNorm(nn.Module):
    """Batch normalisation over the batch statistics of each call (biased
    variance, eps 1e-5), with no running statistics: the reference runs its
    torch BatchNorm2d in train mode inside the GAN loss."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x.float(), None, None, self.weight, self.bias,
                            training=True, eps=1e-5).to(x.dtype)


class NLayerDiscriminator(nn.Module):
    """70x70 PatchGAN: (b, H, W, in_channels) -> patch logits
    (b, H/2^n_layers - 2, W/2^n_layers - 2, 1). The inner convs have a bias
    only with ActNorm."""

    def __init__(self, ndf: int = 64, n_layers: int = 3,
                 use_actnorm: bool = False, in_channels: int = 3):
        super().__init__()
        norm = ActNorm if use_actnorm else BatchNorm
        self.n_layers = n_layers
        self.conv_0 = nn.Conv2d(in_channels, ndf, 4, 2, 1)
        c = ndf
        for n in range(1, n_layers + 1):
            cout = ndf * min(2 ** n, 8)
            stride = 2 if n < n_layers else 1
            self.add_module(f"conv_{n}", nn.Conv2d(c, cout, 4, stride, 1,
                                                   bias=use_actnorm))
            self.add_module(f"norm_{n}", norm(cout))
            c = cout
        self.conv_out = nn.Conv2d(c, 1, 4, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.conv_0(x.permute(0, 3, 1, 2)), 0.2)
        for n in range(1, self.n_layers + 1):
            h = getattr(self, f"norm_{n}")(getattr(self, f"conv_{n}")(h))
            h = F.leaky_relu(h, 0.2)
        return self.conv_out(h).permute(0, 2, 3, 1)
