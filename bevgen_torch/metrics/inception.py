"""FID InceptionV3 (pool3, 2048-d) in PyTorch.

Port of `bevgen_tpu/metrics/inception.py`: the FID-standard network (the
TF-ported InceptionV3 of clean-fid / pytorch-fid). BasicConv = conv (no
bias) + inference BatchNorm (eps 1e-3) + ReLU; InceptionA/C and the first
InceptionE pool with count-exclude-pad averages; the final InceptionE
(`Mixed_7c`) takes the max pool in its pool branch.

Submodules carry the flax tree's names, which are also pytorch-fid's
(`Mixed_5b.branch1x1.conv`, ...); a BasicConv holds its BatchNorm as the
flax leaves `bn_scale`, `bn_bias`, `bn_mean`, `bn_var`, so
`core/convert.py:load_jax_params` loads the converted npz (or the JAX
tree) as it is. `load_pytorch_fid` takes pytorch-fid's state dict
(`pt_inception-2015-12-05-6726825d.pth`) directly, and
`convert_inception_weights` writes the npz that both packages read. No
weights ship with the repository.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3
FID_RES = 299
# pytorch-fid BatchNorm key -> the flax leaf that holds it
_BN_LEAVES = {"weight": "bn_scale", "bias": "bn_bias",
              "running_mean": "bn_mean", "running_var": "bn_var"}


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


class BasicConv(nn.Module):
    def __init__(self, cin: int, features: int, kernel: Sequence[int],
                 strides: Union[int, Sequence[int]] = 1,
                 padding: Union[int, Sequence[int]] = 0):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, _pair(kernel), _pair(strides),
                              _pair(padding), bias=False)
        self.bn_scale = nn.Parameter(torch.ones(features))
        self.bn_bias = nn.Parameter(torch.zeros(features))
        self.bn_mean = nn.Parameter(torch.zeros(features))
        self.bn_var = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        inv = torch.rsqrt(self.bn_var + BN_EPS)[:, None, None]
        x = ((x - self.bn_mean[:, None, None]) * inv
             * self.bn_scale[:, None, None] + self.bn_bias[:, None, None])
        return F.relu(x)


def _avg_pool_exc(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 average pool with count_include_pad=False."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 64, 1)
        self.branch5x5_1 = BasicConv(cin, 48, 1)
        self.branch5x5_2 = BasicConv(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, padding=1)
        self.branch_pool = BasicConv(cin, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_exc(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv(cin, 384, 3, 2)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, 2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 192, 1)
        self.branch7x7_1 = BasicConv(cin, c7, 1)
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool_exc(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv(cin, 192, 1)
        self.branch3x3_2 = BasicConv(192, 320, 3, 2)
        self.branch7x7x3_1 = BasicConv(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv(192, 192, 3, 2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for i in range(2, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, pool_max: bool = False):
        super().__init__()
        self.pool_max = pool_max  # the final block (FIDInceptionE_2)
        self.branch1x1 = BasicConv(cin, 320, 1)
        self.branch3x3_1 = BasicConv(cin, 384, 1)
        self.branch3x3_2a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       dim=1)
        bp = (F.max_pool2d(x, 3, 1, 1) if self.pool_max
              else _avg_pool_exc(x))
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], dim=1)


class InceptionV3(nn.Module):
    """images (b, h, w, 3) in [0, 1] -> pool3 features (b, 2048)."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv(3, 32, 3, 2)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048, pool_max=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # FID preprocessing: bilinear resize to 299 (antialiased when it
        # shrinks, as jax.image.resize is) + scale to [-1, 1]
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(FID_RES, FID_RES),
                          mode="bilinear", align_corners=False, antialias=True)
        x = x * 2.0 - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = _max_pool(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))     # global avg pool -> (b, 2048)

    @torch.no_grad()
    def load_pytorch_fid(self, state_dict: Mapping[str, torch.Tensor]
                         ) -> "InceptionV3":
        """Fill every parameter from pytorch-fid's state dict (`<conv>.conv.
        weight`, `<conv>.bn.{weight,bias,running_mean,running_var}`); the
        `fc` head and `num_batches_tracked` are not read. Raises on a
        parameter left unset."""
        params = dict(self.named_parameters())
        unset = set(params)
        for key, val in state_dict.items():
            owner, _, leaf = key.rpartition(".")
            base, _, kind = owner.rpartition(".")
            if kind == "conv" and leaf == "weight":
                name = key
            elif kind == "bn" and leaf in _BN_LEAVES:
                name = f"{base}.{_BN_LEAVES[leaf]}"
            else:
                continue
            if name in params:
                params[name].copy_(val)
                unset.discard(name)
        if unset:
            raise KeyError(f"pytorch-fid state dict left parameters unset: "
                           f"{sorted(unset)[:10]} ({len(unset)} in all)")
        return self


def load_inception(weights: Union[str, Mapping[str, Any]]) -> InceptionV3:
    """An eval-mode, frozen InceptionV3 from the converted npz (a path) or
    the JAX package's parameter tree (numpy leaves)."""
    from bevgen_torch.core.checkpoint import load_npz_tree
    from bevgen_torch.core.convert import load_jax_params
    tree = load_npz_tree(weights) if isinstance(weights, str) else weights
    return load_jax_params(InceptionV3(), tree).eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# weight conversion
# ---------------------------------------------------------------------------


def convert_inception_weights(pth_path: str, out_npz: str) -> int:
    """pytorch-fid pt_inception checkpoint -> the npz of the JAX package's
    converter (the same keys, HWIO kernels, the fc head dropped), with a
    numeric self-check against pytorch-fid's model when that package is
    importable. Returns the number of arrays written."""
    sd = torch.load(pth_path, map_location="cpu")
    out = {}
    for key, val in sd.items():
        v = val.numpy()
        parts = key.split(".")
        if parts[-2] == "conv" and parts[-1] == "weight":
            out["/".join(parts[:-2]) + "/conv/kernel"] = np.transpose(
                v, (2, 3, 1, 0))
        elif parts[-2] == "bn":
            name = _BN_LEAVES.get(parts[-1])
            if name is None:
                continue
            out["/".join(parts[:-2]) + "/" + name] = v
    np.savez_compressed(out_npz, **out)
    _converter_self_check(out_npz)
    return len(out)


def _converter_self_check(out_npz: str, atol: float = 1e-3) -> bool:
    """pool3 features of pytorch-fid's graph and of this model on one
    random input; False (skipped) when pytorch-fid is not importable."""
    try:
        from pytorch_fid.inception import InceptionV3 as TorchInception
    except ImportError:
        return False
    x = np.random.default_rng(0).uniform(0, 1, (2, 3, 299, 299)) \
        .astype(np.float32)
    tm = TorchInception([3], resize_input=False, normalize_input=True)
    tm.eval()
    with torch.no_grad():
        ref = tm(torch.from_numpy(x))[0].squeeze(-1).squeeze(-1).numpy()
        ours = load_inception(out_npz)(
            torch.from_numpy(np.transpose(x, (0, 2, 3, 1)))).numpy()
    err = float(np.max(np.abs(ours - ref)))
    assert err < atol, f"inception converter self-check failed: {err}"
    return True


def random_fid_state_dict(seed: int) -> Dict[str, torch.Tensor]:
    """A seeded state dict in pytorch-fid's layout (every BasicConv's
    `conv.weight` OIHW and `bn.*`, the 1008-way `fc` head): He-scaled
    kernels and BatchNorm statistics that keep activations near unit
    scale through the 94 convolutions. Stands in for the checkpoint, which
    the repository does not hold."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, mod in InceptionV3().named_modules():
        if not isinstance(mod, BasicConv):
            continue
        w = mod.conv.weight
        fan_in = w[0].numel()
        sd[f"{name}.conv.weight"] = rng.standard_normal(w.shape) * np.sqrt(
            2.0 / fan_in)
        c = w.shape[0]
        sd[f"{name}.bn.weight"] = rng.uniform(0.8, 1.2, c)
        sd[f"{name}.bn.bias"] = 0.1 * rng.standard_normal(c)
        sd[f"{name}.bn.running_mean"] = 0.1 * rng.standard_normal(c)
        sd[f"{name}.bn.running_var"] = rng.uniform(0.8, 1.2, c)
    sd["fc.weight"] = rng.standard_normal((1008, 2048)) / np.sqrt(2048)
    sd["fc.bias"] = np.zeros(1008)
    return {k: torch.from_numpy(np.asarray(v, np.float32))
            for k, v in sd.items()}
