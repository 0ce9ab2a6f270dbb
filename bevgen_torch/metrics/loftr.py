"""LoFTR learned matcher for the cross-camera consistency metric.

Port of `bevgen_tpu/metrics/loftr.py`. The reference's consistency numbers
come from kornia's LoFTR ("outdoor" weights) run over 50-px adjacent-edge
windows: a ResNet-FPN backbone, a linear-attention coarse transformer,
dual-softmax mutual-nearest-neighbour matching and a window fine
refinement (Sun et al., CVPR 2021).

The modules' `state_dict` keys are the original LoFTR keys (`backbone.`,
`loftr_coarse.`, `loftr_fine.`, `fine_preprocess.`), which are also the
keys of the JAX package's flat npz; the npz holds conv kernels HWIO and
linear weights (in, out), so `load_params` transposes them, and a
kornia/original checkpoint loads as it is (`load_torch_state_dict`) once
`matcher.` is stripped and the positional-encoding buffers are dropped.
BatchNorms run in eval mode. Inputs whose sides are not multiples of 8
(the 50-px strips) are zero-padded up and the padded coarse cells are
masked out of matching, as the JAX package does.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# outdoor/indoor LoFTR hyperparameters (loftr/utils/cvpr_ds_config.py)
INITIAL_DIM = 128
BLOCK_DIMS = (128, 196, 256)
D_COARSE = 256
D_FINE = 128
NHEAD = 8
COARSE_LAYERS = ("self", "cross") * 4
FINE_LAYERS = ("self", "cross")
DS_TEMPERATURE = 0.1
MATCH_THR = 0.2
BORDER_RM = 2
FINE_WINDOW = 5
EPS_BN = 1e-5
EPS_LIN_ATTN = 1e-6

_PREFIXES = ("backbone.", "loftr_coarse.", "loftr_fine.", "fine_preprocess.")


# ---------------------------------------------------------------------------
# backbone: ResNetFPN_8_2 (loftr/backbone/resnet_fpn.py)
# ---------------------------------------------------------------------------


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    # torch's symmetric k//2 padding, which the JAX package pads explicitly
    return nn.Conv2d(cin, cout, k, stride, k // 2, bias=False)


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=EPS_BN)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv1 = _conv(cin, cout, 3, stride)
        self.bn1 = _bn(cout)
        self.conv2 = _conv(cout, cout, 3)
        self.bn2 = _bn(cout)
        self.downsample = (
            nn.Sequential(_conv(cin, cout, 1, stride), _bn(cout))
            if stride != 1 else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


def _layer(cin: int, cout: int, stride: int) -> nn.Sequential:
    return nn.Sequential(BasicBlock(cin, cout, stride),
                         BasicBlock(cout, cout, 1))


def _out_conv2(cin: int, cmid: int, cout: int) -> nn.Sequential:
    return nn.Sequential(_conv(cin, cmid, 3), _bn(cmid),
                         nn.LeakyReLU(0.01), _conv(cmid, cout, 3))


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    """bilinear 2x with align_corners=True, the FPN's interpolation."""
    return F.interpolate(x, scale_factor=2.0, mode="bilinear",
                         align_corners=True)


class ResNetFPN(nn.Module):
    """x: (b, 1, H, W) grayscale, H/W multiples of 8. Returns
    (coarse (b, 256, H/8, W/8), fine (b, 128, H/2, W/2))."""

    def __init__(self):
        super().__init__()
        d0, d1, d2 = BLOCK_DIMS
        self.conv1 = _conv(1, INITIAL_DIM, 7, 2)
        self.bn1 = _bn(INITIAL_DIM)
        self.layer1 = _layer(INITIAL_DIM, d0, 1)
        self.layer2 = _layer(d0, d1, 2)
        self.layer3 = _layer(d1, d2, 2)
        self.layer3_outconv = _conv(d2, d2, 1)
        self.layer2_outconv = _conv(d1, d2, 1)
        self.layer2_outconv2 = _out_conv2(d2, d2, d1)
        self.layer1_outconv = _conv(d0, d1, 1)
        self.layer1_outconv2 = _out_conv2(d1, d1, d0)

    def forward(self, x):
        x0 = F.relu(self.bn1(self.conv1(x)))                      # 1/2
        x1 = self.layer1(x0)                                      # 1/2, 128
        x2 = self.layer2(x1)                                      # 1/4, 196
        x3 = self.layer3(x2)                                      # 1/8, 256
        x3_out = self.layer3_outconv(x3)
        x2_out = self.layer2_outconv2(self.layer2_outconv(x2)
                                      + _upsample2x(x3_out))
        x1_out = self.layer1_outconv2(self.layer1_outconv(x1)
                                      + _upsample2x(x2_out))
        return x3_out, x1_out


# ---------------------------------------------------------------------------
# positional encoding (loftr/utils/position_encoding.py, temp_bug_fix)
# ---------------------------------------------------------------------------


def sine_position_encoding(h: int, w: int, d: int = D_COARSE) -> np.ndarray:
    """(h, w, d), the PositionEncodingSine table (temp_bug_fix=True —
    the form the published outdoor weights were trained with)."""
    pe = np.zeros((h, w, d), np.float32)
    ypos = np.arange(h, dtype=np.float32)[:, None, None]
    xpos = np.arange(w, dtype=np.float32)[None, :, None]
    div = np.exp(np.arange(0, d // 2, 2, dtype=np.float32)
                 * (-math.log(10000.0) / (d // 2)))
    pe[:, :, 0::4] = np.sin(xpos * div)
    pe[:, :, 1::4] = np.cos(xpos * div)
    pe[:, :, 2::4] = np.sin(ypos * div)
    pe[:, :, 3::4] = np.cos(ypos * div)
    return pe


# ---------------------------------------------------------------------------
# coarse/fine transformer (loftr/loftr_module/transformer.py)
# ---------------------------------------------------------------------------


def _linear_attention(q, k, v):
    """elu-kernel linear attention (loftr/loftr_module/linear_attention.py).
    q, k, v: (b, n, h, d)."""
    q = F.elu(q) + 1.0
    k = F.elu(k) + 1.0
    v_len = v.shape[1]
    v = v / v_len
    kv = torch.einsum("nshd,nshv->nhdv", k, v)
    z = 1.0 / (torch.einsum("nlhd,nhd->nlh", q, k.sum(1)) + EPS_LIN_ATTN)
    return torch.einsum("nlhd,nhdv,nlh->nlhv", q, kv, z) * v_len


class EncoderLayer(nn.Module):
    def __init__(self, d: int, nhead: int = NHEAD):
        super().__init__()
        self.nhead = nhead
        self.q_proj = nn.Linear(d, d, bias=False)
        self.k_proj = nn.Linear(d, d, bias=False)
        self.v_proj = nn.Linear(d, d, bias=False)
        self.merge = nn.Linear(d, d, bias=False)
        self.mlp = nn.Sequential(nn.Linear(2 * d, 2 * d, bias=False),
                                 nn.ReLU(), nn.Linear(2 * d, d, bias=False))
        self.norm1 = nn.LayerNorm(d)
        self.norm2 = nn.LayerNorm(d)

    def forward(self, x, source):
        b, n, d = x.shape
        dim = d // self.nhead
        msg = _linear_attention(
            self.q_proj(x).reshape(b, n, self.nhead, dim),
            self.k_proj(source).reshape(b, -1, self.nhead, dim),
            self.v_proj(source).reshape(b, -1, self.nhead, dim))
        msg = self.norm1(self.merge(msg.reshape(b, n, d)))
        msg = self.norm2(self.mlp(torch.cat([x, msg], dim=-1)))
        return x + msg


class LocalFeatureTransformer(nn.Module):
    def __init__(self, d: int, layer_names: Tuple[str, ...]):
        super().__init__()
        self.layer_names = layer_names
        self.layers = nn.ModuleList(EncoderLayer(d) for _ in layer_names)

    def forward(self, f0, f1):
        for layer, kind in zip(self.layers, self.layer_names):
            if kind == "self":
                f0, f1 = layer(f0, f0), layer(f1, f1)
            else:  # both from the layer's inputs: f0 <- old f1, f1 <- old f0
                f0, f1 = layer(f0, f1), layer(f1, f0)
        return f0, f1


class FinePreprocess(nn.Module):
    def __init__(self):
        super().__init__()
        self.down_proj = nn.Linear(D_COARSE, D_FINE, bias=True)
        self.merge_feat = nn.Linear(2 * D_FINE, D_FINE, bias=True)


# ---------------------------------------------------------------------------
# coarse matching (loftr/utils/coarse_matching.py, dual_softmax)
# ---------------------------------------------------------------------------


def coarse_match_confidence(f0, f1, valid0=None, valid1=None):
    """Dual-softmax confidence matrix (b, L, S). valid*: (b, L) bool —
    padded cells (non-multiple-of-8 inputs) are excluded."""
    f0 = f0 / (f0.shape[-1] ** 0.5)
    f1 = f1 / (f1.shape[-1] ** 0.5)
    sim = torch.einsum("nlc,nsc->nls", f0, f1) / DS_TEMPERATURE
    if valid0 is not None:
        sim = torch.where(valid0[:, :, None], sim, -1e9)
    if valid1 is not None:
        sim = torch.where(valid1[:, None, :], sim, -1e9)
    return F.softmax(sim, dim=1) * F.softmax(sim, dim=2)


def _border_mask(hc, wc, border: int) -> np.ndarray:
    """(hc*wc,) bool: True for cells at least `border` away from every
    edge (mask_border in the original)."""
    m = np.zeros((hc, wc), bool)
    if hc > 2 * border and wc > 2 * border:
        m[border:hc - border, border:wc - border] = True
    else:  # degenerate strips: keep everything rather than nothing
        m[:] = True
    return m.reshape(-1)


def mutual_nearest_matches(conf, hw0, hw1, thr=MATCH_THR, border=BORDER_RM):
    """conf: (L, S) for ONE pair -> (idx0, idx1, mconf, valid) fixed-size
    tensors of length L (mask `valid`). Mutual-NN + threshold + border
    removal, matching CoarseMatching.get_coarse_match."""
    b0 = torch.as_tensor(_border_mask(*hw0, border), device=conf.device)
    b1 = torch.as_tensor(_border_mask(*hw1, border), device=conf.device)
    mask = conf > thr
    mask = mask & (conf == conf.max(dim=1, keepdim=True).values)
    mask = mask & (conf == conf.max(dim=0, keepdim=True).values)
    mask = mask & b0[:, None] & b1[None, :]
    # each row has at most one True after mutual-NN; argmax takes the
    # first maximal index, as the JAX argmax of a bool mask does
    idx1 = mask.to(torch.uint8).argmax(dim=1)
    valid = mask.any(dim=1)
    rows = torch.arange(conf.shape[0], device=conf.device)
    mconf = torch.where(valid, conf[rows, idx1], 0.0)
    return rows, idx1, mconf, valid


def near_tie_cells(conf: np.ndarray, tol: float, thr: float = MATCH_THR
                   ) -> np.ndarray:
    """(L, S) bool: cells above `thr - tol` whose confidence lies within
    `tol` of `thr` or of its closest rival in its row or column (the
    largest other entry). Rounding of that size can flip the
    mutual-nearest decision there and nowhere else."""
    conf = np.asarray(conf, np.float64)

    def rival(c):  # the largest other entry of each cell's row
        top2 = np.sort(c, axis=1)[:, -2:]
        return np.where(c == top2[:, 1:], top2[:, :1], top2[:, 1:])
    near = ((np.abs(conf - thr) <= tol)
            | (np.abs(conf - rival(conf)) <= tol)
            | (np.abs(conf - rival(conf.T).T) <= tol))
    return near & (conf > thr - tol)


# ---------------------------------------------------------------------------
# fine preprocess + matching (loftr/loftr_module/fine_preprocess.py,
# loftr/utils/fine_matching.py)
# ---------------------------------------------------------------------------


def _unfold_windows(feat, idx, w=FINE_WINDOW):
    """feat: (c, hf, wf) fine map (hf, wf = 4x the coarse grid); idx: (L,)
    coarse cell ids. The w x w window centred on each coarse cell (the
    original unfolds with kernel w, stride 4, padding w//2). Returns
    (L, w*w, c)."""
    c = feat.shape[0]
    wins = F.unfold(feat[None], w, padding=w // 2, stride=4)  # (1, c*w*w, L)
    return wins.reshape(c, w * w, -1).permute(2, 1, 0)[idx]


class LoFTR(nn.Module):
    """The parameters of the matcher, under the original LoFTR names."""

    def __init__(self, fine: bool = True):
        super().__init__()
        self.backbone = ResNetFPN()
        self.loftr_coarse = LocalFeatureTransformer(D_COARSE, COARSE_LAYERS)
        self.has_fine = fine
        if fine:
            self.fine_preprocess = FinePreprocess()
            self.loftr_fine = LocalFeatureTransformer(D_FINE, FINE_LAYERS)

    @torch.no_grad()
    def load_params(self, params: Mapping[str, Any]) -> "LoFTR":
        """Fill the module from the npz layout (conv HWIO, linear (in,
        out), `init_random_params` or `convert_loftr_weights`). Raises on
        a key the module lacks and on a state entry left unset (the
        BatchNorms' `num_batches_tracked` is not read)."""
        state = self.state_dict()
        unknown = [k for k in params if k not in state]
        if unknown:
            raise KeyError(f"LoFTR parameters with no module entry: "
                           f"{sorted(unknown)[:10]} ({len(unknown)} in all)")
        unset = [k for k in state if k not in params
                 and not k.endswith("num_batches_tracked")]
        if unset:
            raise KeyError(f"LoFTR module entries left unset: "
                           f"{sorted(unset)[:10]} ({len(unset)} in all)")
        for k, v in params.items():
            a = np.asarray(v)
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 2 and k.endswith(".weight"):
                a = a.T
            state[k].copy_(torch.as_tensor(np.ascontiguousarray(a)))
        return self

    def load_torch_state_dict(self, sd: Mapping[str, torch.Tensor]
                              ) -> "LoFTR":
        """A kornia/original LoFTR state dict: `matcher.` stripped, keys
        outside the four module prefixes (the positional-encoding buffers)
        dropped, the rest loaded strictly."""
        sd = {(k[len("matcher."):] if k.startswith("matcher.") else k): v
              for k, v in sd.items()}
        self.load_state_dict({k: v for k, v in sd.items()
                              if k.startswith(_PREFIXES)})
        return self

    def fine_refine(self, fine0, fine1, idx0, idx1, coarse0=None,
                    coarse1=None):
        """Window crop + coarse-context merge + fine transformer +
        spatial-expectation refinement, for every coarse cell. fine*:
        (128, hf, wf); coarse*: (L, 256) post-transformer features.
        Returns per-match (dy, dx) in FINE pixels for image1."""
        w = FINE_WINDOW
        f0 = _unfold_windows(fine0, idx0, w)
        f1 = _unfold_windows(fine1, idx1, w)
        if coarse0 is not None:
            fp = self.fine_preprocess
            ctx = torch.cat([fp.down_proj(coarse0[idx0]),
                             fp.down_proj(coarse1[idx1])], 0)[:, None, :]
            feats = torch.cat([f0, f1], 0)
            merged = fp.merge_feat(torch.cat(
                [feats, ctx.expand(feats.shape)], dim=-1))
            f0, f1 = merged.chunk(2, dim=0)
        f0, f1 = self.loftr_fine(f0, f1)
        centre = f0[:, w * w // 2, :]
        sim = torch.einsum("lc,lwc->lw", centre, f1) / (f1.shape[-1] ** 0.5)
        heat = F.softmax(sim, dim=-1).reshape(-1, w, w)
        grid = torch.arange(w, dtype=heat.dtype, device=heat.device) - w // 2
        dy = (heat.sum(2) * grid).sum(-1)
        dx = (heat.sum(1) * grid).sum(-1)
        return dy, dx

    def forward(self, img0, img1, hw0: Tuple[int, int],
                hw1: Tuple[int, int], use_fine: bool = True
                ) -> Dict[str, torch.Tensor]:
        """img*: (H, W) padded to multiples of 8; hw*: the real sizes.
        Returns the coarse confidence matrix `conf` (L, S) and, each of
        length L, `idx0`, `idx1`, `mconf`, `valid`, `dy`, `dx`."""
        hc0 = (img0.shape[0] // 8, img0.shape[1] // 8)
        hc1 = (img1.shape[0] // 8, img1.shape[1] // 8)
        c0, f0 = self.backbone(img0[None, None])
        c1, f1 = self.backbone(img1[None, None])
        dev = img0.device
        pe0 = torch.as_tensor(sine_position_encoding(*hc0), device=dev)
        pe1 = torch.as_tensor(sine_position_encoding(*hc1), device=dev)
        t0 = (c0[0].permute(1, 2, 0) + pe0).reshape(1, -1, D_COARSE)
        t1 = (c1[0].permute(1, 2, 0) + pe1).reshape(1, -1, D_COARSE)
        v0 = torch.as_tensor(_coarse_valid(hw0, img0.shape), device=dev)
        v1 = torch.as_tensor(_coarse_valid(hw1, img1.shape), device=dev)
        t0, t1 = self.loftr_coarse(t0, t1)
        conf = coarse_match_confidence(t0, t1, v0[None], v1[None])[0]
        idx0, idx1, mconf, valid = mutual_nearest_matches(conf, hc0, hc1)
        dy = dx = torch.zeros_like(mconf)
        if use_fine and self.has_fine:
            dy, dx = self.fine_refine(f0[0], f1[0], idx0, idx1,
                                      coarse0=t0[0], coarse1=t1[0])
        return {"conf": conf, "idx0": idx0, "idx1": idx1, "mconf": mconf,
                "valid": valid, "dy": dy, "dx": dx}


# ---------------------------------------------------------------------------
# full matcher
# ---------------------------------------------------------------------------


def _pad_to_mult8(img):
    h, w = img.shape[:2]
    H = math.ceil(h / 8) * 8
    W = math.ceil(w / 8) * 8
    out = np.zeros((H, W) + img.shape[2:], np.float32)
    out[:h, :w] = img
    return out, (h, w)


def _coarse_valid(hw_real, hw_pad) -> np.ndarray:
    """(hc*wc,) bool marking coarse cells fully inside the real image
    (the JAX package's floor on height and ceil on width)."""
    hc, wc = hw_pad[0] // 8, hw_pad[1] // 8
    hr, wr = hw_real[0] // 8, math.ceil(hw_real[1] / 8)
    m = np.zeros((hc, wc), bool)
    m[:hr, :wr] = True
    return m.reshape(-1)


class LoFTRMatcher:
    """match(img0, img1) -> {keypoints0, keypoints1, confidence} for
    grayscale [0,1] HxW numpy images — the kornia-LoFTR call surface the
    consistency metric needs — on `device` (cuda unless the caller asks
    for the CPU), fp32 under `torch.inference_mode()`."""

    def __init__(self, params: Mapping[str, Any], use_fine: bool = True,
                 device: Union[str, torch.device] = "cuda"):
        from bevgen_torch.core.device import resolve_device
        self.device = resolve_device(device)
        fine = "loftr_fine.layers.0.q_proj.weight" in params
        self.model = LoFTR(fine=fine).load_params(params).to(
            self.device).eval().requires_grad_(False)
        self.use_fine = use_fine

    @classmethod
    def from_npz(cls, npz_path: str, **kw) -> "LoFTRMatcher":
        with np.load(npz_path) as data:
            return cls({k: data[k] for k in data.files}, **kw)

    def raw(self, img0: np.ndarray, img1: np.ndarray):
        """The padded pair's outputs (`LoFTR.forward`'s dict of tensors on
        the device) and the two padded shapes."""
        p0, hw0 = _pad_to_mult8(np.asarray(img0, np.float32))
        p1, hw1 = _pad_to_mult8(np.asarray(img1, np.float32))
        with torch.inference_mode():
            out = self.model(torch.as_tensor(p0, device=self.device),
                             torch.as_tensor(p1, device=self.device),
                             hw0, hw1, self.use_fine)
        return out, p0.shape, p1.shape

    def __call__(self, img0: np.ndarray, img1: np.ndarray):
        out, s0, s1 = self.raw(img0, img1)
        idx0, idx1, mconf, valid, dy, dx = (
            out[k].cpu().numpy()
            for k in ("idx0", "idx1", "mconf", "valid", "dy", "dx"))
        keep = valid.astype(bool)
        wc0 = s0[1] // 8
        wc1 = s1[1] // 8
        i0, i1 = idx0[keep], idx1[keep]
        # coarse cell centres in original pixels (scale 8), + fine delta
        # on image1 (scale: fine grid is 1/2 res -> 2 px per fine cell)
        k0 = np.stack([(i0 % wc0) * 8, (i0 // wc0) * 8], -1).astype(np.float32)
        k1 = np.stack([(i1 % wc1) * 8 + dx[keep] * 2,
                       (i1 // wc1) * 8 + dy[keep] * 2], -1).astype(np.float32)
        return {"keypoints0": k0, "keypoints1": k1,
                "confidence": mconf[keep].astype(np.float32)}


# ---------------------------------------------------------------------------
# weight conversion (kornia / original-repo checkpoint -> npz)
# ---------------------------------------------------------------------------


def convert_loftr_weights(ckpt_path: str, out_npz: str,
                          self_check: bool = True) -> Dict[str, np.ndarray]:
    """Convert a LoFTR checkpoint (kornia's loftr_outdoor.ckpt or the
    original repo's, either raw or under 'state_dict' with an optional
    'matcher.' prefix) to the npz of the JAX package's converter.

    Layout changes only: conv (O,I,kh,kw)->(kh,kw,I,O), linear
    (O,I)->(I,O); everything else copies. A checkpoint without the
    expected keys fails loudly, never half-converted."""
    blob = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    sd = blob.get("state_dict", blob)
    out: Dict[str, np.ndarray] = {}
    skipped = []
    for key, ten in sd.items():
        k = key[len("matcher."):] if key.startswith("matcher.") else key
        a = ten.detach().numpy()
        if k.endswith("num_batches_tracked"):
            continue
        if not k.startswith(_PREFIXES):
            skipped.append(k)  # e.g. pos_encoding buffers (recomputed)
            continue
        if a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)           # conv -> HWIO
        elif a.ndim == 2 and k.endswith(".weight"):
            a = a.T                               # linear -> (I, O)
        out[k] = a
    missing = [k for k in ("backbone.conv1.weight",
                           "loftr_coarse.layers.0.q_proj.weight")
               if k not in out]
    if missing:
        raise ValueError(
            f"checkpoint at {ckpt_path} lacks expected LoFTR keys "
            f"{missing}; found prefixes: "
            f"{sorted({k.split('.')[0] for k in sd})}")
    if skipped:
        print(f"[loftr] skipped {len(skipped)} non-weight keys "
              f"(pos-encoding buffers etc): {skipped[:5]}")
    np.savez(out_npz, **out)
    if self_check:
        _converter_self_check(ckpt_path, out)
    return out


def _converter_self_check(ckpt_path: str, params: Dict[str, np.ndarray],
                          atol: float = 5e-3):
    """Run kornia's LoFTR and this port on the same random pair (on the
    CPU) and assert the match confidences agree; skipped when kornia is
    not importable."""
    try:
        from kornia.feature import LoFTR as KorniaLoFTR
    except ImportError:
        print("[loftr] kornia not importable — converter self-check "
              "skipped (run it wherever kornia + the ckpt live)")
        return
    matcher = KorniaLoFTR(pretrained=None)
    blob = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    sd = blob.get("state_dict", blob)
    sd = {k[len("matcher."):] if k.startswith("matcher.") else k: v
          for k, v in sd.items()}
    matcher.load_state_dict(sd)
    matcher.eval()
    rng = np.random.default_rng(0)
    a = rng.random((128, 128), np.float32)
    b = np.roll(a, 4, axis=1)
    with torch.inference_mode():
        ref = matcher({"image0": torch.from_numpy(a)[None, None],
                       "image1": torch.from_numpy(b)[None, None]})
    ours = LoFTRMatcher(params, device="cpu")(a, b)
    ref_conf = np.sort(ref["confidence"].numpy())
    our_conf = np.sort(ours["confidence"])
    n = min(len(ref_conf), len(our_conf))
    assert n > 0, "self-check produced no matches on either side"
    err = float(np.abs(ref_conf[-n:] - our_conf[-n:]).max())
    assert err < atol, f"loftr converter self-check failed: {err}"
    print(f"[loftr] self-check ok: {n} matches, max conf err {err:.2e}")


def init_random_params(rng: np.random.Generator,
                       fine: bool = True) -> Dict[str, np.ndarray]:
    """Random parameter tree with the exact converted-checkpoint structure
    (the JAX package's, leaf for leaf from the same generator) — lets the
    matcher and the consistency metric run without the checkpoint."""
    p: Dict[str, np.ndarray] = {}

    def conv(name, ci, co, k):
        p[f"{name}.weight"] = (rng.standard_normal((k, k, ci, co))
                               * (1.0 / math.sqrt(k * k * ci))
                               ).astype(np.float32)

    def bn(name, c):
        p[f"{name}.weight"] = np.ones(c, np.float32)
        p[f"{name}.bias"] = np.zeros(c, np.float32)
        p[f"{name}.running_mean"] = np.zeros(c, np.float32)
        p[f"{name}.running_var"] = np.ones(c, np.float32)

    def block(name, ci, co, downsample):
        conv(f"{name}.conv1", ci, co, 3)
        bn(f"{name}.bn1", co)
        conv(f"{name}.conv2", co, co, 3)
        bn(f"{name}.bn2", co)
        if downsample:
            conv(f"{name}.downsample.0", ci, co, 1)
            bn(f"{name}.downsample.1", co)

    d0, d1, d2 = BLOCK_DIMS
    conv("backbone.conv1", 1, INITIAL_DIM, 7)
    bn("backbone.bn1", INITIAL_DIM)
    block("backbone.layer1.0", INITIAL_DIM, d0, False)
    block("backbone.layer1.1", d0, d0, False)
    block("backbone.layer2.0", d0, d1, True)
    block("backbone.layer2.1", d1, d1, False)
    block("backbone.layer3.0", d1, d2, True)
    block("backbone.layer3.1", d2, d2, False)
    conv("backbone.layer3_outconv", d2, d2, 1)
    conv("backbone.layer2_outconv", d1, d2, 1)
    conv("backbone.layer2_outconv2.0", d2, d2, 3)
    bn("backbone.layer2_outconv2.1", d2)
    conv("backbone.layer2_outconv2.3", d2, d1, 3)
    conv("backbone.layer1_outconv", d0, d1, 1)
    conv("backbone.layer1_outconv2.0", d1, d1, 3)
    bn("backbone.layer1_outconv2.1", d1)
    conv("backbone.layer1_outconv2.3", d1, d0, 3)

    def lin(name, ci, co, bias=False):
        p[f"{name}.weight"] = (rng.standard_normal((ci, co))
                               / math.sqrt(ci)).astype(np.float32)
        if bias:
            p[f"{name}.bias"] = np.zeros(co, np.float32)

    def ln(name, c):
        p[f"{name}.weight"] = np.ones(c, np.float32)
        p[f"{name}.bias"] = np.zeros(c, np.float32)

    def enc_layer(name, d):
        lin(f"{name}.q_proj", d, d)
        lin(f"{name}.k_proj", d, d)
        lin(f"{name}.v_proj", d, d)
        lin(f"{name}.merge", d, d)
        lin(f"{name}.mlp.0", 2 * d, 2 * d)
        lin(f"{name}.mlp.2", 2 * d, d)
        ln(f"{name}.norm1", d)
        ln(f"{name}.norm2", d)

    for i in range(len(COARSE_LAYERS)):
        enc_layer(f"loftr_coarse.layers.{i}", D_COARSE)
    if fine:
        for i in range(len(FINE_LAYERS)):
            enc_layer(f"loftr_fine.layers.{i}", D_FINE)
        lin("fine_preprocess.down_proj", D_COARSE, D_FINE, bias=True)
        lin("fine_preprocess.merge_feat", 2 * D_FINE, D_FINE, bias=True)
    return p
