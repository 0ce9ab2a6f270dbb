"""Configuration for bevgen_torch: frozen, hashable dataclasses.

A copy of the reference config (`bevgen_tpu/core/config.py`) restricted to
what the MUSE serving path reads. Hashable configs key the lru_caches of
the geometry and mask artifacts (`models/geometry.py`, `models/masks.py`).
Field names and presets match the reference, so a preset built here and
one built there describe the same model. The reference's TPU-only knobs
(`use_fused_attention`, `use_fused_glue`, `remat`, `quant`) are not part
of the port yet.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

CAMERA_SETS: Dict[str, Tuple[str, ...]] = {
    "NUSCENES_FRONT": ("CAM_FRONT",),
    "NUSCENES_CAMERAS": (
        "CAM_FRONT", "CAM_BACK", "CAM_FRONT_RIGHT",
        "CAM_FRONT_LEFT", "CAM_BACK_RIGHT", "CAM_BACK_LEFT",
    ),
    "NUSCENES_ABLATION_CAMERAS": ("CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT"),
    "ARGOVERSE_CAMERAS": (
        "ring_side_left", "ring_front_left", "ring_front_right", "ring_side_right",
    ),
    "ARGOVERSE_FRONT_CAMERAS": ("ring_front_left", "ring_front_center", "ring_front_right"),
    "ARGOVERSE_ALL_CAMERAS": (
        "ring_side_left", "ring_front_left", "ring_front_center",
        "ring_front_right", "ring_side_right",
    ),
    # the full AV2 7-camera ring
    "ARGOVERSE_RING_CAMERAS": (
        "ring_rear_left", "ring_side_left", "ring_front_left",
        "ring_front_center", "ring_front_right", "ring_side_right",
        "ring_rear_right",
    ),
}

DATASETS = ("nuscenes", "argoverse")


def _ceil_to(x: int, m: int) -> int:
    return m * int(math.ceil(x / m))


@dataclass(frozen=True)
class Stage1Config:
    """VQ-GAN / VQ-VAE architecture config."""
    in_channels: int = 3
    out_ch: int = 3
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16,)
    resolution: int = 256
    z_channels: int = 256
    double_z: bool = False
    dropout: float = 0.0
    # quantizer
    n_embed: int = 1024
    embed_dim: int = 256
    beta: float = 0.25
    legacy_beta: bool = True
    # geometric embedding on the encoder features (off in shipped configs;
    # not ported yet — VQModel raises when it is set)
    geometric_embedding: bool = False
    cam_emd_dim: int = 256
    cam_res: Tuple[int, int] = (256, 256)
    cam_latent_res: Tuple[int, int] = (16, 16)
    # segmentation variant (VQSegmentationModel): n_labels drives in/out chans
    n_labels: Optional[int] = None

    @property
    def num_resolutions(self) -> int:
        return len(self.ch_mult)

    @property
    def downsample_factor(self) -> int:
        return 2 ** (len(self.ch_mult) - 1)

    @property
    def latent_resolution(self) -> int:
        return self.resolution // self.downsample_factor


@dataclass(frozen=True)
class MultiViewConfig:
    """Multi-view transformer config with derived token-geometry fields.

    Sequence layout: `[num_cond_tokens BEV | num_cams*h*w image | pad]`.
    """
    # model dims
    num_layers: int = 14
    num_heads: int = 16
    num_embed: int = 1024          # model (residual) width
    hidden_size: int = 1024        # attention inner width (AR GPT path)
    dim_head: int = 64             # MUSE attention head dim
    ff_mult: int = 4
    vocab_size: int = 1024
    cond_vocab_size: int = 1024
    # dropout
    embd_pdrop: float = 0.0
    resid_pdrop: float = 0.0
    attn_pdrop: float = 0.0
    # multi-camera geometry
    num_cams: int = 3
    cam_names: str = "ARGOVERSE_FRONT_CAMERAS"
    dataset: str = "argoverse"
    cam_res: Tuple[int, int] = (256, 256)
    cam_latent_res: Tuple[int, int] = (16, 16)
    bev_latent_res: Tuple[int, int] = (16, 16)
    # sparsity / masks
    window_len: int = 32
    density: float = 1.0
    sparse_block_size: int = 1
    causal_order: bool = True
    camera_bias: bool = True
    bev_embed: bool = True
    image_embed: bool = True
    legacy_prob_matrix: bool = False
    # measured camera-rig artifact (npz or torch .pt) for the geometric
    # bias path; None -> the canonical synthetic rig
    rig_path: Optional[str] = None
    # MUSE self-conditioning (not ported yet: the transformer raises)
    self_cond: bool = False
    n_unmasked: int = 0
    layout_seed: int = 0

    def __post_init__(self):
        if self.dataset not in DATASETS:
            raise ValueError(f"unknown dataset {self.dataset!r}")
        if self.cam_names not in CAMERA_SETS:
            raise ValueError(f"unknown camera set {self.cam_names!r}")
        if len(CAMERA_SETS[self.cam_names]) != self.num_cams:
            raise ValueError(
                f"{self.cam_names} has {len(CAMERA_SETS[self.cam_names])} "
                f"cams, config says {self.num_cams}")
        if self.num_embed % self.num_heads:
            raise ValueError("num_embed must be a multiple of num_heads")

    @property
    def cam_latent_h(self) -> int:
        return self.cam_latent_res[0]

    @property
    def cam_latent_w(self) -> int:
        return self.cam_latent_res[1]

    @property
    def num_cond_tokens(self) -> int:
        return self.bev_latent_res[0] * self.bev_latent_res[1]

    @property
    def num_cam_tokens(self) -> int:
        return self.cam_latent_h * self.cam_latent_w

    @property
    def num_img_tokens(self) -> int:
        return self.num_cam_tokens * self.num_cams

    @property
    def gpt_block_size(self) -> int:
        return _ceil_to(self.num_img_tokens + self.num_cond_tokens,
                        self.sparse_block_size)

    @property
    def num_pad_tokens(self) -> int:
        return self.gpt_block_size - (self.num_img_tokens + self.num_cond_tokens)

    @property
    def camera_names(self) -> Tuple[str, ...]:
        return CAMERA_SETS[self.cam_names]

    @property
    def mask_token_id(self) -> int:
        """MaskGIT [MASK] id — one past the codebook."""
        return self.vocab_size

    def replace(self, **kw) -> "MultiViewConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class MuseConfig:
    """MaskGit sampling knobs.

    Serving runs cond-only single forwards: the reference's classifier-free
    guidance cancels exactly at inference (see `models/stage2/maskgit.py`).
    `real_cfg` and `token_critic` are not ported yet; `generate` raises when
    either is set."""
    sample_iterations: int = 18
    cond_scale: float = 3.0
    real_cfg: bool = False
    cond_drop_prob: float = 0.1
    self_token_critic: bool = True
    token_critic: bool = False
    self_cond_prob: float = 0.9
    critic_loss_weight: float = 1.0
    critic_noise_scale: float = 1.0
    temperature: float = 1.0
    topk_filter_thres: float = 0.9
    no_mask_token_prob: float = 0.0


@dataclass(frozen=True)
class PipelineConfig:
    """Top-level config tying the two stages + sampling together."""
    transformer: MultiViewConfig = field(default_factory=MultiViewConfig)
    muse: MuseConfig = field(default_factory=MuseConfig)
    first_stage: Stage1Config = field(default_factory=Stage1Config)
    cond_stage: Stage1Config = field(default_factory=lambda: Stage1Config(
        in_channels=7, out_ch=7, n_labels=7))
    batch_size: Optional[int] = None
    seed: int = 0
    # compute dtype for the hot path ("bfloat16" | "float32")
    dtype: str = "bfloat16"
    base_lr: float = 4.5e-6


def argoverse_muse_config() -> PipelineConfig:
    """The shipped Argoverse MUSE pipeline (3 front cameras)."""
    tf = MultiViewConfig(
        num_layers=14, num_heads=16, num_embed=1024, hidden_size=1024,
        vocab_size=1024, cond_vocab_size=1024,
        num_cams=3, cam_names="ARGOVERSE_FRONT_CAMERAS", dataset="argoverse",
        cam_res=(256, 256), cam_latent_res=(16, 16), bev_latent_res=(16, 16),
        sparse_block_size=1, window_len=32, density=1.0,
        causal_order=True, camera_bias=True, image_embed=True, bev_embed=True,
        legacy_prob_matrix=False,
    )
    return PipelineConfig(
        transformer=tf,
        muse=MuseConfig(),
        first_stage=Stage1Config(cam_res=(256, 256), cam_latent_res=(16, 16)),
        cond_stage=Stage1Config(in_channels=7, out_ch=7, n_labels=7,
                                cam_res=(256, 256), cam_latent_res=(16, 16)),
    )


def argoverse_muse_7cam_config() -> PipelineConfig:
    """argoverse_muse scaled to the full 7-camera AV2 ring."""
    cfg = argoverse_muse_config()
    return dataclasses.replace(cfg, transformer=cfg.transformer.replace(
        num_cams=7, cam_names="ARGOVERSE_RING_CAMERAS"))


def tiny_test_config() -> PipelineConfig:
    """Small config for CPU tests: same structure, tiny dims."""
    tf = MultiViewConfig(
        num_layers=2, num_heads=2, num_embed=64, hidden_size=64, dim_head=32,
        vocab_size=32, cond_vocab_size=32,
        num_cams=3, cam_names="ARGOVERSE_FRONT_CAMERAS", dataset="argoverse",
        cam_res=(32, 32), cam_latent_res=(4, 4), bev_latent_res=(4, 4),
        sparse_block_size=1, window_len=4, density=1.0,
        causal_order=True, camera_bias=True, image_embed=True, bev_embed=True,
        legacy_prob_matrix=False,
    )
    # ch_mult length 4 -> 8x downsample: 32px -> 4x4 latents
    s1 = Stage1Config(ch=16, ch_mult=(1, 1, 2, 2), num_res_blocks=1,
                      z_channels=16, n_embed=32, embed_dim=16, resolution=32,
                      attn_resolutions=(4,), cam_res=(32, 32),
                      cam_latent_res=(4, 4))
    bev = Stage1Config(in_channels=7, out_ch=7, n_labels=7, ch=16,
                       ch_mult=(1, 1, 2, 2), num_res_blocks=1, z_channels=16,
                       n_embed=32, embed_dim=16, resolution=32,
                       attn_resolutions=(4,), cam_res=(32, 32),
                       cam_latent_res=(4, 4))
    return PipelineConfig(transformer=tf, first_stage=s1, cond_stage=bev,
                          muse=MuseConfig(sample_iterations=4))


PRESETS = {
    "argoverse_muse": argoverse_muse_config,
    "argoverse_muse_7cam": argoverse_muse_7cam_config,
    "tiny_test": tiny_test_config,
}


def apply_overrides(cfg: Any, overrides: Dict[str, Any]):
    """Apply dotted-path overrides to a (possibly nested) frozen dataclass:
    `transformer.num_layers=2 muse.sample_iterations=8`. String values
    (from the CLI) are coerced to the field's type."""
    grouped: Dict[str, Dict[str, Any]] = {}
    flat: Dict[str, Any] = {}
    for key, val in overrides.items():
        if "." in key:
            head, rest = key.split(".", 1)
            grouped.setdefault(head, {})[rest] = val
        else:
            flat[key] = val
    kw = dict(flat)
    for head, sub in grouped.items():
        kw[head] = apply_overrides(getattr(cfg, head), sub)
    coerced = {}
    fields = {f.name: f for f in dataclasses.fields(cfg)}
    for k, v in kw.items():
        if k in fields and isinstance(v, str):
            cur = getattr(cfg, k)
            if isinstance(cur, bool):
                v = v.lower() in ("1", "true", "yes")
            elif isinstance(cur, int):
                v = int(v)
            elif isinstance(cur, float):
                v = float(v)
            elif isinstance(cur, tuple):
                parts = [p for p in v.strip("[]() ").split(",") if p]
                elem = type(cur[0]) if cur else int
                v = tuple(elem(p) for p in parts)
            elif cur is None:
                # Optional fields default to None: coerce by the annotation
                ann = str(fields[k].type)
                if "int" in ann:
                    v = int(v)
                elif "float" in ann:
                    v = float(v)
                elif "bool" in ann:
                    v = v.lower() in ("1", "true", "yes")
        coerced[k] = v
    return dataclasses.replace(cfg, **coerced)
