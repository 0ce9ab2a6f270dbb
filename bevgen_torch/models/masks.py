"""The static camera-bias matrix and the block-sparse attention layouts.

Pure numpy, cached on the hashable MultiViewConfig. A copy of the parts of
the reference module (`bevgen_tpu/models/masks.py`) that the port reads:
`camera_bias_matrix` (MUSE and the AR GPT's camera bias) and
`sparse_masks` (the AR GPT's per-head block layouts and multiplicative
mask), with what they call, and `dense_attention_mask` (no caller; the
mask plots of `utils/logging.py` draw the others). The legacy probability matrix keeps the
reference's `rad2deg` of a cosine *distance*, bit for bit, and the
per-head layouts are drawn by the same numpy calls from
`cfg.layout_seed`, so they equal the reference's exactly.

Sequence layout: `[num_cond_tokens BEV | num_img_tokens image | pad]`, with
image tokens in decode order.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Tuple

import numpy as np

from bevgen_torch.core.config import MultiViewConfig
from bevgen_torch.models import geometry


def pad_with_cond(pattern: np.ndarray, n_cond: int, value) -> np.ndarray:
    """Grow a [N,N] pattern to [(c+N),(c+N)]: new top rows are 0/False,
    the full left column block is `value`."""
    n = pattern.shape[-1]
    dtype = pattern.dtype
    top = np.zeros((n_cond, n), dtype=dtype)
    out = np.concatenate([top, pattern], axis=0)
    left = np.full((out.shape[0], n_cond), value, dtype=dtype)
    return np.concatenate([left, out], axis=1)


def pattern_to_layout(mask: np.ndarray, block: int) -> np.ndarray:
    """Block-max-pool a [L,L] pattern into an [L/b, L/b] layout."""
    L = mask.shape[-1]
    assert L % block == 0
    nb = L // block
    m = mask.reshape(nb, block, nb, block)
    return m.max(axis=(1, 3)).astype(np.int64)


def layout_to_pattern(layout: np.ndarray, block: int) -> np.ndarray:
    """Kron-expand a layout back to a full pattern."""
    return np.kron(layout, np.ones((block, block), dtype=layout.dtype))


def _cosine_cdist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """scipy.spatial.distance.cdist(..., 'cosine'): 1 - cos_sim."""
    an = a / np.maximum(np.linalg.norm(a, axis=1, keepdims=True), 1e-30)
    bn = b / np.maximum(np.linalg.norm(b, axis=1, keepdims=True), 1e-30)
    return 1.0 - an @ bn.T


@lru_cache(maxsize=64)
def window_and_causal_patterns(cfg: MultiViewConfig) -> Tuple[np.ndarray, np.ndarray]:
    """(window_pattern, allowed_pattern), both [num_img, num_img] bool in
    decode-step space."""
    n = cfg.num_img_tokens
    r = np.arange(n)[:, None]
    c = np.arange(n)[None, :]
    start = np.maximum(r - cfg.window_len, 0)
    window = (start <= c) & (c <= r)
    allowed = c <= r
    return window, allowed


@lru_cache(maxsize=64)
def img_prob_matrix(cfg: MultiViewConfig) -> np.ndarray:
    """Cross-token similarity prior over image tokens, [num_img, num_img]
    float, in decode order, causally masked."""
    fwd, _ = geometry.decode_order(cfg)
    if cfg.legacy_prob_matrix:
        _, seq_to_pixel = geometry.seq_pixel_mappings(cfg)
        rows = seq_to_pixel[:, 1].astype(np.float64)
        cam_w = seq_to_pixel[:, [0, 2]]
        angles = geometry.col_angles(cfg)[cam_w[:, 0], cam_w[:, 1]].astype(np.float64)
        jj = np.stack([np.cos(angles), np.sin(angles)], axis=1)
        # deliberate reference quirk: rad2deg of a cosine *distance*
        d = np.rad2deg(_cosine_cdist(jj, jj))
        horiz = np.abs(rows[:, None] - rows[None, :])
        sigma = 4.0
        prob = np.exp(-0.5 * sigma ** -2.0 * (d + horiz))
    else:
        vecs = geometry.image_direction_vectors(cfg).astype(np.float64)
        prob = (1.0 - _cosine_cdist(vecs, vecs) + 1.0) / 2.0
    if cfg.causal_order:
        prob = prob[np.ix_(fwd, fwd)]
    _, allowed = window_and_causal_patterns(cfg)
    prob = prob.copy()
    prob[~allowed] = 0.0
    return prob.astype(np.float32)


@lru_cache(maxsize=64)
def bev_token_angles(cfg: MultiViewConfig) -> np.ndarray:
    """Ego-frame angle of each BEV latent cell, [num_cond], in [0,2pi)."""
    h, w = cfg.bev_latent_res
    hh, ww = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    y = -(hh.reshape(-1).astype(np.float64)) + (h // 2 - 0.5)
    x = ww.reshape(-1).astype(np.float64) - (w // 2 - 0.5)
    return np.mod(np.arctan2(y, x) - np.pi / 2.0, 2 * np.pi)


@lru_cache(maxsize=64)
def bev_cam_sim_matrix(cfg: MultiViewConfig) -> np.ndarray:
    """[num_img, num_cond] similarity between image tokens (decode order)
    and BEV condition tokens."""
    fwd, _ = geometry.decode_order(cfg)
    if cfg.legacy_prob_matrix:
        _, seq_to_pixel = geometry.seq_pixel_mappings(cfg)
        cam_w = seq_to_pixel[:, [0, 2]]
        angles = geometry.col_angles(cfg)[cam_w[:, 0], cam_w[:, 1]].astype(np.float64)
        angles = angles[fwd]
        a = np.stack([np.cos(angles), np.sin(angles)], axis=1)
        bev_a = bev_token_angles(cfg)
        b = np.stack([np.cos(bev_a), np.sin(bev_a)], axis=1)
        sim = 1.0 - _cosine_cdist(a, b)
        return ((sim + 1.0) / 2.0).astype(np.float32)
    bev = geometry.get_bev_grid(cfg).reshape(3, -1).T.astype(np.float64).copy()
    bev[:, 2] = 0.0
    bev /= np.maximum(np.linalg.norm(bev, axis=1, keepdims=True), 1e-30)
    vecs = geometry.image_direction_vectors(cfg).astype(np.float64)
    sim = (1.0 - _cosine_cdist(vecs, bev) + 1.0) / 2.0
    return sim[fwd, :].astype(np.float32)


@lru_cache(maxsize=64)
def camera_bias_matrix(cfg: MultiViewConfig) -> np.ndarray:
    """[gpt_block_size, gpt_block_size] additive attention-bias prior:
    cond block = 1, img/img block = causally-masked similarity prior,
    img/cond block = BEV<-camera angular similarity."""
    prob = img_prob_matrix(cfg)
    p = cfg.num_pad_tokens
    prob = np.pad(prob, ((0, p), (0, p)))
    prob = np.clip(prob, 0.0, 1.0)
    out = pad_with_cond(prob, cfg.num_cond_tokens, 1.0)
    sim = bev_cam_sim_matrix(cfg)
    end = -p if p else None
    out[cfg.num_cond_tokens:end, :cfg.num_cond_tokens] = sim
    return out.astype(np.float32)


class SparseMasks(NamedTuple):
    """Everything the sparse attention path needs.

    layouts:  [num_heads, nb, nb] int64 — per-head block layout
    allowed:  [L, L] float32 — multiplicative mask (1 keep / 0 drop)
    static_layout: [nb, nb] int64 — window+pad blocks every head keeps
    prob_layout:   [nb, nb] float32 — sampling prior over blocks
    """
    layouts: np.ndarray
    allowed: np.ndarray
    static_layout: np.ndarray
    prob_layout: np.ndarray


@lru_cache(maxsize=32)
def sparse_masks(cfg: MultiViewConfig) -> SparseMasks:
    """The full sparse-attention artifact set. Per-head random layouts are
    sampled with numpy's generator seeded from cfg.layout_seed."""
    b = cfg.sparse_block_size
    p = cfg.num_pad_tokens
    nc = cfg.num_cond_tokens

    prob = img_prob_matrix(cfg)
    prob = np.pad(prob, ((0, p), (0, p)))
    prob = np.clip(prob, 0.0, 1.0)
    prob_full = pad_with_cond(prob, nc, 0.5)
    L = prob_full.shape[0]
    nb = L // b
    prob_layout = prob_full.reshape(nb, b, nb, b).mean(axis=(1, 3)).astype(np.float32)

    window, allowed = window_and_causal_patterns(cfg)
    window = np.pad(window, ((0, p), (0, p)))
    static_pattern = pad_with_cond(window, nc, False)
    if p:
        static_pattern[-p:, 0] = True
        static_pattern[-p:, 1:] = False   # pad rows: >=1 visible key (no NaN rows)
    static_layout = pattern_to_layout(static_pattern, b)
    # every row keeps its diagonal block, so every row sees at least one
    # column (the attention kernels rely on it)
    np.fill_diagonal(static_layout, 1)

    allowed = np.pad(allowed, ((0, p), (0, p)))
    allowed_full = pad_with_cond(allowed, nc, True)
    if p:
        allowed_full[-p:, 1:] = False
    allowed_f = allowed_full.astype(np.float32)

    rng = np.random.default_rng(cfg.layout_seed)
    flat_prob = prob_layout.reshape(-1).astype(np.float64)
    layouts = []
    for _ in range(cfg.num_heads):
        target = int(nb * nb * cfg.density - static_layout.sum())
        sampled = np.zeros(nb * nb, dtype=bool)
        nnz = int(np.count_nonzero(flat_prob))
        n_take = max(0, min(target, nnz))
        if n_take > 0:
            pdist = flat_prob / flat_prob.sum()
            idx = rng.choice(nb * nb, size=n_take, replace=False, p=pdist)
            sampled[idx] = True
        sampled = sampled.reshape(nb, nb)
        sampled[prob_layout == 0] = False
        layouts.append(static_layout.astype(bool) | sampled)
    layouts = np.stack(layouts).astype(np.int64)

    return SparseMasks(layouts=layouts, allowed=allowed_f,
                       static_layout=static_layout,
                       prob_layout=prob_layout)


def dense_attention_mask(cfg: MultiViewConfig) -> np.ndarray:
    """[L, L] float 0/1 mask for the dense fallback: per-head layout OR-ed
    with causality (what the reference's mul-mask * layout achieves),
    head-independent static part only. No path of the port calls it (nor
    of the JAX package)."""
    return sparse_masks(cfg).allowed
