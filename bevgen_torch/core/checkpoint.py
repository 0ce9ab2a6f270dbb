"""The reference's torch checkpoints as flax-layout parameter trees.

Counterpart of `bevgen_tpu/core/checkpoint.py`'s converters and loader
(:32-495): they map the reference's torch `state_dict` layouts (taming
VQModel, modules/stage1/vqgan.py; the MUSE Net2NetTransformer,
modules/stage2/cond_transformer_multi_view_muse.py with
muse_maskgit_pytorch; the AR Net2NetTransformer with its sparse GPT,
cond_transformer_multi_view.py and mingpt_sparse.py) onto the JAX
package's flax parameter trees, numpy leaves, which
`core/convert.py:load_jax_params` loads into the port's modules:

  torch Linear    (out,in)        -> Dense kernel (in,out)
  torch Conv2d    (out,in,kh,kw)  -> flax Conv kernel (kh,kw,in,out)
  torch Conv2d1x1 (out,in,1,1)    -> Dense kernel (in,out)   [ray embeds]
  torch Embedding (n,d)           -> Embed embedding (n,d)
  GroupNorm/LayerNorm weight/bias -> scale/bias

The trees are equal to the JAX package's, leaf for leaf
(`tests/test_torch_checkpoint.py`). One difference: where the reference
prints and skips a key it does not know, these raise `KeyError` naming
it. The keys both skip on purpose stay skipped: training-loss and
visualisation buffers, LayerNorm `beta` zero buffers, geometry buffers
rebuilt from the config, the SelfCritic's `token_critic.net.*` aliases of
the transformer, MaskGit schedule buffers, the sparse GPT's master layout,
and the `self_cond_to_init_embed.*` keys every reference checkpoint holds
when the model runs without `self_cond`.

`load_torch_checkpoint` reads a Lightning `.ckpt`/`.pt` file or a
DeepSpeed ZeRO directory. The reference's orbax IO (:497-551) and its
discriminator converter (:356, stage-1 training) are not here.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _reject(what: str, unexpected: List[str]) -> None:
    if unexpected:
        raise KeyError(f"[{what}] {len(unexpected)} checkpoint key(s) that "
                       f"no parameter takes: {sorted(unexpected)[:8]}")


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy on the host; bf16 (which numpy lacks) as fp32,
    exactly."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


# ---------------------------------------------------------------------------
# low-level tensor layout converters
# ---------------------------------------------------------------------------


def t_linear(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.T)


def t_conv(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def t_conv1x1_to_dense(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w[:, :, 0, 0].T)


def _set(tree: Dict, path: List[str], value: np.ndarray):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


# ---------------------------------------------------------------------------
# stage-1 (taming VQModel / VQSegmentationModel)
# ---------------------------------------------------------------------------

_S1_NORM = {"weight": "scale", "bias": "bias"}


def _s1_block_name(tkey: str) -> Optional[List[str]]:
    """Map a torch stage-1 module path (sans encoder./decoder. prefix and
    sans param name) to our flax module path."""
    m = re.match(r"down\.(\d+)\.block\.(\d+)\.(.*)", tkey)
    if m:
        return [f"down_{m.group(1)}_block_{m.group(2)}"] + m.group(3).split(".")
    m = re.match(r"down\.(\d+)\.attn\.(\d+)\.(.*)", tkey)
    if m:
        return [f"down_{m.group(1)}_attn_{m.group(2)}"] + m.group(3).split(".")
    m = re.match(r"down\.(\d+)\.downsample\.conv", tkey)
    if m:
        return [f"down_{m.group(1)}_downsample", "conv"]
    m = re.match(r"up\.(\d+)\.block\.(\d+)\.(.*)", tkey)
    if m:
        return [f"up_{m.group(1)}_block_{m.group(2)}"] + m.group(3).split(".")
    m = re.match(r"up\.(\d+)\.attn\.(\d+)\.(.*)", tkey)
    if m:
        return [f"up_{m.group(1)}_attn_{m.group(2)}"] + m.group(3).split(".")
    m = re.match(r"up\.(\d+)\.upsample\.conv", tkey)
    if m:
        return [f"up_{m.group(1)}_upsample", "conv"]
    m = re.match(r"mid\.(block_1|attn_1|block_2)\.(.*)", tkey)
    if m:
        return [f"mid_{m.group(1)}"] + m.group(2).split(".")
    if tkey in ("conv_in", "conv_out"):
        return [tkey]
    if tkey == "norm_out":
        return ["norm_out"]
    return None


def convert_stage1(state: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """torch VQModel state_dict -> flax params['params'] tree."""
    out: Dict[str, Any] = {}
    unexpected = []
    for key, val in state.items():
        val = np.asarray(val, dtype=np.float32)
        parts = key.split(".")
        pname = parts[-1]
        if key == "quantize.embedding.weight":
            _set(out, ["codebook"], val)
            continue
        if parts[0] in ("quant_conv", "post_quant_conv"):
            if pname == "weight":
                _set(out, [parts[0], "kernel"], np.transpose(val, (2, 3, 1, 0)))
            else:
                _set(out, [parts[0], "bias"], val)
            continue
        if parts[0] in ("img_embed", "cam_embed"):
            # stage-1 geometric embeds are 1x1 convs in our VQModel
            # (models/stage1/vq.py:53-56), unlike the stage-2 Dense ones
            _set(out, [parts[0], "kernel"], np.transpose(val, (2, 3, 1, 0)))
            continue
        if parts[0] in ("encoder", "decoder"):
            sub = ".".join(parts[1:-1])
            path = _s1_block_name(sub)
            if path is None:
                unexpected.append(key)
                continue
            # norm layers live one level deeper in flax (GroupNorm32)
            if path[-1].startswith("norm"):
                _set(out, [parts[0], *path, "norm", _S1_NORM[pname]], val)
            elif pname == "weight":
                if val.ndim == 4:
                    _set(out, [parts[0], *path, "kernel"], t_conv(val))
                else:
                    _set(out, [parts[0], *path, "kernel"], t_linear(val))
            else:
                _set(out, [parts[0], *path, "bias"], val)
            continue
        if parts[0] in ("loss", "colorize", "image_plane"):
            continue  # training-loss / viz buffers — not model params
        unexpected.append(key)
    _reject("convert_stage1", unexpected)
    return out


# ---------------------------------------------------------------------------
# stage-2 (MUSE MultiViewTransformer + critic)
# ---------------------------------------------------------------------------

_ATTN_IDX = {"0": "attn", "1": "cross_attn"}
_FF_IDX = {"0": "norm_in", "1": "proj_in", "3": "norm_mid", "4": "proj_out"}


def convert_muse_transformer(state: Dict[str, np.ndarray],
                             self_cond: bool = False) -> Dict[str, Any]:
    """torch TransformerMultiView state_dict (keys relative to the
    transformer, e.g. 'token_emb.weight', 'transformer_blocks.layers.0.0.
    to_q.weight') -> our MultiViewTransformer params tree.

    `self_cond_to_init_embed.*` keys exist UNCONDITIONALLY in reference
    checkpoints (muse_maskgit_pytorch.py:241); they are converted when
    self_cond=True and silently dropped otherwise (the module is unused
    in that case)."""
    out: Dict[str, Any] = {}
    unexpected = []
    for key, val in state.items():
        val = np.asarray(val, dtype=np.float32)
        parts = key.split(".")
        if parts[0] == "self_cond_to_init_embed":
            if not self_cond or parts[-1] == "beta":
                continue
            sub, pname = parts[1], parts[2]
            mod = ["self_cond_to_init_embed", _FF_IDX[sub]]
            if pname == "gamma":
                _set(out, [*mod, "norm", "scale"], val)
            else:
                _set(out, [*mod, "kernel"], t_linear(val))
            continue
        if parts[0] in ("token_emb", "cond_token_emb", "pos_emb",
                        "cond_pos_emb") and parts[-1] == "weight":
            _set(out, [parts[0], "embedding"], val)
        elif key == "to_logits.weight":
            _set(out, ["to_logits", "kernel"], t_linear(val))
        elif parts[0] in ("img_embed", "cam_embed") and parts[-1] == "weight":
            _set(out, [parts[0], "kernel"], t_conv1x1_to_dense(val))
        elif parts[0] == "bev_embed":
            if parts[-1] == "weight":
                _set(out, ["bev_embed", "kernel"], t_conv1x1_to_dense(val))
            else:
                _set(out, ["bev_embed", "bias"], val)
        elif key == "bev_cam_pos_emb":
            _set(out, ["bev_cam_pos_emb"], val)
        elif key == "camera_bias_emb":
            _set(out, ["camera_bias_emb"], _scatter_tril(val))
        elif key == "norm.gamma":
            # TransformerMultiView.norm — defined but unused upstream
            continue
        elif parts[0] == "transformer_blocks":
            if parts[-1] == "beta":
                continue  # LayerNorm beta zero-buffers
            if parts[1] == "norm" and parts[2] == "gamma":
                _set(out, ["final_norm", "norm", "scale"], val)
                continue
            if parts[1] != "layers":
                unexpected.append(key)
                continue
            layer, idx = parts[2], parts[3]
            rest = parts[4:]
            if idx in _ATTN_IDX:
                mod = f"layers_{layer}_{_ATTN_IDX[idx]}"
                if rest[0] == "norm" and rest[1] == "gamma":
                    _set(out, [mod, "norm", "norm", "scale"], val)
                elif rest[0] in ("to_q", "to_kv", "to_out"):
                    _set(out, [mod, rest[0], "kernel"], t_linear(val))
                elif rest[0] in ("q_scale", "k_scale", "null_kv"):
                    _set(out, [mod, rest[0]], val)
                else:
                    unexpected.append(key)
            elif idx == "2":  # FeedForward Sequential
                mod = f"layers_{layer}_ff"
                sub = rest[0]
                if sub in ("0", "3") and rest[1] == "gamma":
                    _set(out, [mod, _FF_IDX[sub], "norm", "scale"], val)
                elif sub in ("1", "4") and rest[1] == "weight":
                    _set(out, [mod, _FF_IDX[sub], "kernel"], t_linear(val))
                else:
                    unexpected.append(key)
            else:
                unexpected.append(key)
        elif parts[0] == "beta" or key.endswith(".beta"):
            continue  # LayerNorm beta zero-buffers
        elif parts[0] == "image_plane" or parts[0] == "bev_grid":
            continue  # geometry buffers recomputed from config
        else:
            unexpected.append(key)
    _reject("convert_muse", unexpected)
    return out


def _scatter_tril(flat: np.ndarray) -> np.ndarray:
    """Reference camera_bias_emb is the flat lower triangle (1, n_tril);
    our param is the full (L, L) matrix masked by a static tril at use."""
    flat = flat[0] if flat.ndim == 2 else flat
    n = flat.shape[0]
    L = int((np.sqrt(8 * n + 1) - 1) / 2)
    assert L * (L + 1) // 2 == n, (n, L)
    full = np.zeros((L, L), np.float32)
    full[np.tril_indices(L)] = flat
    return full


_GPT_MLP = {"0": "mlp_fc", "2": "mlp_proj"}


def convert_gpt(state: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """torch AR `GPT` state_dict (mingpt_sparse.py:267-308) -> our
    SparseGPT params tree (models/stage2/gpt.py)."""
    out: Dict[str, Any] = {}
    unexpected = []
    for key, val in state.items():
        val = np.asarray(val, dtype=np.float32)
        parts = key.split(".")
        pname = parts[-1]
        if parts[0] in ("x_tok_emb", "cond_tok_emb") and pname == "weight":
            _set(out, [parts[0], "embedding"], val)
        elif key in ("x_pos_emb", "cond_pos_emb", "bev_cam_pos_emb"):
            _set(out, [key], val)
        elif key == "camera_bias_emb":
            _set(out, ["camera_bias_emb"], _scatter_tril(val))
        elif parts[0] in ("img_embed", "cam_embed") and pname == "weight":
            _set(out, [parts[0], "kernel"], t_conv1x1_to_dense(val))
        elif parts[0] == "bev_embed":
            if pname == "weight":
                _set(out, ["bev_embed", "kernel"], t_conv1x1_to_dense(val))
            else:
                _set(out, ["bev_embed", "bias"], val)
        elif parts[0] == "ln_f":
            _set(out, ["ln_f", "norm", _S1_NORM[pname]], val)
        elif key == "head.weight":
            _set(out, ["head", "kernel"], t_linear(val))
        elif parts[0] == "blocks":
            i = parts[1]
            mod = f"block_{i}"
            sub = parts[2]
            if sub in ("ln1", "ln2"):
                _set(out, [mod, sub, "norm", _S1_NORM[pname]], val)
            elif sub == "attention" and parts[3] in ("query", "key", "value"):
                if pname == "weight":
                    _set(out, [mod, parts[3], "kernel"], t_linear(val))
                else:
                    _set(out, [mod, parts[3], "bias"], val)
            elif sub == "attention" and parts[3] == "sparse_self_attention":
                continue  # master_layout buffer — rebuilt from config
            elif sub == "mlp" and parts[3] in _GPT_MLP:
                name = _GPT_MLP[parts[3]]
                if pname == "weight":
                    _set(out, [mod, name, "kernel"], t_linear(val))
                else:
                    _set(out, [mod, name, "bias"], val)
            else:
                unexpected.append(key)
        elif parts[0] in ("image_plane", "bev_grid"):
            continue  # geometry buffers recomputed from config
        else:
            unexpected.append(key)
    _reject("convert_gpt", unexpected)
    return out


def convert_net2net(state: Dict[str, np.ndarray],
                    self_cond: bool = False) -> Dict[str, Any]:
    """Full reference Net2NetTransformer checkpoint -> pipeline params:
    {'first_stage': ..., 'cond_stage': ..., 'maskgit': ...}.

    `maskgit.token_critic.*` is either a SelfCritic (net.* aliases of
    the transformer + a to_pred head) or a separate TokenCritic
    transformer (muse_maskgit_pytorch.py:388,423) — both handled."""
    state = {re.sub(r"^_forward_module\.", "", k): v for k, v in state.items()}
    groups: Dict[str, Dict[str, np.ndarray]] = {
        "first": {}, "cond": {}, "tf": {}, "critic": {}, "critic_tf": {}}
    unexpected = []
    for k, v in state.items():
        if k.startswith("first_stage_model."):
            groups["first"][k[len("first_stage_model."):]] = v
        elif k.startswith("cond_stage_model."):
            groups["cond"][k[len("cond_stage_model."):]] = v
        elif k.startswith("maskgit.transformer."):
            groups["tf"][k[len("maskgit.transformer."):]] = v
        elif k.startswith("maskgit.token_critic.net."):
            pass  # SelfCritic aliases of maskgit.transformer.*
        elif k.startswith("maskgit.token_critic.to_pred."):
            groups["critic"][k[len("maskgit.token_critic.to_pred."):]] = v
        elif k.startswith("maskgit.token_critic."):
            # a full separate TokenCritic transformer
            groups["critic_tf"][k[len("maskgit.token_critic."):]] = v
        elif k.startswith("maskgit."):
            pass  # buffers (mask schedules etc.) rebuilt from config
        else:
            unexpected.append(k)
    _reject("convert_net2net", unexpected)
    maskgit_params: Dict[str, Any] = {
        "transformer": convert_muse_transformer(groups["tf"],
                                                self_cond=self_cond)}
    if groups["critic"]:
        maskgit_params["critic"] = {"to_pred": {
            "kernel": t_linear(np.asarray(groups["critic"]["weight"],
                                          np.float32)),
            "bias": np.asarray(groups["critic"]["bias"], np.float32)}}
    if groups["critic_tf"]:
        # the TokenCritic shares the generator's config, so when the
        # model runs with self_cond it also owns self_cond params
        maskgit_params["token_critic"] = convert_muse_transformer(
            groups["critic_tf"], self_cond=self_cond)
    return {
        "first_stage": {"params": convert_stage1(groups["first"])},
        "cond_stage": {"params": convert_stage1(groups["cond"])},
        "maskgit": {"params": maskgit_params},
    }


def convert_ar_net2net(state: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Reference AR Net2NetTransformer checkpoint
    (cond_transformer_multi_view.py:30 — the sparse GPT lives at
    `self.transformer`, NOT under `maskgit.`) -> ARPipeline params:
    {'first_stage': ..., 'cond_stage': ..., 'gpt': ...}."""
    state = {re.sub(r"^_forward_module\.", "", k): v for k, v in state.items()}
    groups: Dict[str, Dict[str, np.ndarray]] = {
        "first": {}, "cond": {}, "gpt": {}}
    unexpected = []
    for k, v in state.items():
        if k.startswith("first_stage_model."):
            groups["first"][k[len("first_stage_model."):]] = v
        elif k.startswith("cond_stage_model."):
            groups["cond"][k[len("cond_stage_model."):]] = v
        elif k.startswith("transformer."):
            groups["gpt"][k[len("transformer."):]] = v
        else:
            unexpected.append(k)
    _reject("convert_ar_net2net", unexpected)
    return {
        "first_stage": {"params": convert_stage1(groups["first"])},
        "cond_stage": {"params": convert_stage1(groups["cond"])},
        "gpt": {"params": convert_gpt(groups["gpt"])},
    }


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Read a torch .ckpt/.pt file into a numpy state dict. Handles
    Lightning's {'state_dict': ...} wrapper and DeepSpeed ZeRO
    *directory* checkpoints (utils/general.py:81-116's conversion):
    for a directory, reads `<tag>/mp_rank_00_model_states.pt`'s
    `module` dict directly — ZeRO-2 shards only optimizer state, so
    model weights live whole in the rank-0 model-states file."""
    p = Path(path)
    if p.is_dir():
        # DeepSpeed names the current tag in a `latest` file; honor it
        # (lexicographic sort would pick global_step1000 over
        # global_step500 but ALSO global_step10000 over global_step9000
        # — string order is not step order). Fall back to newest mtime.
        candidates = sorted(p.rglob("*model_states.pt"))
        if not candidates:
            raise FileNotFoundError(
                f"no *model_states.pt under ZeRO dir {p}")
        latest = p / "latest"
        chosen = None
        if latest.is_file():
            tag = latest.read_text().strip()
            tagged = [c for c in candidates if tag in c.parts]
            chosen = tagged[0] if tagged else None
        if chosen is None:
            chosen = max(candidates, key=lambda c: c.stat().st_mtime)
        obj = torch.load(chosen, map_location="cpu",
                         weights_only=False)
        obj = obj.get("module", obj)
    else:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    # strip the DeepSpeed engine wrapper prefix ONCE here so every
    # downstream converter/router sees clean keys (the converters keep
    # their own idempotent strips for direct state_dict() callers)
    return {re.sub(r"^_forward_module\.", "", k): _numpy(v)
            for k, v in obj.items() if hasattr(v, "detach")}


# ---------------------------------------------------------------------------
# tree utilities
# ---------------------------------------------------------------------------


def tree_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(tree_shapes(v, p))
        else:
            out[p] = tuple(v.shape)
    return out


def verify_tree_match(converted, expected) -> Tuple[List[str], List[str]]:
    """(missing, unexpected) param paths vs a freshly-initialized tree."""
    cs, es = tree_shapes(converted), tree_shapes(expected)
    missing = sorted(set(es) - set(cs))
    unexpected = sorted(set(cs) - set(es))
    mismatched = [f"{k}: {cs[k]} != {es[k]}"
                  for k in set(cs) & set(es) if cs[k] != es[k]]
    return missing, unexpected + mismatched
