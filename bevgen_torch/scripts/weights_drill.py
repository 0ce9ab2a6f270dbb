"""One-command drill for every weight file the port reads from outside:
the LPIPS VGG16 and its linear heads, the FID InceptionV3, LoFTR outdoor,
the CLIP BPE vocabulary and the three published BEVGen checkpoints
(`argoverse_rgb.ckpt`, `argoverse_bev.ckpt`, `argoverse_stage_two.ckpt`).

    python -m bevgen_torch.scripts.weights_drill [--tmp DIR] [--device cpu]

The counterpart of `bevgen_tpu/scripts/weights_drill.py`. No such file
ships with the repository and none can be fetched, so for each one the
drill

  1. synthesizes a file in the real artifact's layout and format (torch
     state dicts saved with `torch.save`, a gzip merges file), from a seed;
  2. runs the port's converter or loader on it, end to end;
  3. loads the result into the consuming model and runs it on `--device`
     (the card by default; raises without one unless `--device cpu`):
     a forward, a match or a generate;
  4. prints `[drill] <name>: PASS` and the command to run on the real file.

Exit code 0 when every chain is green, 1 otherwise. The published
checkpoints are written at `tiny_test` from a seeded pipeline by
`reference_state_dict`, the inverse of the port's converters in the
reference's Lightning key layout (`tests/test_torch_checkpoint.py` holds it
to the JAX tests' oracle), and loaded into a pipeline of another seed.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gzip
import os
import re
import tempfile
import traceback
from pathlib import Path

import numpy as np
import torch

from bevgen_torch.core.convert import export_jax_params

# torchvision vgg16 `features` conv indices and channels, and the taming
# LPIPS heads' input channels (`models/lpips.py:_VGG_SLICES`)
VGG16_CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
VGG16_CHANNELS = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512,
                  512]
LPIPS_LIN_CH = [64, 128, 256, 512, 512]
# the published checkpoints are written from a pipeline of SOURCE_SEED and
# loaded into one of TARGET_SEED, so a load that does nothing fails
SOURCE_SEED, TARGET_SEED = 0, 1
# a miniature merges file in the real format: a header line, then one merge
# pair per line
CLIP_MERGES = ["#version: 0.2", "t h", "th e</w>", "h e", "he l", "hel l",
               "hell o</w>"]


# ---- the reference's Lightning checkpoint layout ---------------------------

def _flat_tree(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat_tree(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _conv_to_torch(a):
    return a.transpose(3, 2, 0, 1)          # flax HWIO -> torch OIHW


def _linear_to_torch(a):
    return a.T


def _conv1x1_to_torch(a):
    return a.T[:, :, None, None]            # Dense (in, out) -> 1x1 conv


def _tril_to_torch(a):
    return a[np.tril_indices(a.shape[0])][None]   # (L, L) -> flat tril


def _same(a):
    return a


def stage1_ref_key(path):
    """(reference torch key, layout change) of a leaf of a stage-1 flax tree
    (taming's VQModel names, modules/stage1/vqgan.py)."""
    if path == ("codebook",):
        return "quantize.embedding.weight", _same
    if path[0] in ("quant_conv", "post_quant_conv"):
        return (f"{path[0]}.weight", _conv_to_torch) if path[1] == "kernel" \
            else (f"{path[0]}.bias", _same)
    mod, name, rest = path[0], path[1], path[2:]
    m = re.fullmatch(r"(down|up)_(\d+)_(block|attn)_(\d+)", name)
    m2 = re.fullmatch(r"(down|up)_(\d+)_(downsample|upsample)", name)
    if m:
        base = f"{mod}.{m[1]}.{m[2]}.{m[3]}.{m[4]}"
    elif m2:
        base = f"{mod}.{m2[1]}.{m2[2]}.{m2[3]}"
    elif name.startswith("mid_"):
        base = f"{mod}.mid.{name[4:]}"
    else:
        base = f"{mod}.{name}"
    torch_name = {"scale": "weight", "bias": "bias", "kernel": "weight"}
    if rest[-2:-1] == ("norm",):            # GroupNorm32: <norm>/norm/<leaf>
        owner = rest[:-2]
        return ".".join((base,) + owner + (torch_name[rest[-1]],)), _same
    fn = _conv_to_torch if rest[-1] == "kernel" else _same
    return ".".join((base,) + rest[:-1] + (torch_name[rest[-1]],)), fn


def muse_ref_key(path):
    """(reference torch key, layout change) of a leaf of the MUSE
    transformer's flax tree (muse_maskgit_pytorch's TransformerMultiView)."""
    head = path[0]
    if head in ("token_emb", "cond_token_emb", "pos_emb", "cond_pos_emb"):
        return f"{head}.weight", _same
    if head == "self_cond_to_init_embed":
        idx = {"norm_in": 0, "proj_in": 1, "norm_mid": 3, "proj_out": 4}[path[1]]
        return ((f"{head}.{idx}.gamma", _same) if path[1].startswith("norm")
                else (f"{head}.{idx}.weight", _linear_to_torch))
    if head == "to_logits":
        return "to_logits.weight", _linear_to_torch
    if head in ("img_embed", "cam_embed"):
        return f"{head}.weight", _conv1x1_to_torch
    if head == "bev_embed":
        return (("bev_embed.weight", _conv1x1_to_torch) if path[1] == "kernel"
                else ("bev_embed.bias", _same))
    if head == "camera_bias_emb":
        return head, _tril_to_torch
    if head == "bev_cam_pos_emb":
        return head, _same
    if head == "final_norm":
        return "transformer_blocks.norm.gamma", _same
    m = re.fullmatch(r"layers_(\d+)_(attn|cross_attn|ff)", head)
    base = (f"transformer_blocks.layers.{m[1]}."
            f"{ {'attn': 0, 'cross_attn': 1, 'ff': 2}[m[2]] }")
    sub = path[1]
    if m[2] == "ff":
        idx = {"norm_in": 0, "proj_in": 1, "norm_mid": 3, "proj_out": 4}[sub]
        return ((f"{base}.{idx}.gamma", _same) if sub.startswith("norm")
                else (f"{base}.{idx}.weight", _linear_to_torch))
    if sub == "norm":
        return f"{base}.norm.gamma", _same
    if sub in ("to_q", "to_kv", "to_out"):
        return f"{base}.{sub}.weight", _linear_to_torch
    return f"{base}.{sub}", _same           # q_scale, k_scale, null_kv


def gpt_ref_key(path):
    """(reference torch key, layout change) of a leaf of the sparse GPT's
    flax tree (mingpt_sparse.py's GPT)."""
    head = path[0]
    if head in ("x_tok_emb", "cond_tok_emb"):
        return f"{head}.weight", _same
    if head in ("x_pos_emb", "cond_pos_emb", "bev_cam_pos_emb"):
        return head, _same
    if head == "camera_bias_emb":
        return head, _tril_to_torch
    if head in ("img_embed", "cam_embed"):
        return f"{head}.weight", _conv1x1_to_torch
    if head == "bev_embed":
        return (("bev_embed.weight", _conv1x1_to_torch) if path[1] == "kernel"
                else ("bev_embed.bias", _same))
    if head == "ln_f":
        return f"ln_f.{ {'scale': 'weight', 'bias': 'bias'}[path[-1]] }", _same
    if head == "head":
        return "head.weight", _linear_to_torch
    i = re.fullmatch(r"block_(\d+)", head)[1]
    sub, leaf = path[1], path[-1]
    if sub in ("ln1", "ln2"):
        return (f"blocks.{i}.{sub}.{ {'scale': 'weight', 'bias': 'bias'}[leaf] }",
                _same)
    owner = (f"attention.{sub}" if sub in ("query", "key", "value") else
             f"mlp.{ {'mlp_fc': 0, 'mlp_proj': 2}[sub] }")
    return ((f"blocks.{i}.{owner}.weight", _linear_to_torch) if leaf == "kernel"
            else (f"blocks.{i}.{owner}.bias", _same))


def stage1_state_dict(params, prefix: str = ""):
    """taming's `VQModel` state dict (torch key -> contiguous numpy array)
    of a stage-1 flax tree, each key after `prefix`."""
    out = {}
    for path, arr in _flat_tree(params):
        key, fn = stage1_ref_key(path)
        out[prefix + key] = np.ascontiguousarray(fn(np.asarray(arr)))
    return out


def reference_state_dict(tree):
    """The reference's Lightning state dict (torch key -> contiguous numpy
    array in torch's layout) of a serving pipeline's flax-layout tree
    (`core/convert.py:export_jax_params`): the MUSE Net2NetTransformer,
    whose SelfCritic holds `token_critic.net.*` aliases of the transformer
    (the same arrays) and a `to_pred` head, or a separate TokenCritic
    transformer at `token_critic.*`; or the AR one, whose sparse GPT sits at
    top-level `transformer.*`. The inverse of the port's converters;
    `tests/test_torch_checkpoint.py` holds it to the JAX package's test
    oracle, as does `drill_published_checkpoints` with the JAX package's
    `load_weights`."""
    out = {}

    def put(key, arr, fn):
        out[key] = np.ascontiguousarray(fn(np.asarray(arr)))
        return out[key]

    for part, prefix in (("first_stage", "first_stage_model."),
                         ("cond_stage", "cond_stage_model.")):
        out.update(stage1_state_dict(tree[part]["params"], prefix))
    if "maskgit" in tree:
        mg = tree["maskgit"]["params"]
        for path, arr in _flat_tree(mg["transformer"]):
            key, fn = muse_ref_key(path)
            gen = put("maskgit.transformer." + key, arr, fn)
            if "critic" in mg:
                out["maskgit.token_critic.net." + key] = gen
        if "critic" in mg:
            head = mg["critic"]["to_pred"]
            put("maskgit.token_critic.to_pred.weight", head["kernel"],
                _linear_to_torch)
            put("maskgit.token_critic.to_pred.bias", head["bias"], _same)
        else:
            for path, arr in _flat_tree(mg["token_critic"]):
                key, fn = muse_ref_key(path)
                put("maskgit.token_critic." + key, arr, fn)
    else:
        for path, arr in _flat_tree(tree["gpt"]["params"]):
            key, fn = gpt_ref_key(path)
            put("transformer." + key, arr, fn)
    return out


def write_reference_ckpt(pipe, path):
    """Write `pipe`'s weights as a reference Lightning `.ckpt` (fp32; the
    SelfCritic aliases share their tensors, as in the reference's files).
    Returns the file's bytes."""
    tensors, shared = {}, {}
    for key, arr in reference_state_dict(export_jax_params(pipe)).items():
        if id(arr) not in shared:
            shared[id(arr)] = torch.from_numpy(arr)
        tensors[key] = shared[id(arr)]
    torch.save({"state_dict": tensors, "epoch": 0, "global_step": 0}, path)
    return os.path.getsize(path)


def params_equal(a, b):
    """(all parameters of modules a and b equal bit for bit, how many
    differ, how many there are). Raises ValueError when they hold
    different parameters."""
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    if pa.keys() != pb.keys():
        raise ValueError("the two modules hold different parameters")
    diff = [n for n in pa if not torch.equal(pa[n], pb[n])]
    return not diff, len(diff), len(pa)


# ---- the drills --------------------------------------------------------------

def _ok(name: str, device: torch.device, *commands: str) -> None:
    print(f"[drill] {name}: PASS (forwards on {device.type})")
    for cmd in commands:
        print(f"        real artifact: {cmd}")


def drill_lpips(tmp: Path, device: torch.device) -> None:
    """torchvision's `vgg16` state dict and taming's `vgg.pth` heads through
    `convert_lpips_weights`, then `LPIPSMetric` on two images."""
    from bevgen_torch.metrics.quality import LPIPSMetric
    from bevgen_torch.models.lpips import convert_lpips_weights
    rng = np.random.default_rng(0)
    vgg_sd, cin = {}, 3
    for i, cout in zip(VGG16_CONV_IDX, VGG16_CHANNELS):
        vgg_sd[f"features.{i}.weight"] = torch.from_numpy(
            (rng.standard_normal((cout, cin, 3, 3)) * np.sqrt(2.0 / (9 * cin)))
            .astype(np.float32))
        vgg_sd[f"features.{i}.bias"] = torch.from_numpy(
            0.05 * rng.standard_normal(cout).astype(np.float32))
        cin = cout
    lin_sd = {f"lin{i}.model.1.weight": torch.from_numpy(
        np.abs(rng.standard_normal((1, c, 1, 1))).astype(np.float32))
        for i, c in enumerate(LPIPS_LIN_CH)}
    vgg_pth, lin_pth, out_npz = tmp / "vgg16.pth", tmp / "vgg.pth", tmp / "lpips.npz"
    torch.save(vgg_sd, vgg_pth)
    torch.save(lin_sd, lin_pth)
    convert_lpips_weights(str(vgg_pth), str(lin_pth), str(out_npz))
    metric = LPIPSMetric(str(out_npz), device=device)
    x, y = rng.uniform(0, 1, (2, 1, 64, 64, 3)).astype(np.float32)
    d = metric(x, y)
    if d.shape != (1,) or not np.isfinite(d).all() or not d[0] > 0:
        raise ValueError(f"LPIPS distance {d}")
    _ok("LPIPS (torchvision vgg16 + taming vgg.pth lins)", device,
        "python -c \"from bevgen_torch.models.lpips import "
        "convert_lpips_weights; convert_lpips_weights("
        "'vgg16-397923af.pth', 'vgg.pth', 'lpips.npz')\"")


def drill_inception(tmp: Path, device: torch.device) -> None:
    """pytorch-fid's `pt_inception` state dict, with the unused 1008-way
    `fc` head, through `convert_inception_weights`; the npz and the `.pth`
    must give the same model, whose pool3 features are then computed."""
    from bevgen_torch.metrics.inception import (InceptionV3,
                                                convert_inception_weights,
                                                load_inception,
                                                random_fid_state_dict)
    sd = random_fid_state_dict(1)
    pth, out_npz = tmp / "pt_inception.pth", tmp / "inception.npz"
    torch.save(sd, pth)
    convert_inception_weights(str(pth), str(out_npz))
    if any(k.startswith("fc") for k in np.load(out_npz).files):
        raise ValueError("the converter kept the fc head")
    model = load_inception(str(out_npz))
    direct = InceptionV3().load_pytorch_fid(sd)
    diff = [n for (n, a), b in zip(model.state_dict().items(),
                                   direct.state_dict().values())
            if not torch.equal(a, b)]
    if diff:
        raise ValueError(f"npz and .pth models differ at {diff[:5]}")
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 1, (1, 96, 96, 3)).astype(np.float32)).to(device)
    with torch.no_grad():
        feats = model.to(device)(x)
    if tuple(feats.shape) != (1, 2048) or not torch.isfinite(feats).all():
        raise ValueError(f"Inception features {tuple(feats.shape)}")
    _ok("FID InceptionV3 (pytorch-fid pt_inception-2015-12-05)", device,
        "python -c \"from bevgen_torch.metrics.inception import "
        "convert_inception_weights; convert_inception_weights("
        "'pt_inception-2015-12-05-6726825d.pth', 'inception.npz')\"")


def drill_loftr(tmp: Path, device: torch.device) -> None:
    """kornia's `loftr_outdoor.ckpt` layout (`matcher.`-prefixed, a
    `num_batches_tracked` buffer the converter drops) through
    `convert_loftr_weights`, leaf for leaf, then one match."""
    from bevgen_torch.metrics import loftr
    ref = loftr.init_random_params(np.random.default_rng(3))
    sd = {}
    for k, v in ref.items():
        a = np.asarray(v, np.float32)
        if a.ndim == 4:                       # HWIO -> OIHW
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 2 and k.endswith(".weight"):
            a = a.T                           # (I, O) -> (O, I)
        sd["matcher." + k] = torch.from_numpy(np.ascontiguousarray(a))
    sd["matcher.backbone.layer1.0.bn1.num_batches_tracked"] = torch.tensor(0)
    ckpt, out_npz = tmp / "loftr_outdoor.ckpt", tmp / "loftr.npz"
    torch.save({"state_dict": sd}, ckpt)
    loftr.convert_loftr_weights(str(ckpt), str(out_npz), self_check=False)
    back = dict(np.load(out_npz))
    if back.keys() != ref.keys():
        raise ValueError(f"converted keys differ: "
                         f"{sorted(set(back) ^ set(ref))[:5]}")
    for k, v in ref.items():
        if not np.array_equal(back[k], v):
            raise ValueError(f"converted {k} differs")
    matcher = loftr.LoFTRMatcher.from_npz(str(out_npz), device=device)
    rng = np.random.default_rng(4)
    m = matcher(rng.uniform(0, 1, (64, 48)).astype(np.float32),
                rng.uniform(0, 1, (64, 48)).astype(np.float32))
    if "confidence" not in m:
        raise ValueError(f"LoFTR returned {sorted(m)}")
    _ok("LoFTR outdoor (kornia loftr_outdoor.ckpt)", device,
        "python -c \"from bevgen_torch.metrics.loftr import "
        "convert_loftr_weights; convert_loftr_weights("
        "'loftr_outdoor.ckpt', 'loftr.npz')\"")


def drill_clip_vocab(tmp: Path, device: torch.device) -> None:
    """A merges file in the real gz format through `SimpleTokenizer`."""
    from bevgen_torch.utils.tokenizer import SimpleTokenizer
    path = tmp / "bpe_simple_vocab_16e6.txt.gz"
    with gzip.open(path, "wt") as f:
        f.write("\n".join(CLIP_MERGES))
    tok = SimpleTokenizer(str(path))
    ids = tok.encode("hello the world")
    if not ids or tok.decode(ids).replace(" ", "") != "hellotheworld":
        raise ValueError(f"round trip gave {tok.decode(ids)!r}")
    _ok("CLIP BPE vocab (bpe_simple_vocab_16e6.txt.gz)", device,
        "SimpleTokenizer('bpe_simple_vocab_16e6.txt.gz'): pass the file's "
        "path")


def tiny_pipeline(seed: int, device: torch.device, config=None):
    """A seeded `tiny_test` MUSE pipeline (or one of `config`) on `device`:
    fp32 on the CPU, the preset's dtype on the card."""
    from bevgen_torch.core.config import tiny_test_config
    from bevgen_torch.pipelines.generate import BEVGenPipeline
    return BEVGenPipeline.create(
        config or tiny_test_config(), device=device,
        dtype=torch.float32 if device.type == "cpu" else None).init_params(seed)


def drill_published_checkpoints(tmp: Path, device: torch.device) -> None:
    """The stage-1 files (`argoverse_rgb.ckpt`, `argoverse_bev.ckpt`) and the
    MUSE Net2Net file (`argoverse_stage_two.ckpt`) at `tiny_test`, written
    from the SOURCE_SEED pipeline and read by `load_weights` into pipelines
    of TARGET_SEED: parameters bit for bit, and the stage-2 file's pipeline
    generates the source's ids."""
    from bevgen_torch.core.config import tiny_test_config
    from bevgen_torch.data.fake import fake_batch
    from bevgen_torch.training.checkpoints import load_weights
    cfg = tiny_test_config()
    src = tiny_pipeline(SOURCE_SEED, device)
    tree = export_jax_params(src)
    for part, label in (("first_stage", "argoverse_rgb.ckpt"),
                        ("cond_stage", "argoverse_bev.ckpt")):
        path = tmp / label
        torch.save({"state_dict": {
            k: torch.from_numpy(v) for k, v in
            stage1_state_dict(tree[part]["params"]).items()}}, path)
        # load_weights grafts a bare stage-1 file into `first_stage`: for the
        # BEV VQ-VAE's file, a pipeline whose first stage is built from it
        dst = tiny_pipeline(TARGET_SEED, device, dataclasses.replace(
            cfg, first_stage=getattr(cfg, part)))
        family = load_weights(str(path), dst)
        if family != "stage1" or not params_equal(getattr(src, part),
                                                  dst.first_stage)[0]:
            raise ValueError(f"{label} did not load as {part} ({family})")

    path = tmp / "argoverse_stage_two.ckpt"
    write_reference_ckpt(src, str(path))
    dst = tiny_pipeline(TARGET_SEED, device)
    family = load_weights(str(path), dst)
    same, n_diff, n_par = params_equal(src, dst)
    if family != "muse" or not same:
        raise ValueError(f"argoverse_stage_two.ckpt loaded as {family!r}, "
                         f"{n_diff} of {n_par} parameters differ")
    batch = fake_batch(cfg, 2, seed=TARGET_SEED)
    inputs = (batch["segmentation"], batch["intrinsics_inv"],
              batch["extrinsics_inv"])
    ids = [pipe.generate_fn(*inputs, torch.Generator(device=device)
                            .manual_seed(TARGET_SEED))[1]
           for pipe in (src, dst)]
    if not torch.equal(*ids):
        raise ValueError("the loaded pipeline generates other ids")
    _ok("published BEVGen checkpoints (argoverse_rgb.ckpt, argoverse_bev.ckpt, "
        "argoverse_stage_two.ckpt)", device,
        "python -m bevgen_torch.scripts.tokenize_data preset=argoverse_muse "
        "ckpt_path=argoverse_rgb.ckpt out_dir=tokens",
        "load_weights('argoverse_bev.ckpt', pipeline) into a pipeline whose "
        "first_stage is built from cond_stage's config",
        "python -m bevgen_torch.scripts.generate preset=argoverse_muse "
        "ckpt_path=argoverse_stage_two.ckpt")


DRILLS = [drill_lpips, drill_inception, drill_loftr, drill_clip_vocab,
          drill_published_checkpoints]


def main(argv=None) -> int:
    from bevgen_torch.core.device import resolve_device
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tmp", default=None,
                    help="work directory (default: a fresh temporary one)")
    ap.add_argument("--device", default="cuda",
                    help="where the forwards run (default cuda; cpu runs the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    with contextlib.ExitStack() as stack:
        if args.tmp is None:
            tmp = Path(stack.enter_context(tempfile.TemporaryDirectory()))
        else:
            tmp = Path(args.tmp)
            tmp.mkdir(parents=True, exist_ok=True)
        failures = []
        for drill in DRILLS:
            try:
                drill(tmp, device)
            except Exception as e:  # noqa: BLE001 - report and go on
                traceback.print_exc()
                failures.append(f"{drill.__name__}: {e}")
    if failures:
        print(f"[drill] FAILED: {failures}")
        return 1
    print(f"[drill] all {len(DRILLS)} converter chains green on {device.type}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
