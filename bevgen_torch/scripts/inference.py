"""Benchmark-and-trace CLI: one model call, timed, with its peak memory and
optionally a trace. The counterpart of `bevgen_tpu/scripts/inference.py`,
mode for mode.

    python -m bevgen_torch.scripts.inference preset=argoverse_muse \\
        mode=forward|train|decode batch_size=8 profile=true
    python -m bevgen_torch.scripts.inference preset=nuscenes_ar \\
        mode=ar_decode batch_size=1 reps=1 transformer.num_layers=4
    python -m bevgen_torch.scripts.inference preset=tiny_test mode=stage1_train \\
        device=cpu reps=1

Modes, each on seeded random weights in bf16 compute:
  forward         MaskGit logits;
  train           the gradient of `maskgit_loss` (forward and backward, no
                  optimizer step);
  decode          `maskgit.generate`;
  stage1_recon    the RGB VQ model's reconstruction;
  stage1_train    one VQ-GAN step with the PatchGAN discriminator (no
                  LPIPS term), Adam at lr 1e-4, under bf16 autocast with
                  fp32 parameters;
  ar_train        the gradient of the deterministic `ar_loss`;
  ar_decode       `ar_sample_cached`, top_k=100;
  ar_decode_int8  the same on the `quantize_gpt_tree` int8 weights;
  ar_decode_full  `ar.ar_sample` (one full forward per token), top_k=100.

Inputs are the JAX script's numbers (`draw_inputs`: `np.random.default_rng(0)`
in its order). Every call that draws (train, decode, the AR decodes) re-seeds
its generator first, as the JAX script passes one key to every call. The
stage-1 step advances its state in place, where the JAX script restarts each
call from the same state: the work per call is the same.

Arguments: `mode` (default forward), `batch_size` (config field, default 8),
`reps` (default 5; two warm-up calls first), `profile=true` (one more call
traced into `trace_dir`, default output/trace, as `trace.json`: CPU and CUDA
activity, CUDA only for the AR decodes), `device` (default cuda; raises
without one) or `platform=cpu|gpu` and `devices=1`, and the config keys
(`preset=`, `config=`, `modes=`, dotted overrides; default preset
argoverse_muse). An unknown mode or argument exits. The last line is one
JSON object: mode, batch_size, best_ms, mean_ms, bytes_in_use_mb,
peak_bytes_in_use_mb, bytes_limit_mb (3 decimals), and trace when profiled.
"""
from __future__ import annotations

import json
import sys
from typing import Callable, Dict, List, Optional

import numpy as np

from bevgen_torch.scripts import cli

MUSE_MODES = ("forward", "train", "decode")
STAGE1_MODES = ("stage1_train", "stage1_recon")
AR_MODES = ("ar_train", "ar_decode", "ar_decode_int8", "ar_decode_full")
AR_DECODES = ("ar_decode", "ar_decode_int8", "ar_decode_full")
MODES = MUSE_MODES + STAGE1_MODES + AR_MODES


def draw_inputs(cfg, batch_size: int, images: bool = False
                ) -> Dict[str, np.ndarray]:
    """The JAX script's inputs, from `np.random.default_rng(0)` in its order:
    tokens (b, cam, hw) and cond (b, nc) int32, the canonical rig's
    inverses, and with `images` the stage-1 images (b, H, W, 3) float32."""
    from bevgen_torch.models.geometry import canonical_rig_inverses
    tf = cfg.transformer
    rng = np.random.default_rng(0)
    out = {
        "tokens": rng.integers(0, tf.vocab_size, (
            batch_size, tf.num_cams, tf.num_cam_tokens)).astype(np.int32),
        "cond": rng.integers(0, tf.cond_vocab_size, (
            batch_size, tf.num_cond_tokens)).astype(np.int32),
    }
    out["intrinsics_inv"], out["extrinsics_inv"] = canonical_rig_inverses(
        tf, batch_size)
    if images:
        H, W = cfg.first_stage.cam_res
        out["images"] = rng.normal(0, 1, (batch_size, H, W, 3)).astype(
            np.float32)
    return out


def muse_call(mode: str, cfg, x: dict, dev) -> Callable:
    import torch
    from bevgen_torch.models.init import init_weights
    from bevgen_torch.models.stage2.maskgit import (MaskGit, generate,
                                                    maskgit_loss)
    # training keeps fp32 parameters, as the port's trainer does
    param_dtype = torch.float32 if mode == "train" else None
    model = init_weights(MaskGit(cfg.transformer, cfg.muse, torch.bfloat16,
                                 param_dtype), 0).to(dev)
    tokens, cond, ii, ei = x["tokens"], x["cond"], x["ii"], x["ei"]
    gen = torch.Generator(device=dev)
    if mode == "forward":
        def run():
            with torch.inference_mode():
                return model(tokens, cond, ii, ei).logits
    elif mode == "train":
        params = [p for p in model.parameters() if p.requires_grad]

        def run():
            gen.manual_seed(1)
            loss = maskgit_loss(model, tokens, cond, ii, ei, generator=gen).loss
            return torch.autograd.grad(loss, params, allow_unused=True)
    else:
        def run():
            return generate(model, cond, ii, ei, gen.manual_seed(1))
    return run


def stage1_call(mode: str, cfg, x: dict, dev) -> Callable:
    import torch
    from bevgen_torch.models.discriminator import NLayerDiscriminator
    from bevgen_torch.models.init import init_weights
    from bevgen_torch.models.stage1.vq import VQModel
    from bevgen_torch.training import stage1_trainer
    imgs = x["images"]
    if mode == "stage1_recon":
        s1 = init_weights(VQModel(cfg.first_stage, torch.bfloat16), 0).to(dev)

        def run():
            with torch.inference_mode():
                return s1(imgs)[0]
        return run
    s1 = init_weights(VQModel(cfg.first_stage), 0).to(dev)
    disc = init_weights(NLayerDiscriminator(
        in_channels=cfg.first_stage.in_channels), 1).to(dev)
    state = stage1_trainer.create_stage1_state(s1, disc, lr=1e-4)
    step = stage1_trainer.make_vqgan_train_step()

    def run():
        # bf16 compute on fp32 parameters: flax's dtype=bfloat16
        with torch.autocast(dev.type, torch.bfloat16):
            return step(state, imgs)
    return run


def ar_call(mode: str, cfg, x: dict, dev) -> Callable:
    import torch
    from bevgen_torch.core.convert import export_jax_params, load_jax_params
    from bevgen_torch.models.init import init_weights
    from bevgen_torch.models.stage2 import ar
    from bevgen_torch.models.stage2.ar_cached import ar_sample_cached
    from bevgen_torch.models.stage2.gpt import SparseGPT
    from bevgen_torch.ops.quant import quantize_gpt_tree
    tf = cfg.transformer
    param_dtype = torch.float32 if mode == "ar_train" else None
    gpt = init_weights(SparseGPT(tf, torch.bfloat16, param_dtype), 0).to(dev)
    if mode == "ar_decode_int8":
        # int8 weights halve the bytes the cached decode's products read
        int8 = SparseGPT(tf.replace(quant="int8"), torch.bfloat16).to(dev)
        gpt = load_jax_params(int8, quantize_gpt_tree(export_jax_params(gpt)))
    gpt.eval()
    tokens, cond, ii, ei = x["tokens"], x["cond"], x["ii"], x["ei"]
    gen = torch.Generator(device=dev)
    if mode == "ar_train":
        params = [p for p in gpt.parameters() if p.requires_grad]

        def run():
            loss = ar.ar_loss(gpt, tokens, cond, ii, ei, deterministic=True)
            return torch.autograd.grad(loss, params, allow_unused=True)
        return run
    sample = ar.ar_sample if mode == "ar_decode_full" else ar_sample_cached

    def run():
        return sample(gpt, cond, ii, ei, gen.manual_seed(1), top_k=100)
    return run


def main(argv: Optional[List[str]] = None) -> int:
    import torch
    from bevgen_torch.core.device import resolve_device
    from bevgen_torch.utils import profiling

    args = cli.parse_argv(sys.argv[1:] if argv is None else argv)
    device = cli.pop_device(args)
    cfg, args = cli.build_config(args, "argoverse_muse")
    mode = args.pop("mode", "forward")
    # batch_size is a PipelineConfig field, so `batch_size=N` lands in cfg
    batch_size = cfg.batch_size or 8
    reps = int(args.pop("reps", 5))
    do_profile = cli.pop_flag(args, "profile")
    trace_dir = args.pop("trace_dir", "output/trace")
    if args:
        raise SystemExit(f"unknown argument(s): {sorted(args)}")
    if mode not in MODES:
        raise SystemExit(f"unknown mode {mode}")
    dev = resolve_device(device)

    arrays = draw_inputs(cfg, batch_size, images=mode in STAGE1_MODES)
    x = {"tokens": torch.as_tensor(arrays["tokens"], device=dev).long(),
         "cond": torch.as_tensor(arrays["cond"], device=dev).long(),
         "ii": torch.as_tensor(arrays["intrinsics_inv"], device=dev),
         "ei": torch.as_tensor(arrays["extrinsics_inv"], device=dev)}
    if "images" in arrays:
        x["images"] = torch.as_tensor(arrays["images"], device=dev)
    make = (muse_call if mode in MUSE_MODES else
            stage1_call if mode in STAGE1_MODES else ar_call)
    run = make(mode, cfg, x, dev)

    stats = profiling.benchmark(run, reps=reps, device=dev)
    if do_profile:
        with profiling.trace(trace_dir, cpu=mode not in AR_DECODES, device=dev):
            run()
        stats["trace"] = trace_dir
    print(json.dumps({"mode": mode, "batch_size": batch_size,
                      **{k: round(v, 3) if isinstance(v, float) else v
                         for k, v in stats.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
