"""Stage-2 MaskGit training CLI of the PyTorch port.

    python -m bevgen_torch.scripts.train_stage2 preset=argoverse_muse \\
        steps=1000 batch_size=8 tokens_dir=/data/tokens ckpt_dir=ckpts \\
        base_lr=1e-4
    torchrun --nproc_per_node=4 -m bevgen_torch.scripts.train_stage2 \\
        preset=argoverse_muse batch_size=32 dp=4 ckpt_dir=ckpts
    torchrun --nproc_per_node=4 -m bevgen_torch.scripts.train_stage2 \\
        preset=argoverse_muse batch_size=32 dp=2 tp=2 ckpt_dir=ckpts

The counterpart of `bevgen_tpu/scripts/train_stage2.py`. Under torchrun,
`dp` and `dcn` (N or auto; `scripts/cli.py:pop_mesh`) split the global
`batch_size` over the data rows and `tp` the transformer's heads and FFN
hidden over the ranks of a row, each rank on its own card (`platform=cpu`:
gloo on the CPU): each row feeds its rows of every fake batch, or its
contiguous share of the token shards
(`parallel.distributed.host_shard_indices`), runs
`trainer.make_sharded_train_step` (tp-sliced weights, ZeRO-sliced moments
and EMA), and rank 0 alone logs and writes the checkpoints (unsliced, so a
tag resumes at any mesh); a stop signal to any rank stops every rank after
the same step. `batch_size` must divide by dcn x dp, and `tp` must divide
`transformer.num_heads`; `transformer.use_fused_glue=true` trains under tp
too (its GEGLU + LayerNorm split over each rank's hidden columns). Token
source: `tokens_dir` (shards of
`data/tokens.py`) or seeded random tokens (`fake=true`, the default when no
directory is given). The model keeps fp32 parameters and computes in the
preset's dtype (bf16); on the card every attention runs through the CUDA
kernels, forward and backward. Options: `steps` (micro-batches in all; a
resumed run continues to it), `batch_size`, `base_lr`, `scale_lr`
(accumulate x batch x base_lr), `accumulate`, `warmup_steps`, `ema_warmup`,
`ckpt_dir`, `ckpt_minutes`, `ckpt_async` (default false: write the
checkpoints from a background thread, so the loop pays only the host
snapshots; the run joins the last write before `done`), `val_tokens_dir`
with `eval_every` (and `eval_ema`, default true: validate with the EMA
weights), `log_every`, `seed`, `device` (default cuda; raises without one;
or `platform=cpu|gpu`, `devices=1`, `scripts/cli.py:pop_device`), `dp`,
`tp`, `dcn` and dotted
preset overrides (`transformer.num_layers=2`; `transformer.remat=true`
recomputes each block in the backward in place of holding its
activations). Prints one JSON line per logged step, {"step", "loss",
"ce_loss", "critic_loss", "grad_norm", "update_applied", "steps_per_sec"},
and `done`.
"""
from __future__ import annotations

import contextlib
import json
import sys
import time
from typing import Dict, Iterator, List, Optional

import numpy as np


def fake_batches(tf, batch_size: int, seed: int) -> Iterator[Dict[str, np.ndarray]]:
    """Random tokens and BEV ids on the canonical camera rig, from `seed`."""
    from bevgen_torch.models import geometry
    rng = np.random.default_rng(seed)
    intr, extr = geometry.canonical_camera_rig(tf)
    ii = np.broadcast_to(np.linalg.inv(intr.astype(np.float64)).astype(np.float32)[None],
                         (batch_size, tf.num_cams, 3, 3)).copy()
    ei = np.broadcast_to(np.linalg.inv(extr.astype(np.float64)).astype(np.float32)[None],
                         (batch_size, tf.num_cams, 4, 4)).copy()
    while True:
        yield {
            "tokens": rng.integers(0, tf.vocab_size, (
                batch_size, tf.num_cams, tf.num_cam_tokens)).astype(np.int64),
            "cond_ids": rng.integers(0, tf.cond_vocab_size, (
                batch_size, tf.num_cond_tokens)).astype(np.int64),
            "intrinsics_inv": ii, "extrinsics_inv": ei,
        }


@contextlib.contextmanager
def swapped_params(model, params):
    """Run with `params` (name -> tensor) loaded into `model`, then put the
    model's own parameters back."""
    import torch
    own = {n: p.detach().clone() for n, p in model.named_parameters()}
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(params[n])
    try:
        yield model
    finally:
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(own[n])


def main(argv: Optional[List[str]] = None) -> int:
    import torch
    from bevgen_torch.core.config import PRESETS, apply_overrides
    from bevgen_torch.core.device import resolve_device, resolve_dtype
    from bevgen_torch.data import tokens as token_data
    from bevgen_torch.models.init import init_weights
    from bevgen_torch.models.stage2.maskgit import MaskGit, maskgit_loss
    from bevgen_torch.parallel import distributed
    from bevgen_torch.scripts.cli import (parse_argv, pop_device, pop_flag,
                                          pop_mesh)
    from bevgen_torch.training import optim, trainer
    from bevgen_torch.training.checkpoints import CheckpointManager
    from bevgen_torch.training.preemption import PreemptionGuard

    args = parse_argv(sys.argv[1:] if argv is None else argv)
    preset = args.pop("preset", "argoverse_muse")
    if preset not in PRESETS:
        raise SystemExit(f"unknown preset {preset!r}; one of {sorted(PRESETS)}")
    steps = int(args.pop("steps", 1000))
    batch_size = int(args.pop("batch_size", 8))
    tokens_dir = args.pop("tokens_dir", None)
    fake = pop_flag(args, "fake", "false" if tokens_dir else "true")
    val_tokens_dir = args.pop("val_tokens_dir", None)
    eval_every = int(args.pop("eval_every", 0))
    eval_ema = pop_flag(args, "eval_ema", "true")
    base_lr = float(args.pop("base_lr", 1e-4))
    accumulate = int(args.pop("accumulate", 1))
    if pop_flag(args, "scale_lr", "false"):
        base_lr = optim.scaled_lr(base_lr, batch_size,
                                  accumulate_steps=accumulate)
        print(f"scaled base_lr -> {base_lr:.3g}")
    warmup = int(args.pop("warmup_steps", 500))
    ema_warmup = pop_flag(args, "ema_warmup", "false")
    ckpt_dir = args.pop("ckpt_dir", None)
    ckpt_minutes = float(args.pop("ckpt_minutes", 30))
    ckpt_async = pop_flag(args, "ckpt_async", "false")
    log_every = int(args.pop("log_every", 50))
    device = pop_device(args)
    mesh_args = {k: args.pop(k) for k in ("dp", "tp", "dcn") if k in args}
    seed = int(args.pop("seed", 0))
    if not fake and not tokens_dir:
        raise SystemExit("fake=false needs tokens_dir=<shard directory>")
    try:
        cfg = apply_overrides(PRESETS[preset](), args)
    except TypeError as e:
        raise SystemExit(f"unknown argument: {e}")
    tf = cfg.transformer
    mesh = pop_mesh(mesh_args, device, tf)
    ways = 1 if mesh is None else mesh.size
    if batch_size % ways:
        raise SystemExit(f"batch_size={batch_size} must be divisible by the "
                         f"data-parallel ways dcn*dp={ways} (mesh "
                         f"{mesh.shape})")
    rank = 0 if mesh is None else mesh.data_rank
    local_batch = batch_size // ways
    main_rank = mesh is None or mesh.rank == 0
    if mesh is not None and main_rank:
        print(f"mesh: {mesh.shape} over {mesh.world} processes")
    dev = resolve_device(device)

    with dev:   # the layers' own (discarded) default init runs there
        model = MaskGit(tf, cfg.muse, dtype=resolve_dtype(cfg.dtype),
                        param_dtype=torch.float32)
    init_weights(model, seed).to(dev)

    if fake:
        rows = distributed.host_shard_indices(batch_size, rank, ways)
        batches = ({k: v[rows] for k, v in b.items()}
                   for b in fake_batches(tf, batch_size, seed))
    else:
        ds = token_data.TokenDataset(tokens_dir)
        share = distributed.host_shard_indices(len(ds), rank, ways)
        loader = token_data.token_loader(
            torch.utils.data.Subset(ds, range(share.start, share.stop)),
            local_batch, shuffle=True, seed=seed)
        batches = token_data.epochs(loader, tf.num_cams)

    def on_device(batch):
        return {k: torch.as_tensor(np.asarray(v)).to(dev)
                for k, v in batch.items()}

    # the schedule ticks once per applied update; `steps` micro-batches
    # make steps // accumulate of them
    opt = optim.maskgit_optimizer(model, base_lr, warmup_steps=warmup,
                                  total_steps=max(1, steps // accumulate),
                                  accumulate_steps=accumulate)
    state = trainer.create_train_state(model, opt)
    mgr = (CheckpointManager(ckpt_dir, ckpt_minutes, async_save=ckpt_async,
                             mesh=mesh) if ckpt_dir else None)
    if mgr is not None:
        tag = mgr.restore_latest(state)
        if tag is not None and main_rank:
            print(f"resumed from {tag} at step {state.step}")
    if mesh is None:
        step_fn = trainer.make_train_step(ema_every=accumulate,
                                          ema_warmup=ema_warmup)
    else:
        step_fn, state = trainer.make_sharded_train_step(
            model, opt, mesh, state, ema_every=accumulate,
            ema_warmup=ema_warmup)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    run_validation = None
    if val_tokens_dir and eval_every:
        vloader = token_data.token_loader(
            token_data.TokenDataset(val_tokens_dir), batch_size,
            shuffle=False, drop_last=False)

        @torch.no_grad()
        def run_validation():
            # the EMA's gather is a collective: every rank takes part, and
            # the first data row alone (its tp ranks together) runs the
            # validation set
            weights = (state.ema.local() if eval_ema
                       else {n: p for n, p in model.named_parameters()})
            if rank != 0:
                return None
            losses = []
            with swapped_params(model, weights):
                model.eval()
                vgen = torch.Generator(device=dev).manual_seed(0)
                for vb in vloader:
                    vb = on_device({k: v for k, v in vb.items()
                                    if k != "sample_token"})
                    vb["tokens"] = vb["tokens"].reshape(
                        -1, tf.num_cams, tf.num_cam_tokens)
                    losses.append(float(maskgit_loss(
                        model, vb["tokens"], vb["cond_ids"],
                        vb["intrinsics_inv"], vb["extrinsics_inv"],
                        generator=vgen).ce_loss))
            return float(np.mean(losses)) if losses else float("nan")

    first = state.step
    t0 = time.perf_counter()
    with PreemptionGuard() as guard:
        for i in range(first, steps):
            metrics = step_fn(state, on_device(next(batches)), gen)
            if main_rank and ((i + 1) % log_every == 0 or i == first):
                m = {k: round(float(v), 4) for k, v in metrics.items()}
                m["steps_per_sec"] = round(
                    (i + 1 - first) / (time.perf_counter() - t0), 3)
                print(json.dumps({"step": i + 1, **m}), flush=True)
            if mgr is not None:
                mgr.save_step(i + 1, state, ema=state.ema)
            if run_validation is not None and (i + 1) % eval_every == 0:
                val = run_validation()
                if main_rank:
                    print(json.dumps({"step": i + 1, "val_ce": round(val, 4),
                                      "val_ema": eval_ema}), flush=True)
            # one decision for every rank: a signal to any of them stops all
            # after this step
            if (guard.should_stop if mesh is None
                    else mesh.any(guard.should_stop)):
                if main_rank:
                    print(json.dumps({"step": state.step, "preempted": True}))
                break
    if mgr is not None:
        # tag = completed steps: a stop before the first step must not label
        # the untrained state as trained
        mgr.save_step(state.step, state, force=True, ema=state.ema)
        mgr.wait()
    if mesh is not None:
        mesh.close()
    if main_rank:
        print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
