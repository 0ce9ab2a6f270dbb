"""One rank of the port's multi-process checks (driven by
tests/test_torch_distributed.py, two ranks, and in tp mode by
tests/test_torch_tensor_parallel.py, four ranks as dp=2 x tp=2; not
collected by pytest).

Joins a gloo group through a file rendezvous, runs every check on the CPU
at fp32 on the inputs the parent wrote (`inputs.pt`: configs, numpy weight
trees, batches), and writes its results to `rank<r>.pt`; the parent holds
them against the JAX package and one-process runs of the port.

Usage: python tests/torch_distributed_worker.py <rank> <world> <outdir> [tp]
"""
import contextlib
import dataclasses
import datetime
import io
import os
import signal
import sys
from pathlib import Path

rank, world, out = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
MODE = sys.argv[4] if len(sys.argv) > 4 else "dp"
os.environ.update(BEVGEN_NUM_PROCESSES=str(world), BEVGEN_PROCESS_ID=str(rank),
                  BEVGEN_COORDINATOR=f"file://{out / 'rendezvous'}")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

torch.set_num_threads(2 if MODE == "dp" else 1)

from bevgen_torch.core.convert import export_jax_params, load_jax_params  # noqa: E402
from bevgen_torch.models.stage2.gpt import SparseGPT  # noqa: E402
from bevgen_torch.models.stage2.maskgit import MaskGit  # noqa: E402
from bevgen_torch.parallel import distributed, sharding  # noqa: E402
from bevgen_torch.pipelines import ar_generate, generate  # noqa: E402
from bevgen_torch.training import optim, trainer  # noqa: E402

distributed.initialize(device="cpu", timeout=datetime.timedelta(seconds=240))
inp = torch.load(out / "inputs.pt", weights_only=False)   # the parent's file
LR, STEPS = inp["lr"], inp["steps"]


def rows_of(batch, mesh):
    n = len(next(iter(batch.values()))) // mesh.size
    return {k: torch.from_numpy(v[mesh.rank * n:(mesh.rank + 1) * n])
            for k, v in batch.items()}


def maskgit_steps(mesh):
    """STEPS sharded MaskGit steps on this rank's rows, the draws fixed:
    metrics, and the parameters, EMA and moments (gathered) as JAX trees."""
    cfg = inp["configs"]["muse"]
    model = MaskGit(cfg.transformer, dataclasses.replace(
        cfg.muse, cond_drop_prob=0.0), dtype=torch.float32)
    load_jax_params(model, inp["muse_tree"])
    local = rows_of(inp["muse_batch"], mesh)
    mask = local.pop("mask")
    opt = optim.maskgit_optimizer(model, LR, warmup_steps=1, total_steps=10)
    step, state = trainer.make_sharded_train_step(
        model, opt, mesh, trainer.create_train_state(model, opt),
        ema_decay=0.9)
    metrics = []
    for i in range(STEPS):
        m = step(state, local, torch.Generator().manual_seed(i),
                 mask_override=mask, gumbel_noise=torch.zeros(
                     mask.shape + (cfg.transformer.vocab_size,)))
        metrics.append({k: float(v) for k, v in m.items()})
    names = opt.state_names()
    moments = {key: export_jax_params(model, {
        names[i]: st[key] for i, st in opt.state_dict()["adam"]["state"].items()})
        for key in ("exp_avg", "exp_avg_sq")}
    return {"metrics": metrics, "params": export_jax_params(model),
            "ema": export_jax_params(model, state.ema.full()),
            "moments": moments,
            "sliced": sum(a is not None for a in opt.plan.axes.values())}


def ar_steps(mesh):
    model = SparseGPT(inp["configs"]["gpt"], dtype=torch.float32)
    load_jax_params(model, inp["gpt_tree"])
    local = rows_of(inp["gpt_batch"], mesh)
    opt = optim.maskgit_optimizer(model, LR, warmup_steps=1, total_steps=10)
    step, state = trainer.make_ar_sharded_train_step(
        model, opt, mesh, trainer.create_ar_train_state(model, opt))
    metrics = [{k: float(v) for k, v in step(state, local).items()}
               for _ in range(STEPS)]
    return {"metrics": metrics, "params": export_jax_params(model)}


def generates(mesh):
    """The sharded MUSE and AR generates of the global fake batch (rank 0's
    weights broadcast by shard_params), the ids gathered."""
    from bevgen_torch.data.fake import fake_batch
    ids = {}
    for name, (cfg_key, tree, kw, seed) in inp["generates"].items():
        ar = name.startswith("ar")
        cfg = inp["configs"][cfg_key]
        pipe = (ar_generate.ARPipeline if ar else generate.BEVGenPipeline
                ).create(cfg, device="cpu", dtype=torch.float32)
        if rank == 0:
            load_jax_params(pipe, inp[tree])
        make = (ar_generate.make_sharded_ar_generate if ar
                else generate.make_sharded_generate)
        run, shard_params, shard_batch = make(pipe, mesh)
        shard_params(pipe)
        batch = fake_batch(cfg, 2, seed=0)
        arrays = shard_batch(batch["segmentation"], batch["intrinsics_inv"],
                             batch["extrinsics_inv"])
        _, got = run(*arrays, torch.Generator().manual_seed(seed), **kw)
        ids[name] = mesh.gather_rows(got).numpy()
    return ids


def cli(main, argv):
    """A CLI's main under this group; its printed lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue().splitlines()


def clis():
    from bevgen_torch.scripts import generate as gen_cli
    from bevgen_torch.scripts import train_stage2
    base = inp["train_args"] + ["dp=2"]
    logs = {name: cli(train_stage2.main, base + args)
            for name, args in inp["train_runs"].items()}
    # the stop signal: rank 1 alone gets a SIGTERM during its second step
    calls = []
    make = trainer.make_sharded_train_step

    def signalling(*a, **k):
        step, state = make(*a, **k)

        def counted(*sa, **sk):
            calls.append(1)
            if rank == 1 and len(calls) == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return step(*sa, **sk)
        return counted, state

    trainer.make_sharded_train_step = signalling
    try:
        logs["stop"] = cli(train_stage2.main, base + [
            "steps=20", f"ckpt_dir={out / 'ck_stop'}"])
    finally:
        trainer.make_sharded_train_step = make
    for name, args in inp["generate_runs"].items():
        logs[name] = cli(gen_cli.main, inp["generate_args"] + ["dp=2"] + args)
    return logs, len(calls)


# ---- tp mode: a dp=2 x tp=2 mesh ----------------------------------------


def data_rows(batch, mesh):
    """This data row's rows of a global numpy batch, as tensors."""
    n = len(next(iter(batch.values()))) // mesh.size
    r = mesh.data_rank
    return {k: torch.from_numpy(np.asarray(v[r * n:(r + 1) * n]))
            for k, v in batch.items()}


def replicated_equal(mesh, model):
    """Whether every rank holds rank 0's parameters bit for bit where the
    model is not tp-sliced."""
    layout = tensor.tp_layout(model)
    flat = torch.cat([p.detach().reshape(-1) for n, p in
                      model.named_parameters() if n not in layout])
    ref = flat.clone()
    mesh.broadcast_([ref])
    return not mesh.any(not torch.equal(flat, ref))


def tp_model(mesh, cfg, tree, **muse):
    """A MaskGit cut to this rank's tp slices, then loaded from the full
    `tree` with `load_jax_params(mesh=)`."""
    model = MaskGit(cfg.transformer, dataclasses.replace(cfg.muse, **muse),
                    dtype=torch.float32)
    tensor.shard_module_(model, mesh)
    return load_jax_params(model, tree, mesh=mesh)


def tp_forward(mesh):
    """The gathered logits of this row's rows, the rank's slices (and the
    tree's split_tp), and the split norm_mid against the whole one."""
    cfg = inp["configs"]["muse"]
    model = tp_model(mesh, cfg, inp["muse_tree"])
    x = data_rows(inp["logit_inputs"], mesh)
    with torch.no_grad():
        logits = model(x["ids"], x["cond"], x["ii"], x["ei"]).logits
    mine = flat(export_jax_params(model))
    want = flat(convert.split_tp(inp["muse_tree"]["params"], mesh.tp,
                                 mesh.tp_rank))
    same = mine.keys() == want.keys() and all(
        np.array_equal(mine[k], want[k]) for k in mine)
    # norm_mid: this rank's columns of a (rows, F) fp32 input and gains
    h, gain = (torch.from_numpy(inp["norm_mid"][k]) for k in ("h", "gain"))
    part = tensor.take_part(h, 1, 1, mesh.tp, mesh.tp_rank)
    g = gain.clone().requires_grad_(True)
    y = tensor.layer_norm(part, tensor.take_part(tensor.copy_to_tp(g, mesh), 0,
                          1, mesh.tp, mesh.tp_rank), 1e-5, mesh)
    y.square().sum().backward()
    return {"logits": mesh.gather_rows(logits).numpy(),
            "slices_equal_split_tp": same,
            "norm_mid": tensor.gather_tp({"y": y.detach()}, {"y": (1, 1)},
                                         mesh)["y"].numpy(),
            "norm_mid_gain_grad": g.grad.numpy()}


def flat(tree, prefix=""):
    """A nested dict of arrays as {"a/b/leaf": array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def tp_step(mesh, remat=False):
    """The first step's loss and merged gradients with the draws fixed, then
    STEPS sharded MaskGit steps: metrics, merged parameters, EMA and
    moments as JAX trees, the rank's own slices, the replicated parameters'
    equality; with a checkpoint tag written (remat off)."""
    cfg = inp["configs"]["muse"]
    cfg = dataclasses.replace(cfg, transformer=cfg.transformer.replace(
        remat=remat))
    model = MaskGit(cfg.transformer, dataclasses.replace(
        cfg.muse, cond_drop_prob=0.0), dtype=torch.float32)
    load_jax_params(model, inp["muse_tree"])
    local = data_rows(inp["muse_batch"], mesh)
    mask = local.pop("mask")
    gz = torch.zeros(mask.shape + (cfg.transformer.vocab_size,))
    opt = optim.maskgit_optimizer(model, LR, warmup_steps=1, total_steps=10)
    step, state = trainer.make_sharded_train_step(
        model, opt, mesh, trainer.create_train_state(model, opt),
        ema_decay=0.9)
    model.train()
    args = [local[k] for k in ("tokens", "cond_ids", "intrinsics_inv",
                               "extrinsics_inv")]
    loss = maskgit_loss(model, *args, generator=torch.Generator().manual_seed(0),
                        mask_override=mask, gumbel_noise=gz,
                        shard=mesh.batch_shard(len(mask)))
    grads = torch.autograd.grad(loss.loss, opt.params, allow_unused=True)
    grads = mesh.sum_all([torch.zeros_like(p) if g is None else g
                          for g, p in zip(grads, opt.params)])
    grads = tensor.gather_tp(dict(zip(opt.names, grads)),
                             tensor.tp_layout(model), mesh)
    part = float(mesh.sum(loss.loss.detach()))
    metrics = []
    for i in range(STEPS):
        m = step(state, local, torch.Generator().manual_seed(i),
                 mask_override=mask, gumbel_noise=gz)
        metrics.append({k: float(v) for k, v in m.items()})
    names = opt.state_names()
    moments = {key: export_jax_params(model, {
        names[i]: st[key] for i, st in opt.state_dict()["adam"]["state"].items()})
        for key in ("exp_avg", "exp_avg_sq")}
    res = {"metrics": metrics, "loss": part,
           "grads": export_jax_params(model, grads),
           "params": export_jax_params(model, tensor.full_state_dict(
               model, mesh)),
           "ema": export_jax_params(model, state.ema.full()),
           "moments": moments, "slices": export_jax_params(model),
           "replicated_equal": replicated_equal(mesh, model),
           "sliced": len(tensor.tp_layout(model))}
    if not remat:
        mgr = CheckpointManager(str(out / "ck_tp_step"), mesh=mesh)
        mgr.save_step(STEPS, state, force=True, ema=state.ema)
    return res


def tp_ar_step(mesh):
    """The AR steps on `mesh` (the GPT whole on every rank): metrics,
    parameters, their equality over the ranks."""
    model = SparseGPT(inp["configs"]["gpt"], dtype=torch.float32)
    load_jax_params(model, inp["gpt_tree"])
    local = data_rows(inp["gpt_batch"], mesh)
    opt = optim.maskgit_optimizer(model, LR, warmup_steps=1, total_steps=10)
    step, state = trainer.make_ar_sharded_train_step(
        model, opt, mesh, trainer.create_ar_train_state(model, opt))
    metrics = [{k: float(v) for k, v in step(state, local).items()}
               for _ in range(STEPS)]
    return {"metrics": metrics, "params": export_jax_params(model),
            "equal": replicated_equal(mesh, model),
            "sliced": len(tensor.tp_layout(model))}


def tp_generates(mesh):
    """Greedy MUSE (default and TokenCritic) and AR cached ids of the global
    fake batch through the sharded pipelines, gathered."""
    from bevgen_torch.data.fake import fake_batch
    ids = {}
    for name, (cfg_key, tree, kw) in inp["tp_generates"].items():
        ar = name.startswith("ar")
        cfg = inp["configs"][cfg_key]
        pipe = (ar_generate.ARPipeline if ar else generate.BEVGenPipeline
                ).create(cfg, device="cpu", dtype=torch.float32)
        if rank == 0:
            load_jax_params(pipe, inp[tree])
        make = (ar_generate.make_sharded_ar_generate if ar
                else generate.make_sharded_generate)
        run, shard_params, shard_batch = make(pipe, mesh)
        shard_params(pipe)
        batch = fake_batch(cfg, 2, seed=0)
        arrays = shard_batch(batch["segmentation"], batch["intrinsics_inv"],
                             batch["extrinsics_inv"])
        _, got = run(*arrays, torch.Generator().manual_seed(0), **kw)
        ids[name] = mesh.gather_rows(got).numpy()
    return ids


def tp_clis():
    from bevgen_torch.scripts import generate as gen_cli
    from bevgen_torch.scripts import train_stage2
    base = inp["train_args"] + ["dp=2", "tp=2"]
    logs = {name: cli(train_stage2.main, base + args)
            for name, args in inp["train_runs"].items()}
    for name, args in inp["generate_runs"].items():
        logs[name] = cli(gen_cli.main, inp["generate_args"] + ["dp=2", "tp=2"]
                         + args)
    return logs


if MODE == "tp":
    from bevgen_torch.core import convert  # noqa: E402
    from bevgen_torch.models.stage2.maskgit import maskgit_loss  # noqa: E402
    from bevgen_torch.parallel import tensor  # noqa: E402
    from bevgen_torch.training.checkpoints import CheckpointManager  # noqa: E402
    import numpy as np  # noqa: E402
    mesh = sharding.make_mesh(dp=2, tp=2)
    res = {"mesh": mesh.shape, "tp_rank": mesh.tp_rank,
           "data_rank": mesh.data_rank, "forward": tp_forward(mesh),
           "step": tp_step(mesh), "remat": tp_step(mesh, remat=True),
           "ar": tp_ar_step(mesh),
           # the same AR steps data-parallel only: a dp=2 mesh over this
           # rank's data group (the ranks with its tp index)
           "ar_dp2": tp_ar_step(sharding.Mesh(
               1, 2, mesh.data_rank, mesh.data_group, mesh.data_group,
               mesh.device)),
           "ids": tp_generates(mesh),
           "logs": tp_clis()}
else:
    mesh = sharding.make_mesh(dp=world)
    res = {"muse": maskgit_steps(mesh),
           "dcn": maskgit_steps(sharding.make_mesh(dp=1, dcn=world)),
           "ar": ar_steps(mesh), "ids": generates(mesh)}
    res["logs"], res["stop_steps"] = clis()
torch.save(res, out / f"rank{rank}.pt")
distributed.shutdown()
