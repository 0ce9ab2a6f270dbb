"""One rank of the port's two-process data-parallel checks (driven by
tests/test_torch_distributed.py; not collected by pytest).

Joins a gloo group through a file rendezvous, runs every check on the CPU
at fp32 on the inputs the parent wrote (`inputs.pt`: configs, numpy weight
trees, batches), and writes its results to `rank<r>.pt`; the parent holds
them against the JAX package and one-process runs of the port.

Usage: python tests/torch_distributed_worker.py <rank> <world> <outdir>
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
os.environ.update(BEVGEN_NUM_PROCESSES=str(world), BEVGEN_PROCESS_ID=str(rank),
                  BEVGEN_COORDINATOR=f"file://{out / 'rendezvous'}")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

torch.set_num_threads(2)

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


mesh = sharding.make_mesh(dp=world)
res = {"muse": maskgit_steps(mesh),
       "dcn": maskgit_steps(sharding.make_mesh(dp=1, dcn=world)),
       "ar": ar_steps(mesh), "ids": generates(mesh)}
res["logs"], res["stop_steps"] = clis()
torch.save(res, out / f"rank{rank}.pt")
distributed.shutdown()
