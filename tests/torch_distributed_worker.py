"""One rank of the port's multi-process checks (driven by
tests/test_torch_distributed.py, two ranks, in tp mode by
tests/test_torch_tensor_parallel.py, four ranks as dp=2 x tp=2, and in tp2
mode by tests/test_torch_tp_glue_int8.py, two ranks as dp=1 x tp=2: the
fused glue and int8 serving under tp; not collected by pytest).

Joins a gloo group through a file rendezvous, runs every check on the CPU
at fp32 on the inputs the parent wrote (`inputs.pt`: configs, numpy weight
trees, batches), and writes its results to `rank<r>.pt`; the parent holds
them against the JAX package and one-process runs of the port.

Usage: python tests/torch_distributed_worker.py <rank> <world> <outdir> [tp|tp2]
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


def tp_step(mesh, remat=False, cfg_key="muse", tree_key="muse_tree",
            tag="ck_tp_step"):
    """The first step's loss and merged gradients with the draws fixed, then
    STEPS sharded MaskGit steps: metrics, merged parameters, EMA and
    moments as JAX trees, the rank's own slices, the replicated parameters'
    equality; with a checkpoint tag written under `tag` (remat off)."""
    cfg = inp["configs"][cfg_key]
    cfg = dataclasses.replace(cfg, transformer=cfg.transformer.replace(
        remat=remat))
    model = MaskGit(cfg.transformer, dataclasses.replace(
        cfg.muse, cond_drop_prob=0.0), dtype=torch.float32)
    load_jax_params(model, inp[tree_key])
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
    if not remat and tag:
        mgr = CheckpointManager(str(out / tag), mesh=mesh)
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


# ---- tp2 mode: a dp=1 x tp=2 mesh, the fused glue and int8 serving ---------


def glue_forward(mesh):
    """The glue MaskGit's gathered logits, and every delta the residual +
    LayerNorm glue received (each rank's, in call order)."""
    from bevgen_torch.models.stage2 import transformer as ttr
    model = tp_model(mesh, inp["configs"]["glue"], inp["glue_tree"])
    x = data_rows(inp["logit_inputs"], mesh)
    deltas = []
    real = ttr.residual_layernorm

    def recording(x_, d, gamma):
        deltas.append(d.detach().clone())
        return real(x_, d, gamma)

    ttr.residual_layernorm = recording
    try:
        with torch.no_grad():
            logits = model(x["ids"], x["cond"], x["ii"], x["ei"]).logits
    finally:
        ttr.residual_layernorm = real
    return {"logits": logits.numpy(), "deltas": [d.numpy() for d in deltas],
            "split": tensor.is_split(model.transformer.layers_0_ff.proj_in)}


def int8_model(mesh):
    """The int8 MaskGit: the whole tree quantized, loaded, then cut."""
    from bevgen_torch.ops.quant import quantize_dense_tree
    cfg = inp["configs"]["muse"]
    model = MaskGit(cfg.transformer.replace(quant="int8"), cfg.muse,
                    dtype=torch.float32)
    load_jax_params(model, quantize_dense_tree(inp["muse_tree"]))
    return tensor.shard_module_(model, mesh)


def int8_forward(mesh):
    """The int8 MaskGit's gathered logits and slices; layer 0's row-split
    to_out and proj_out on this rank's columns of the parent's inputs, and
    the to_out row scale over tp."""
    from bevgen_torch.ops import quant as tq
    model = int8_model(mesh)
    x = data_rows(inp["logit_inputs"], mesh)
    tr = model.transformer
    prods = {}
    with torch.no_grad():
        logits = model(x["ids"], x["cond"], x["ii"], x["ei"]).logits
        for name, mod in (("to_out", tr.layers_0_attn.to_out),
                          ("proj_out", tr.layers_0_ff.proj_out)):
            full = torch.from_numpy(inp["row_split_inputs"][name])
            part = tensor.take_part(full, 1, 1, mesh.tp, mesh.tp_rank)
            prods[name] = {"out": mod(part).numpy(),
                           "split": tensor.split_axis(mod)}
            if name == "to_out":
                prods[name]["scale"] = tq.row_scale(tensor.max_over_tp(
                    tq.row_amax(part), mesh)).numpy()
    # the whole int8 tree loaded into a cut model (`load_jax_params(mesh=)`)
    # and the tree's `split_tp` slice: the slices `shard_module_` cut
    from bevgen_torch.ops.quant import quantize_dense_tree
    cfg = inp["configs"]["muse"]
    cut = tensor.shard_module_(MaskGit(cfg.transformer.replace(quant="int8"),
                                       cfg.muse, dtype=torch.float32), mesh)
    whole = quantize_dense_tree(inp["muse_tree"])
    load_jax_params(cut, whole, mesh=mesh)
    mine = flat(export_jax_params(model))
    loaded = flat(export_jax_params(cut))
    split = flat(convert.split_tp(whole["params"], mesh.tp, mesh.tp_rank))
    return {"logits": logits.numpy(), "products": prods,
            "slices": export_jax_params(model),
            "mesh_load_equal": all(np.array_equal(mine[k], loaded[k])
                                   for k in mine) and mine.keys() == loaded.keys(),
            "split_equal": all(np.array_equal(mine[k], split[k]) for k in mine)
            and mine.keys() == split.keys()}


def int8_gpt(mesh):
    """The int8 GPT cut over tp: its slices, and the fused q|k|v biases of
    `fuse_qkv` (the rank's parts)."""
    from bevgen_torch.models.stage2.ar_cached import fuse_qkv
    from bevgen_torch.ops.quant import quantize_gpt_tree
    cfg = inp["configs"]["ar_pipe"].transformer
    model = SparseGPT(cfg.replace(quant="int8"), dtype=torch.float32)
    load_jax_params(model, quantize_gpt_tree(inp["ar_pipe_tree"]["gpt"]))
    tensor.shard_module_(model, mesh)
    probe = torch.zeros(1, cfg.num_embed)
    with torch.no_grad():
        # the fused product of a zero input is its bias
        biases = [fb.qkv(probe)[0].numpy() for fb in fuse_qkv(model)]
    return {"slices": export_jax_params(model), "qkv_bias": biases}


def tp2_generates(mesh):
    """Greedy MUSE ids with the glue and with int8, and AR cached int8 ids,
    of the global fake batch through the sharded pipelines (int8: the whole
    pipeline quantized, then cut by shard_params)."""
    from bevgen_torch.data.fake import fake_batch
    ids = {}
    for name, (cfg_key, tree, quant, kw) in inp["tp2_generates"].items():
        ar = name.startswith("ar")
        cfg = inp["configs"][cfg_key]
        pipe = (ar_generate.ARPipeline if ar else generate.BEVGenPipeline
                ).create(cfg, device="cpu", dtype=torch.float32)
        load_jax_params(pipe, inp[tree])
        if quant:
            pipe = pipe.quantized()
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


def tp2_clis():
    from bevgen_torch.scripts import generate as gen_cli
    from bevgen_torch.scripts import train_stage2
    logs = {name: cli(train_stage2.main, inp["train_args"] + ["tp=2"] + args)
            for name, args in inp["train_runs"].items()}
    for name, args in inp["generate_runs"].items():
        logs[name] = cli(gen_cli.main, inp["generate_args"] + ["tp=2"] + args)
    return logs


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


if MODE in ("tp", "tp2"):
    from bevgen_torch.core import convert  # noqa: E402
    from bevgen_torch.models.stage2.maskgit import maskgit_loss  # noqa: E402
    from bevgen_torch.parallel import tensor  # noqa: E402
    from bevgen_torch.training.checkpoints import CheckpointManager  # noqa: E402
    import numpy as np  # noqa: E402
if MODE == "tp2":
    mesh = sharding.make_mesh(dp=1, tp=2)
    res = {"mesh": mesh.shape, "tp_rank": mesh.tp_rank,
           "glue": glue_forward(mesh),
           "glue_step": tp_step(mesh, cfg_key="glue", tree_key="glue_tree",
                                tag=None),
           "int8": int8_forward(mesh), "int8_gpt": int8_gpt(mesh),
           "ids": tp2_generates(mesh), "logs": tp2_clis()}
elif MODE == "tp":
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
