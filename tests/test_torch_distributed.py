"""Two gloo ranks of the port on the CPU against the JAX package and
against one process (`tests/torch_distributed_worker.py` runs every check
once, in one module-scoped spawn of two processes with a file rendezvous;
the tests below read its results).

fp32 on one numpy tree loaded into both packages, the draws fixed as
`tests/torch_parity.py` fixes them:
  * the MaskGit step (`make_sharded_train_step`, 2 steps, a batch whose two
    halves mask 75% and 25% of their tokens) against the JAX
    `make_sharded_train_step` on a one-device mesh over the global batch
    (losses rtol 1e-5, parameters `assert_steps_close`) and the port's one
    process; the ranks' parameters equal bit for bit; `dcn=2, dp=1`
    equals the flat `dp=2`; the ZeRO moments gathered equal one process's;
  * the AR step likewise against the JAX `make_ar_sharded_train_step`;
  * MUSE greedy ids identical to the JAX generate and to one process, MUSE
    ids with the gumbel and critic noise on and AR sampled ids identical to
    one process, AR greedy ids identical to JAX;
  * the CLIs under two ranks: `train_stage2` (only rank 0 writes: the tag
    listing equals one process's; a two-rank tag resumes in one process
    and the reverse; `transformer.remat=true ckpt_async=true`; a SIGTERM to
    rank 1 stops both ranks at the same step) and `generate` (plain and
    `quant=int8`), whose npz trees equal one process's.
"""
import copy
import dataclasses
import json
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevgen_tpu.models.stage2 import maskgit as jmg
from bevgen_tpu.parallel import sharding as jshd
from bevgen_tpu.training import optim as joptim
from bevgen_tpu.training import trainer as jtrainer
from bevgen_torch.core.convert import export_jax_params
from bevgen_torch.data.fake import fake_batch
from bevgen_torch.training import optim as toptim
from bevgen_torch.training import trainer as ttrainer
from torch_parity import (ar_tiny_pipelines, assert_steps_close,
                          assert_trees_close, gpt_inputs, gpt_pair,
                          tiny_configs, tiny_pipelines)

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
LR = 1e-3
STEPS = 2
B = 4                 # the global batch of the train steps
WORKER_TIMEOUT_S = 240
LOSS_RTOL = 1e-5      # fp32 on both sides, sums in another order
# fp32 gradients summed over two ranks in another order than one process
# sums them: moments within 1e-5 of each leaf's largest entry
MOMENT_RTOL = 1e-5
TRAIN_ARGS = ["preset=tiny_test", "platform=cpu", "batch_size=4",
              "log_every=1", "warmup_steps=1", "dtype=float32"]
GEN_ARGS = ["preset=tiny_test", "platform=cpu", "fake=2", "batch_size=2",
            "dtype=float32", "print_config=false"]


def _muse_batch():
    """The global MaskGit batch: rows 0-1 (rank 0) mask 75% of their
    tokens, rows 2-3 (rank 1) 25%."""
    from bevgen_tpu.models.geometry import canonical_rig_inverses
    tf = tiny_configs()[1].transformer
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, tf.vocab_size, (B, tf.num_cams, tf.num_cam_tokens))
    ii, ei = canonical_rig_inverses(tf, B)
    prob = np.array([0.75, 0.75, 0.25, 0.25])[:, None, None]
    mask = rng.uniform(size=tokens.shape) < prob
    mask[..., 0] = True
    return {"tokens": tokens, "cond_ids": rng.integers(
                0, tf.cond_vocab_size, (B, tf.num_cond_tokens)),
            "intrinsics_inv": np.asarray(ii), "extrinsics_inv": np.asarray(ei),
            "mask": mask}


def _gpt_batch():
    _, _, _, tc = gpt_pair(camera_bias=True)
    ids, cond, ii, ei = gpt_inputs(tc, b=B, seed=7)
    return {"tokens": ids, "cond_ids": cond, "intrinsics_inv": ii,
            "extrinsics_inv": ei}


def _inputs(out):
    """What the ranks read: configs, weight trees, batches, CLI runs."""
    jp, params, tp = tiny_pipelines()
    _, _, tm, tc = gpt_pair(camera_bias=True)
    _, ar_params, ar_tp = ar_tiny_pipelines()
    tc_greedy = tiny_configs(greedy=True)[1]
    np_tree = partial(jax.tree_util.tree_map, np.asarray)
    return {
        "lr": LR, "steps": STEPS,
        "configs": {"muse": tp.config, "pipe": tp.config,
                    "pipe_greedy": tc_greedy, "gpt": tc,
                    "ar_pipe": ar_tp.config},
        "muse_tree": np_tree(params["maskgit"]),
        "pipe_tree": np_tree(params),
        "ar_pipe_tree": np_tree(ar_params),
        "gpt_tree": export_jax_params(tm),
        "muse_batch": _muse_batch(), "gpt_batch": _gpt_batch(),
        # name -> (config, tree, generate kwargs, generator seed)
        "generates": {"muse_greedy": ("pipe_greedy", "pipe_tree", {}, 0),
                      "muse_noise": ("pipe", "pipe_tree", {}, 4),
                      "ar_greedy": ("ar_pipe", "ar_pipe_tree", {"top_k": 1}, 0),
                      "ar_sampled": ("ar_pipe", "ar_pipe_tree", {"top_k": 8}, 4)},
        "train_args": TRAIN_ARGS,
        "train_runs": {
            "train": ["steps=2", "ckpt_minutes=0", f"ckpt_dir={out / 'ck_dp2'}"],
            "remat": ["steps=2", "ckpt_minutes=0", "ckpt_async=true",
                      "transformer.remat=true", f"ckpt_dir={out / 'ck_remat'}"],
            "resume": ["steps=3", f"ckpt_dir={out / 'ck_dp1_then_dp2'}"]},
        "generate_args": GEN_ARGS,
        "generate_runs": {"generate": [f"out={out / 'gen_dp2'}"],
                          "generate_int8": ["quant=int8",
                                            f"out={out / 'gen_int8_dp2'}"]},
    }


def _run_cli(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out.splitlines()


def _spawn(out):
    logs = [open(out / f"worker{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_distributed_worker.py"),
         str(r), str(WORLD), str(out)], cwd=REPO, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(WORLD)]
    return procs, logs


def _wait(procs, logs, out):
    """Wait for both ranks; a failing rank stops the other at once."""
    deadline = time.monotonic() + WORKER_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(
                    p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (f"rank {r} exit {p.returncode}:\n"
                                   + (out / f"worker{r}.log").read_text()[-4000:])


def _jax_maskgit_steps(batch):
    """The JAX sharded MaskGit step on a one-device mesh over the global
    batch, with the ranks' mask and an argmax for the gumbel resample."""
    jp, params, _ = tiny_pipelines()
    jmodel = jmg.MaskGit(jp.maskgit.cfg, dataclasses.replace(
        jp.maskgit.muse, cond_drop_prob=0.0), jnp.float32)
    jb = {k: jnp.asarray(batch[k], jnp.int32 if k in ("tokens", "cond_ids")
                         else jnp.float32)
          for k in ("tokens", "cond_ids", "intrinsics_inv", "extrinsics_inv")}
    mesh = jshd.make_mesh(dp=1, tp=1, devices=jax.devices()[:1])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer, "maskgit_loss", partial(
            jmg.maskgit_loss, mask_override=jnp.asarray(batch["mask"])))
        mp.setattr(jmg, "gumbel_sample",
                   lambda rng, logits, temp: jnp.argmax(logits, axis=-1))
        p = jax.tree_util.tree_map(jnp.array, params["maskgit"])
        tx = joptim.maskgit_optimizer(LR, warmup_steps=1, total_steps=10,
                                      params_example=p["params"])
        step, state = jtrainer.make_sharded_train_step(
            jmodel, tx, mesh, jtrainer.create_train_state(p, tx), ema_decay=0.9)
        metrics = []
        for i in range(STEPS):
            with mesh:
                state, m = step(state, jshd.shard_batch(jb, mesh),
                                jax.random.PRNGKey(i))
            metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.device_get(state.params["params"])


def _jax_ar_steps(batch):
    jm, jparams, _, _ = gpt_pair(camera_bias=True)
    params = jax.tree_util.tree_map(jnp.array, jparams)
    tx = joptim.maskgit_optimizer(LR, warmup_steps=1, total_steps=10,
                                  params_example=params["params"])
    mesh = jshd.make_mesh(dp=1, tp=1, devices=jax.devices()[:1])
    step, state = jtrainer.make_ar_sharded_train_step(
        jm, tx, mesh, jtrainer.create_ar_train_state(params, tx))
    metrics = []
    for _ in range(STEPS):
        with mesh:
            state, m = step(state, jshd.shard_batch(
                {k: jnp.asarray(v) for k, v in batch.items()}, mesh))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.device_get(state.params["params"])


def _port_maskgit_steps(batch):
    """The port's one-process step over the global batch."""
    _, _, tp = tiny_pipelines()
    model = copy.deepcopy(tp.maskgit)
    model.muse = dataclasses.replace(model.muse, cond_drop_prob=0.0)
    opt = toptim.maskgit_optimizer(model, LR, warmup_steps=1, total_steps=10)
    state = ttrainer.create_train_state(model, opt)
    step = ttrainer.make_train_step(ema_decay=0.9)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    mask = tb.pop("mask")
    metrics = []
    for i in range(STEPS):
        m = step(state, tb, torch.Generator().manual_seed(i), mask_override=mask,
                 gumbel_noise=torch.zeros(mask.shape + (model.cfg.vocab_size,)))
        metrics.append({k: float(v) for k, v in m.items()})
    names = opt.state_names()
    moments = {key: export_jax_params(model, {
        names[i]: st[key] for i, st in opt.state_dict()["adam"]["state"].items()})
        for key in ("exp_avg", "exp_avg_sq")}
    return {"metrics": metrics, "params": export_jax_params(model),
            "ema": export_jax_params(model, state.ema.params),
            "moments": moments}


def _port_ar_steps(batch):
    _, _, tm, _ = gpt_pair(camera_bias=True)
    model = copy.deepcopy(tm)
    opt = toptim.maskgit_optimizer(model, LR, warmup_steps=1, total_steps=10)
    state = ttrainer.create_ar_train_state(model, opt)
    step = ttrainer.make_ar_train_step()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    metrics = [{k: float(v) for k, v in step(state, tb).items()}
               for _ in range(STEPS)]
    return {"metrics": metrics, "params": export_jax_params(model)}


def _one_process_ids(inputs):
    jp, params, tp = tiny_pipelines()
    greedy = tiny_pipelines(greedy=True)[2]
    ar_jp, ar_params, ar_tp = ar_tiny_pipelines()
    out = {}
    for name, (_, _, kw, seed) in inputs["generates"].items():
        pipe = {"muse_greedy": greedy, "muse_noise": tp}.get(name, ar_tp)
        batch = fake_batch(pipe.config, 2, seed=0)
        arrays = [batch[k] for k in ("segmentation", "intrinsics_inv",
                                     "extrinsics_inv")]
        out[name] = pipe.generate_fn(*arrays, torch.Generator().manual_seed(seed),
                                     **kw)[1].numpy()
    batch = fake_batch(tp.config, 2, seed=0)
    arrays = [jnp.asarray(batch[k]) for k in ("segmentation", "intrinsics_inv",
                                              "extrinsics_inv")]
    jgreedy = tiny_pipelines(greedy=True)[0]
    out["jax_muse_greedy"] = np.asarray(jax.jit(jgreedy.generate_fn)(
        params, *arrays, jax.random.PRNGKey(0))[1])
    batch = fake_batch(ar_tp.config, 2, seed=0)
    arrays = [jnp.asarray(batch[k]) for k in ("segmentation", "intrinsics_inv",
                                              "extrinsics_inv")]
    out["jax_ar_greedy"] = np.asarray(jax.jit(lambda p, s, i, e: ar_jp.generate_fn(
        p, s, i, e, jax.random.PRNGKey(0), top_k=1))(ar_params, *arrays)[1])
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn the two ranks, compute the references meanwhile, wait."""
    from bevgen_torch.scripts import generate, train_stage2
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    out = tmp_path_factory.mktemp("dp")
    inputs = _inputs(out)
    # a one-process tag for the two ranks to resume from
    assert train_stage2.main(TRAIN_ARGS + [
        "steps=2", f"ckpt_dir={out / 'ck_dp1_then_dp2'}"]) == 0
    torch.save(inputs, out / "inputs.pt")
    procs, logs = _spawn(out)
    try:
        ref = {"jax_muse": _jax_maskgit_steps(inputs["muse_batch"]),
               "jax_ar": _jax_ar_steps(inputs["gpt_batch"]),
               "muse": _port_maskgit_steps(inputs["muse_batch"]),
               "ar": _port_ar_steps(inputs["gpt_batch"]),
               "ids": _one_process_ids(inputs)}
        # the one-process CLI runs the ranks' are held to
        for name, args in inputs["train_runs"].items():
            if name != "resume":
                args = [a.replace("ck_", "ck1_") for a in args]
                assert train_stage2.main(TRAIN_ARGS + args) == 0
        for name, args in inputs["generate_runs"].items():
            args = [a.replace("_dp2", "_dp1") for a in args]
            assert generate.main(GEN_ARGS + args) == 0
    finally:
        _wait(procs, logs, out)
        torch.set_num_threads(old)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return {"out": out, "ranks": ranks, "ref": ref, "inputs": inputs}


def _equal_trees(a, b):
    la, lb = (dict(jax.tree_util.tree_leaves_with_path(t)) for t in (a, b))
    return la.keys() == lb.keys() and all(np.array_equal(la[k], lb[k])
                                          for k in la)


def _close_metrics(got, want, keys):
    for g, w in zip(got, want):
        for k in keys:
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_TOL_FOR.get(k, 1e-5),
                                       atol=0, err_msg=k)


LOSS_TOL_FOR = {"loss": LOSS_RTOL, "ce_loss": LOSS_RTOL,
                "critic_loss": LOSS_RTOL, "grad_norm": 1e-5}


def test_maskgit_step_matches_jax_and_one_process(run):
    mask = run["inputs"]["muse_batch"]["mask"]
    half = mask.reshape(WORLD, -1).sum(1)
    assert half[0] > 2 * half[1]      # the halves mask unequal counts
    got = run["ranks"][0]["muse"]
    jmetrics, jparams = run["ref"]["jax_muse"]
    _close_metrics(got["metrics"], jmetrics, ("loss", "ce_loss", "critic_loss",
                                              "grad_norm"))
    _close_metrics(got["metrics"], run["ref"]["muse"]["metrics"],
                   ("loss", "ce_loss", "critic_loss", "grad_norm"))
    assert all(m["update_applied"] == 1.0 for m in got["metrics"])
    assert_steps_close(got["params"], jparams, LR, "dp=2 vs JAX")
    assert_steps_close(got["params"], run["ref"]["muse"]["params"], LR,
                       "dp=2 vs one process")
    assert_steps_close(got["ema"], run["ref"]["muse"]["ema"], LR, "ema")


def test_ranks_hold_equal_parameters(run):
    r0, r1 = run["ranks"]
    for key in ("muse", "dcn", "ar"):
        assert _equal_trees(r0[key]["params"], r1[key]["params"]), key
    assert _equal_trees(r0["muse"]["ema"], r1["muse"]["ema"])
    assert r0["muse"]["metrics"] == r1["muse"]["metrics"]


def test_dcn_rows_equal_the_flat_mesh(run):
    """dcn=2, dp=1 (the moments whole on each rank) against dp=2 (the
    moments sliced): the same gradient sum, the same updates."""
    r0 = run["ranks"][0]
    assert r0["dcn"]["sliced"] == 0 and r0["muse"]["sliced"] > 20
    assert r0["dcn"]["metrics"] == r0["muse"]["metrics"]
    assert _equal_trees(r0["dcn"]["params"], r0["muse"]["params"])


def test_zero_moments_gathered_equal_one_process(run):
    got = run["ranks"][0]["muse"]["moments"]
    want = run["ref"]["muse"]["moments"]
    for key in ("exp_avg", "exp_avg_sq"):
        assert_trees_close(got[key], want[key], MOMENT_RTOL, atol_min=0.0,
                           what=key)
    assert _equal_trees(got["exp_avg"], run["ranks"][1]["muse"]["moments"][
        "exp_avg"])


def test_ar_step_matches_jax_and_one_process(run):
    got = run["ranks"][0]["ar"]
    jmetrics, jparams = run["ref"]["jax_ar"]
    _close_metrics(got["metrics"], jmetrics, ("loss", "grad_norm"))
    _close_metrics(got["metrics"], run["ref"]["ar"]["metrics"],
                   ("loss", "grad_norm"))
    # the key bias's gradient is fp32 noise on every side (the softmax
    # ignores it; tests/test_torch_ar_train.py): Adam's bound
    for want in (jparams, run["ref"]["ar"]["params"]):
        g, w = copy.deepcopy(got["params"]), copy.deepcopy(want)
        for i in range(len([k for k in g if k.startswith("block_")])):
            a, b = g[f"block_{i}"]["key"].pop("bias"), w[f"block_{i}"]["key"].pop("bias")
            assert np.abs(a - np.asarray(b)).max() <= 2 * LR
        assert_steps_close(g, w, LR, "ar params")


@pytest.mark.parametrize("name", ["muse_greedy", "muse_noise", "ar_greedy",
                                  "ar_sampled"])
def test_generate_ids_equal_one_process(run, name):
    got = run["ranks"][0]["ids"][name]
    np.testing.assert_array_equal(got, run["ranks"][1]["ids"][name])
    np.testing.assert_array_equal(got, run["ref"]["ids"][name])
    if name in ("muse_greedy", "ar_greedy"):
        np.testing.assert_array_equal(got, run["ref"]["ids"]["jax_" + name])


def _listing(d):
    return sorted(str(p.relative_to(d)) for p in Path(d).rglob("*"))


def _logs(lines):
    return [json.loads(x) for x in lines if x.startswith("{")]


@pytest.mark.parametrize("name", ["train", "remat"])
def test_train_cli_two_ranks_write_what_one_process_writes(run, name):
    out, logs = run["out"], run["ranks"][0]["logs"][name]
    assert logs[-1] == "done" and run["ranks"][1]["logs"][name] == []
    two, one = out / f"ck_{'dp2' if name == 'train' else 'remat'}", \
        out / f"ck1_{'dp2' if name == 'train' else 'remat'}"
    assert _listing(two) == _listing(one) and (two / "LATEST").exists()
    for tag in ("step_00000002", "step_00000002-EMA"):
        f = "state.pt" if not tag.endswith("EMA") else "params.pt"
        a = torch.load(two / tag / f, weights_only=False)
        b = torch.load(one / tag / f, weights_only=False)
        pa, pb = (x["params"] if "params" in x else x for x in (a, b))
        assert pa.keys() == pb.keys()
        for k in pa:
            torch.testing.assert_close(pa[k], pb[k], rtol=0,
                                       atol=2 * LR, msg=k)
        if "optimizer" in a:
            sa, sb = a["optimizer"]["adam"]["state"], b["optimizer"]["adam"]["state"]
            assert sa.keys() == sb.keys()
            for i in sa:
                assert sa[i]["exp_avg"].shape == sb[i]["exp_avg"].shape
    steps = [r["step"] for r in _logs(logs) if "loss" in r]
    assert steps == [1, 2]


def test_tags_resume_across_rank_counts(run, capsys):
    from bevgen_torch.scripts import train_stage2
    logs = run["ranks"][0]["logs"]["resume"]
    assert any(x.startswith("resumed from") and "step 2" in x for x in logs)
    assert [r["step"] for r in _logs(logs) if "loss" in r] == [3]
    lines = _run_cli(train_stage2.main, TRAIN_ARGS + [
        "steps=3", f"ckpt_dir={run['out'] / 'ck_dp2'}"], capsys)
    assert any(x.startswith("resumed from") and "step 2" in x for x in lines)
    assert (run["out"] / "ck_dp2" / "LATEST").read_text() == "step_00000003"


def test_a_signal_to_one_rank_stops_both_at_one_step(run):
    r0, r1 = run["ranks"]
    assert r0["stop_steps"] == r1["stop_steps"] == 2
    assert {"step": 2, "preempted": True} in _logs(r0["logs"]["stop"])
    assert (run["out"] / "ck_stop" / "LATEST").read_text() == "step_00000002"


@pytest.mark.parametrize("name", ["generate", "generate_int8"])
def test_generate_cli_two_ranks_write_what_one_process_writes(run, name):
    out = run["out"]
    two = out / ("gen_dp2" if name == "generate" else "gen_int8_dp2")
    one = out / ("gen_dp1" if name == "generate" else "gen_int8_dp1")
    assert _listing(two) == _listing(one) == ["batch_0000.npz", "batch_0001.npz"]
    for f in _listing(one):
        a, b = np.load(two / f), np.load(one / f)
        np.testing.assert_array_equal(a["ids"], b["ids"])
        np.testing.assert_allclose(a["images"], b["images"], atol=1e-4, rtol=0)
    assert json.loads(run["ranks"][0]["logs"][name][-1])["images"] == 12
    assert run["ranks"][1]["logs"][name] == []
