"""Tensor parallelism of the port (`bevgen_torch/parallel/tensor.py`, the tp
axis of `parallel/sharding.py`) against the JAX package, on the CPU.

In one process: the port's weight plan `tp_plan` on every leaf of the
full-width `argoverse_muse` and `nuscenes_ar` trees and of their int8
serving trees (shapes from `jax.eval_shape`) against JAX `param_pspec` with
`param_shardings`' divisibility drop at tp = 2 and 4 (one documented
departure: the GEGLU's `proj_in` at F = 2730, tp = 4), the moment axes at (dp=2, tp=2) against JAX
`moment_pspec`, and `split_tp`/`merge_tp` by meaning.

Across processes: one spawn of four gloo ranks (`tests/
torch_distributed_worker.py` in tp mode: dp=2 x tp=2) runs every check once
at `tiny_test` fp32 while this process computes the references; the tests
below read its results:
  * MaskGit's gathered logits against the JAX unsharded `MaskGit.apply`
    (atol = rtol = 1e-4, the bound of JAX's own
    `tests/test_pipeline.py:test_tp_forward_logits_match_single_device`);
  * the split `norm_mid` against the whole LayerNorm (1e-6), its gain's
    gradient summed over tp;
  * greedy MUSE ids (default and TokenCritic) and AR cached greedy ids
    equal to the JAX package's;
  * one MaskGit step with the draws fixed: loss and merged gradients
    within 1e-5 relative of one process, replicated parameters equal on all
    four ranks bit for bit, remat on equal to remat off bit for bit, and
    the checkpoint the step writes loading at tp = 1 bit for bit;
  * the AR step on the (2, 2) mesh (the GPT whole on every rank) equal bit
    for bit to the dp=2 step over each tp index's data group, and close to
    one process summing the two halves' gradients;
  * `generate` and `train_stage2` with `dp=2 tp=2` in-process: their
    outputs against one process, and tags resuming across tp.
"""
import copy
import dataclasses
import json
import re
import subprocess
import sys
import time
from functools import lru_cache
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bevgen_tpu.core import config as jcfg
from bevgen_tpu.models.stage2 import maskgit as jmg
from bevgen_tpu.parallel import sharding as jshd
from bevgen_torch.core.convert import export_jax_params, merge_tp, split_tp
from bevgen_torch.models.stage2.ar import ar_loss
from bevgen_torch.parallel import sharding as tshd
from bevgen_torch.training import optim as toptim
from bevgen_torch.training import trainer as ttrainer
from torch_parity import (ar_tiny_pipelines, assert_steps_close,
                          gpt_inputs, gpt_pair,
                          tiny_configs, tiny_pipelines, variant_configs,
                          variant_pipelines, variant_tree)

REPO = Path(__file__).resolve().parents[1]
WORLD = 4             # dp=2 x tp=2
LR = 1e-3
STEPS = 2
B = 4
WORKER_TIMEOUT_S = 240
LOGIT_TOL = 1e-4      # JAX's own tp forward test
NORM_TOL = 1e-6
STEP_RTOL = 1e-5
TRAIN_ARGS = ["preset=tiny_test", "platform=cpu", "batch_size=4",
              "log_every=1", "warmup_steps=1", "dtype=float32"]
GREEDY_ARGS = ["muse.temperature=0.0", "muse.critic_noise_scale=0.0"]
GEN_ARGS = ["preset=tiny_test", "platform=cpu", "fake=2", "batch_size=2",
            "dtype=float32", "print_config=false"] + GREEDY_ARGS


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Torch and BLAS in two threads for this module: beside the other test
    processes on the machine, more threads only contend for its cores."""
    from threadpoolctl import threadpool_limits
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with threadpool_limits(limits=2, user_api="blas"):
            yield
    finally:
        torch.set_num_threads(old)


# ---------------------------------------------------------------------------
# the plan, in one process
# ---------------------------------------------------------------------------


def _int8_gpt_shapes(tree):
    """The shapes of `quantize_gpt_tree` of a GPT tree: each quantized
    layer's (in, out) kernel as an int8 kernel_q and an (out,) scale."""
    from bevgen_tpu.ops.quant import GPT_QUANT_LAYER_NAMES

    def rec(node, name):
        if name in GPT_QUANT_LAYER_NAMES and "kernel" in node:
            k = node["kernel"]
            out = {n: v for n, v in node.items() if n != "kernel"}
            out["kernel_q"] = jax.ShapeDtypeStruct(k.shape, jnp.int8)
            out["scale"] = jax.ShapeDtypeStruct(k.shape[-1:], jnp.float32)
            return out
        return {n: rec(v, n) if isinstance(v, dict) else v
                for n, v in node.items()}
    return rec(tree, "")


@lru_cache(maxsize=None)
def _full_tree(name):
    """The maskgit or gpt tree of a full-width JAX pipeline, shapes only;
    `_int8`: its int8 serving tree (the MUSE one from the JAX int8
    pipeline's own init)."""
    from bevgen_tpu.pipelines.ar_generate import ARPipeline
    from bevgen_tpu.pipelines.generate import BEVGenPipeline
    key = jax.random.PRNGKey(0)
    if name.startswith("argoverse_muse"):
        cfg = jcfg.argoverse_muse_config()
        if name.endswith("_int8"):
            cfg = dataclasses.replace(cfg, transformer=cfg.transformer.replace(
                quant="int8"))
        pipe = BEVGenPipeline.create(cfg)
        return jax.eval_shape(pipe.init_params, key)["maskgit"]
    pipe = ARPipeline.create(jcfg.nuscenes_ar_config(), use_pallas=False)
    tree = jax.eval_shape(pipe.init_params, key)["gpt"]
    return _int8_gpt_shapes(tree) if name.endswith("_int8") else tree


def _path(path):
    keys = [str(getattr(k, "key", k)) for k in path]
    return "/".join(keys[1:] if keys[0] == "params" else keys)


def _jax_plan(path, leaf, tp):
    """JAX `param_pspec` with `param_shardings`' drop of the annotations
    that tp does not divide."""
    spec = jshd.param_pspec(path, leaf)
    return tuple(ax if ax is None or leaf.shape[i] % tp == 0 else None
                 for i, ax in enumerate(tuple(spec) + (None,) * (
                     leaf.ndim - len(spec))))


# the one leaf kind where the port's plan departs from JAX's: the GEGLU's
# [a | gate] output at F = 2730 does not split into 2 x 4 parts (in the
# int8 tree its kernel_q and its per-output scale)
DEPARTURES = {4: r"proj_in/(kernel|kernel_q|scale)$"}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("tree", ["argoverse_muse", "nuscenes_ar",
                                  "argoverse_muse_int8", "nuscenes_ar_int8"])
def test_tp_plan_matches_jax_on_every_leaf(tree, tp):
    leaves = jax.tree_util.tree_leaves_with_path(_full_tree(tree))
    split = departed = 0
    for path, leaf in leaves:
        name = _path(path)
        got, want = tshd.tp_plan(name, leaf.shape, tp), _jax_plan(path, leaf, tp)
        if got != want:
            assert tp in DEPARTURES and re.search(DEPARTURES[tp], name), name
            assert "tp" in want and set(got) == {None}, name
            departed += 1
            continue
        split += "tp" in got
    assert split > len(leaves) // 4
    # every layer's proj_in, and nothing else
    n_ff = sum(bool(re.search(DEPARTURES[4], _path(p))) for p, _ in leaves)
    assert departed == (n_ff if tp == 4 else 0)
    if tree.endswith("_int8"):   # the int8 leaves are cut by the same rules
        names = [_path(p) for p, _ in leaves]
        assert any(n.endswith("kernel_q") for n in names)
        assert not any(n.endswith("/kernel") for n in names
                       if re.search(r"(to_q|to_kv|to_out|proj_in|proj_out|"
                                    r"query|key|value|mlp_fc|mlp_proj)/", n))


def test_moment_axes_match_jax_at_dp2_tp2(monkeypatch):
    import types
    monkeypatch.setattr(jshd, "_MESH_AXIS_SIZES", {})
    mesh = types.SimpleNamespace(shape={"dp": 2, "tp": 2})
    n = 0
    for tree in ("argoverse_muse", "nuscenes_ar"):
        for path, leaf in jax.tree_util.tree_leaves_with_path(_full_tree(tree)):
            want = tuple(jshd.moment_pspec(path, leaf, mesh))
            assert tshd.moment_pspec(_path(path), leaf.shape, 2, 2) == want, \
                _path(path)
            n += "tp" in want and "dp" in want
    assert n > 50     # most split weights have their moments sliced too


def _tiny_maskgit_tree():
    return tiny_pipelines()[1]["maskgit"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("tp", [2, 4])
def test_split_and_merge_invert_each_other(tp):
    for tree in (_np(_tiny_maskgit_tree()), _np(ar_tiny_pipelines()[1]["gpt"])):
        slices = [split_tp(tree, tp, r) for r in range(tp)]
        back = merge_tp(slices, tree)
        for (p, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                  jax.tree_util.tree_leaves_with_path(tree)):
            assert a.dtype == b.dtype and np.array_equal(a, b), p


def test_split_follows_meaning():
    """A rank's to_kv columns are its heads of k, then its heads of v; its
    proj_in columns its share of a, then of gate; null_kv its heads."""
    tree = _np(_tiny_maskgit_tree())
    tf = tiny_configs()[1].transformer
    h, dh, inner = tf.num_heads, tf.dim_head, tf.num_heads * tf.dim_head
    F_ = int(tf.num_embed * tf.ff_mult * 2 / 3)
    attn = tree["params"]["transformer"]["layers_0_attn"]
    ff = tree["params"]["transformer"]["layers_0_ff"]
    for r in range(2):
        part = split_tp(tree, 2, r)["params"]["transformer"]
        kv = attn["to_kv"]["kernel"]
        k, v = kv[:, :inner], kv[:, inner:]
        cols = slice(r * inner // 2, (r + 1) * inner // 2)
        np.testing.assert_array_equal(
            part["layers_0_attn"]["to_kv"]["kernel"],
            np.concatenate([k[:, cols], v[:, cols]], axis=1))
        np.testing.assert_array_equal(part["layers_0_attn"]["null_kv"],
                                      attn["null_kv"][:, r * h // 2:(r + 1) * h // 2])
        np.testing.assert_array_equal(part["layers_0_attn"]["to_out"]["kernel"],
                                      attn["to_out"]["kernel"][cols])
        a, gate = ff["proj_in"]["kernel"][:, :F_], ff["proj_in"]["kernel"][:, F_:]
        fc = slice(r * F_ // 2, (r + 1) * F_ // 2)
        np.testing.assert_array_equal(part["layers_0_ff"]["proj_in"]["kernel"],
                                      np.concatenate([a[:, fc], gate[:, fc]], 1))
        np.testing.assert_array_equal(part["layers_0_ff"]["proj_out"]["kernel"],
                                      ff["proj_out"]["kernel"][fc])
        # replicated: the norms, the q/k scales, the embeddings
        np.testing.assert_array_equal(part["layers_0_ff"]["norm_mid"]["norm"]["scale"],
                                      ff["norm_mid"]["norm"]["scale"])
        np.testing.assert_array_equal(part["layers_0_attn"]["q_scale"],
                                      attn["q_scale"])
        assert dh == attn["q_scale"].shape[0]


# ---------------------------------------------------------------------------
# four ranks
# ---------------------------------------------------------------------------


def _muse_batch():
    from bevgen_tpu.models.geometry import canonical_rig_inverses
    tf = tiny_configs()[1].transformer
    rng = np.random.default_rng(19)
    tokens = rng.integers(0, tf.vocab_size, (B, tf.num_cams, tf.num_cam_tokens))
    ii, ei = canonical_rig_inverses(tf, B)
    prob = np.array([0.75, 0.75, 0.25, 0.25])[:, None, None]
    mask = rng.uniform(size=tokens.shape) < prob
    mask[..., 0] = True
    return {"tokens": tokens, "cond_ids": rng.integers(
                0, tf.cond_vocab_size, (B, tf.num_cond_tokens)),
            "intrinsics_inv": np.asarray(ii), "extrinsics_inv": np.asarray(ei),
            "mask": mask}


def _logit_inputs():
    from bevgen_tpu.models.geometry import canonical_rig_inverses
    tf = tiny_configs()[1].transformer
    rng = np.random.default_rng(3)
    ii, ei = canonical_rig_inverses(tf, B)
    return {"ids": rng.integers(0, tf.vocab_size,
                                (B, tf.num_cams, tf.num_cam_tokens)),
            "cond": rng.integers(0, tf.cond_vocab_size, (B, tf.num_cond_tokens)),
            "ii": np.asarray(ii, np.float32), "ei": np.asarray(ei, np.float32)}


def _gpt_batch():
    _, _, _, tc = gpt_pair(camera_bias=True)
    ids, cond, ii, ei = gpt_inputs(tc, b=B, seed=7)
    return {"tokens": ids, "cond_ids": cond, "intrinsics_inv": ii,
            "extrinsics_inv": ei}


def _inputs(out):
    _, params, tp = tiny_pipelines()
    _, _, tm, tc = gpt_pair(camera_bias=True)
    _, ar_params, ar_tp = ar_tiny_pipelines()
    rng = np.random.default_rng(5)
    F_ = int(tp.config.transformer.num_embed * 4 * 2 / 3)
    return {
        "lr": LR, "steps": STEPS,
        "configs": {"muse": tp.config, "pipe_greedy": tiny_configs(greedy=True)[1],
                    "tc_greedy": variant_configs("token_critic", greedy=True)[1],
                    "gpt": tc, "ar_pipe": ar_tp.config},
        "muse_tree": _np(params["maskgit"]), "pipe_tree": _np(params),
        "tc_tree": _np(variant_tree("token_critic")),
        "ar_pipe_tree": _np(ar_params), "gpt_tree": export_jax_params(tm),
        "muse_batch": _muse_batch(), "gpt_batch": _gpt_batch(),
        "logit_inputs": _logit_inputs(),
        "norm_mid": {"h": rng.standard_normal((6, F_)).astype(np.float32) * 3,
                     "gain": (1 + 0.1 * rng.standard_normal(F_)).astype(
                         np.float32)},
        # name -> (config, tree, generate kwargs)
        "tp_generates": {"muse_greedy": ("pipe_greedy", "pipe_tree", {}),
                         "tc_greedy": ("tc_greedy", "tc_tree", {}),
                         "ar_greedy": ("ar_pipe", "ar_pipe_tree", {"top_k": 1})},
        "train_args": TRAIN_ARGS,
        "train_runs": {
            "train": ["steps=2", "ckpt_minutes=0", f"ckpt_dir={out / 'ck_tp'}"],
            "resume": ["steps=3", f"ckpt_dir={out / 'ck_dp1_then_tp'}"]},
        "generate_args": GEN_ARGS,
        "generate_runs": {"generate": [f"out={out / 'gen_tp'}"]},
    }


def _spawn(out):
    logs = [open(out / f"worker{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_distributed_worker.py"),
         str(r), str(WORLD), str(out), "tp"], cwd=REPO, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(WORLD)]
    return procs, logs


def _wait(procs, logs, out):
    """Wait for the ranks; a failing rank stops the others at once."""
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


def _jax_logits(x):
    jp, params, _ = tiny_pipelines()
    model = jmg.MaskGit(jp.maskgit.cfg, jp.maskgit.muse, jnp.float32)
    return np.asarray(jax.jit(lambda p, *a: model.apply(p, *a).logits)(
        params["maskgit"], *(jnp.asarray(x[k]) for k in ("ids", "cond", "ii",
                                                          "ei"))))


def _jax_greedy_ids():
    from bevgen_torch.data.fake import fake_batch
    out = {}
    for name, (jp, params) in (
            ("muse_greedy", tiny_pipelines(greedy=True)[:2]),
            ("tc_greedy", variant_pipelines("token_critic", greedy=True)[:2])):
        batch = fake_batch(tiny_configs()[1], 2, seed=0)
        arrays = [jnp.asarray(batch[k]) for k in ("segmentation",
                                                  "intrinsics_inv",
                                                  "extrinsics_inv")]
        out[name] = np.asarray(jax.jit(jp.generate_fn)(
            params, *arrays, jax.random.PRNGKey(0))[1])
    ar_jp, ar_params, ar_tp = ar_tiny_pipelines()
    batch = fake_batch(ar_tp.config, 2, seed=0)
    arrays = [jnp.asarray(batch[k]) for k in ("segmentation", "intrinsics_inv",
                                              "extrinsics_inv")]
    out["ar_greedy"] = np.asarray(jax.jit(lambda p, s, i, e: ar_jp.generate_fn(
        p, s, i, e, jax.random.PRNGKey(0), top_k=1))(ar_params, *arrays)[1])
    return out


def _one_process_step(batch):
    """The port's one-process MaskGit loss and gradients over the global
    batch with the draws fixed."""
    _, _, tp = tiny_pipelines()
    model = copy.deepcopy(tp.maskgit)
    model.muse = dataclasses.replace(model.muse, cond_drop_prob=0.0)
    model.train()
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    mask = tb.pop("mask")
    from bevgen_torch.models.stage2.maskgit import maskgit_loss
    loss = maskgit_loss(model, tb["tokens"], tb["cond_ids"],
                        tb["intrinsics_inv"], tb["extrinsics_inv"],
                        generator=torch.Generator().manual_seed(0),
                        mask_override=mask, gumbel_noise=torch.zeros(
                            mask.shape + (model.cfg.vocab_size,)))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss.loss, list(model.parameters()),
                                allow_unused=True)
    return float(loss.loss.detach()), export_jax_params(model, {
        n: torch.zeros_like(p) if g is None else g
        for n, p, g in zip(names, model.parameters(), grads)})


def _dp2_ar_steps(batch):
    """The dp=2 AR step in one process: each half's loss over 2, the two
    gradients summed in rank order, one update; STEPS times."""
    _, _, tm, _ = gpt_pair(camera_bias=True)
    model = copy.deepcopy(tm)
    model.train()
    opt = toptim.maskgit_optimizer(model, LR, warmup_steps=1, total_steps=10)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    args = ("tokens", "cond_ids", "intrinsics_inv", "extrinsics_inv")
    metrics = []
    for _ in range(STEPS):
        grads, loss = None, 0.0
        for r in range(2):
            half = [tb[k][r * B // 2:(r + 1) * B // 2] for k in args]
            part = ar_loss(model, *half, deterministic=True) / 2
            g = torch.autograd.grad(part, opt.params, allow_unused=True)
            g = [torch.zeros_like(p) if x is None else x
                 for x, p in zip(g, opt.params)]
            grads = g if grads is None else [a + x for a, x in zip(grads, g)]
            loss += float(part.detach())
        norm = toptim.global_norm(grads)
        opt.step(grads)
        metrics.append({"loss": loss, "grad_norm": float(norm)})
    return metrics, export_jax_params(model)


@pytest.fixture(scope="module")
def run(tmp_path_factory, _two_threads):
    """Spawn the four ranks, compute the references meanwhile, wait."""
    from bevgen_torch.scripts import generate, train_stage2
    out = tmp_path_factory.mktemp("tp")
    inputs = _inputs(out)
    # a one-process tag for the ranks to resume from
    assert train_stage2.main(TRAIN_ARGS + [
        "steps=2", f"ckpt_dir={out / 'ck_dp1_then_tp'}"]) == 0
    torch.save(inputs, out / "inputs.pt")
    procs, logs = _spawn(out)
    try:
        ref = {"logits": _jax_logits(inputs["logit_inputs"]),
               "ids": _jax_greedy_ids(),
               "step": _one_process_step(inputs["muse_batch"]),
               "ar": _dp2_ar_steps(inputs["gpt_batch"])}
        assert train_stage2.main(TRAIN_ARGS + [
            "steps=2", "ckpt_minutes=0", f"ckpt_dir={out / 'ck1_tp'}"]) == 0
        assert generate.main(GEN_ARGS + [f"out={out / 'gen_one'}"]) == 0
    finally:
        _wait(procs, logs, out)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return {"out": out, "ranks": ranks, "ref": ref, "inputs": inputs}


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_the_mesh_is_dp2_by_tp2(run):
    got = [(r["mesh"], r["data_rank"], r["tp_rank"]) for r in run["ranks"]]
    assert got == [({"dp": 2, "tp": 2}, d, t) for d in (0, 1) for t in (0, 1)]


def test_gathered_logits_match_the_jax_unsharded_forward(run):
    want = run["ref"]["logits"]
    for r in run["ranks"]:
        np.testing.assert_allclose(r["forward"]["logits"], want,
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        assert r["forward"]["slices_equal_split_tp"]


def test_sharded_norm_mid_matches_the_whole_norm(run):
    nm = run["inputs"]["norm_mid"]
    h = torch.from_numpy(nm["h"])
    g = torch.from_numpy(nm["gain"]).requires_grad_(True)
    y = F.layer_norm(h, (h.shape[-1],), g, None, 1e-5)
    y.square().sum().backward()
    for r in run["ranks"]:
        np.testing.assert_allclose(r["forward"]["norm_mid"], y.detach().numpy(),
                                   atol=NORM_TOL, rtol=0)
        np.testing.assert_allclose(r["forward"]["norm_mid_gain_grad"],
                                   g.grad.numpy(), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("name", ["muse_greedy", "tc_greedy", "ar_greedy"])
def test_greedy_ids_equal_the_jax_package(run, name):
    for r in run["ranks"]:
        np.testing.assert_array_equal(r["ids"][name], run["ref"]["ids"][name])


def test_maskgit_step_matches_one_process(run):
    loss, grads = run["ref"]["step"]
    got = run["ranks"][0]["step"]
    np.testing.assert_allclose(got["loss"], loss, rtol=STEP_RTOL, atol=0)
    np.testing.assert_allclose(got["metrics"][0]["loss"], loss,
                               rtol=STEP_RTOL, atol=0)
    g, w = _flat(got["grads"]), _flat(grads)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=max(
            STEP_RTOL * float(np.abs(w[k]).max()), 1e-9), err_msg=k)
    assert got["sliced"] > 20


def test_replicated_parameters_equal_on_every_rank(run):
    ranks = run["ranks"]
    assert all(r["step"]["replicated_equal"] for r in ranks)
    assert all(r["ar"]["equal"] for r in ranks)
    # the merged trees too, and the metrics
    for r in ranks[1:]:
        assert r["step"]["metrics"] == ranks[0]["step"]["metrics"]
        for key in ("params", "ema"):
            a, b = _flat(r["step"][key]), _flat(ranks[0]["step"][key])
            assert all(np.array_equal(a[k], b[k]) for k in b), key


def test_remat_equals_remat_off_bit_for_bit(run):
    for r in run["ranks"]:
        assert r["remat"]["metrics"] == r["step"]["metrics"]
        a, b = _flat(r["remat"]["params"]), _flat(r["step"]["params"])
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                            for k in b)


def test_a_tp2_checkpoint_loads_at_tp1_bit_for_bit(run):
    """The tag the step wrote holds the ranks' slices merged by meaning
    (`merge_tp` of each tp rank's own slices), and loads into a one-process
    model and optimizer."""
    from bevgen_torch.training.checkpoints import CheckpointManager
    ranks = run["ranks"]
    slices = [ranks[t]["step"]["slices"] for t in (0, 1)]   # data row 0
    merged = merge_tp(slices, run["inputs"]["muse_tree"]["params"])
    _, _, tp = tiny_pipelines()
    model = copy.deepcopy(tp.maskgit)
    opt = toptim.maskgit_optimizer(model, LR, warmup_steps=1, total_steps=10)
    state = ttrainer.create_train_state(model, opt)
    mgr = CheckpointManager(str(run["out"] / "ck_tp_step"))
    assert mgr.restore_latest(state) is not None and state.step == STEPS
    a, b = _flat(export_jax_params(model)), _flat(merged)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in b)
    c = _flat(ranks[0]["step"]["params"])
    assert all(np.array_equal(a[k], c[k]) for k in c)
    names = opt.state_names()
    got = _flat(export_jax_params(model, {
        names[i]: st["exp_avg"] for i, st in opt.state_dict()["adam"]["state"].items()}))
    want = _flat(ranks[0]["step"]["moments"]["exp_avg"])
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_ar_step_on_the_tp_mesh_equals_the_dp2_step(run):
    """Bit for bit against the dp=2 step (the same ranks as a tp = 1 mesh);
    against one process summing the halves, within Adam's bound (the ZeRO
    slices are stepped apart, and a slice may round an update otherwise
    than the whole tensor does)."""
    metrics, params = run["ref"]["ar"]
    for r in run["ranks"]:
        assert r["ar"]["sliced"] == 0       # the GPT trains whole
        assert r["ar"]["metrics"] == r["ar_dp2"]["metrics"]
        a, b = _flat(r["ar"]["params"]), _flat(r["ar_dp2"]["params"])
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                            for k in b)
        for g, w in zip(r["ar"]["metrics"], metrics):
            assert g["loss"] == pytest.approx(w["loss"], rel=1e-6)
            assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-6)
        assert_steps_close(r["ar"]["params"], params, LR, "(2, 2) vs one")


def _listing(d):
    return sorted(str(p.relative_to(d)) for p in Path(d).rglob("*"))


def _logs(lines):
    return [json.loads(x) for x in lines if x.startswith("{")]


def test_train_cli_at_dp2_tp2_writes_what_one_process_writes(run):
    out, logs = run["out"], run["ranks"][0]["logs"]["train"]
    assert logs[-1] == "done" and logs[0].startswith("mesh: {'dp': 2, 'tp': 2}")
    assert all(r["logs"]["train"] == [] for r in run["ranks"][1:])
    assert _listing(out / "ck_tp") == _listing(out / "ck1_tp")
    for tag, f in (("step_00000002", "state.pt"), ("step_00000002-EMA",
                                                   "params.pt")):
        a = torch.load(out / "ck_tp" / tag / f, weights_only=False)
        b = torch.load(out / "ck1_tp" / tag / f, weights_only=False)
        pa, pb = (x["params"] if "params" in x else x for x in (a, b))
        assert pa.keys() == pb.keys()
        for k in pa:
            assert pa[k].shape == pb[k].shape, k
            torch.testing.assert_close(pa[k], pb[k], rtol=0, atol=2 * LR, msg=k)
    assert [r["step"] for r in _logs(logs) if "loss" in r] == [1, 2]


def test_tags_resume_across_tp(run, capsys):
    from bevgen_torch.scripts import train_stage2
    logs = run["ranks"][0]["logs"]["resume"]
    assert any(x.startswith("resumed from") and "step 2" in x for x in logs)
    assert [r["step"] for r in _logs(logs) if "loss" in r] == [3]
    assert train_stage2.main(TRAIN_ARGS + [
        "steps=3", f"ckpt_dir={run['out'] / 'ck_tp'}"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert any(x.startswith("resumed from") and "step 2" in x for x in lines)
    assert (run["out"] / "ck_tp" / "LATEST").read_text() == "step_00000003"


def test_generate_cli_at_dp2_tp2_writes_what_one_process_writes(run):
    out = run["out"]
    assert _listing(out / "gen_tp") == _listing(out / "gen_one") == [
        "batch_0000.npz", "batch_0001.npz"]
    for f in _listing(out / "gen_one"):
        a, b = np.load(out / "gen_tp" / f), np.load(out / "gen_one" / f)
        np.testing.assert_array_equal(a["ids"], b["ids"])
        np.testing.assert_allclose(a["images"], b["images"], atol=1e-4, rtol=0)
    assert json.loads(run["ranks"][0]["logs"]["generate"][-1])["images"] == 12
    assert all(r["logs"]["generate"] == [] for r in run["ranks"][1:])


def test_pop_mesh_exits_on_what_tp_cannot_run(monkeypatch):
    from bevgen_torch.scripts import cli
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.delenv("BEVGEN_NUM_PROCESSES", raising=False)
    tf = tiny_configs()[1].transformer
    for args, message in (
            ({"tp": "4"}, "num_heads=2 is not divisible by tp"),
            ({"tp": "2", "dp": "1"}, "must equal the 4 processes")):
        with pytest.raises(SystemExit, match=message):
            cli.pop_mesh(dict(args), "cpu", tf)


def test_mesh_groups_follow_the_jax_rank_order():
    """rank = (dcn_i * dp + dp_i) * tp + tp_i: the data row and tp index of
    each rank of a (dcn=2, dp=2, tp=2) mesh, against the JAX device grid."""
    devices = jax.devices()[:8]
    jmesh = jshd.make_mesh(dp=2, tp=2, dcn=2, devices=devices)
    grid = np.vectorize(lambda d: d.id)(jmesh.devices)      # (dcn, dp, tp)
    for r in range(8):
        m = tshd.Mesh(2, 2, r, None, None, torch.device("cpu"), tp=2)
        dcn_i, dp_i, tp_i = (int(a[0]) for a in np.nonzero(grid == r))
        assert (m.data_rank, m.dp_rank, m.tp_rank) == (dcn_i * 2 + dp_i, dp_i,
                                                       tp_i)
        assert m.batch_shard(3) == tshd.BatchShard(12, m.data_rank * 3, m.sum)
    assert m.shape == dict(jmesh.shape) and m.world == 8
