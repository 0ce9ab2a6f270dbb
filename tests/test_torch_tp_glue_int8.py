"""The fused glue and int8 serving under tensor parallelism (dp=1 x tp=2)
against the JAX package and one process of the port, on the CPU.

In one process: the split GEGLU + LayerNorm (`ops/fused_glue.py`: each
rank's `geglu_stats`, their sum, each rank's `geglu_norm`) against the
whole-row glue, with the two ranks' sum made by hand.

Across processes: one spawn of two gloo ranks (`tests/
torch_distributed_worker.py` in tp2 mode) runs every check once at
`tiny_test` fp32 (F = 170, so the GEGLU splits into 85 columns a rank) while
this process computes the references; the tests below read its results:
  * the glue MaskGit's gathered logits against the JAX unsharded glue
    forward (1e-4, as `test_torch_tensor_parallel.py` holds the plain form),
    and the residual + LayerNorm glue fed the summed delta on every rank;
  * greedy ids equal to the JAX package's: MUSE with the glue, MUSE int8,
    and the AR cached decode of the int8 GPT;
  * the glue MaskGit step's loss and merged gradients within 1e-5 relative
    of one process, the replicated parameters equal on both ranks;
  * the int8 MaskGit's gathered logits against the JAX unsharded int8
    forward (1e-4); the row-split `to_out` and `proj_out` (int32
    accumulators summed over tp) and `to_out`'s row scale equal to one
    process's bit for bit;
  * `fuse_qkv` of the int8 GPT taking the rank's bias parts, and the ranks'
    int8 slices merging to the whole int8 trees bit for bit;
  * the generate CLI with `quant=int8 tp=2` and with
    `transformer.use_fused_glue=true tp=2`, and the train CLI with the glue
    and `tp=2`, against the same commands in one process.
"""
import copy
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevgen_tpu.models.stage2 import maskgit as jmg
from bevgen_tpu.ops import quant as jq
from bevgen_torch.core.convert import export_jax_params, merge_tp
from bevgen_torch.models.stage2.maskgit import maskgit_loss
from bevgen_torch.ops import fused_glue as fg
from bevgen_torch.ops import quant as tq
from bevgen_torch.parallel import tensor as tten
from torch_parity import ar_tiny_pipelines, tiny_configs, tiny_pipelines

REPO = Path(__file__).resolve().parents[1]
WORLD = 2             # dp=1 x tp=2
LR = 1e-3
STEPS = 2
B = 4
WORKER_TIMEOUT_S = 240
LOGIT_TOL = 1e-4      # JAX's own tp forward test
SPLIT_TOL = 1e-6
DELTA_RTOL = 1e-5     # of the delta's largest entry: fp32 sums in another order
STEP_RTOL = 1e-5
TRAIN_ARGS = ["preset=tiny_test", "platform=cpu", "batch_size=4",
              "log_every=1", "warmup_steps=1", "dtype=float32"]
GEN_ARGS = ["preset=tiny_test", "platform=cpu", "fake=2", "batch_size=2",
            "dtype=float32", "print_config=false", "muse.temperature=0.0",
            "muse.critic_noise_scale=0.0"]
GLUE = "transformer.use_fused_glue=true"


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Torch and BLAS in two threads for this module."""
    from threadpoolctl import threadpool_limits
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with threadpool_limits(limits=2, user_api="blas"):
            yield
    finally:
        torch.set_num_threads(old)


# ---------------------------------------------------------------------------
# the split glue, in one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,F", [(6, 170), (5, 2730)])
def test_split_glue_equals_the_whole_row_glue(rows, F):
    """Two ranks' columns of y = [a | gate]: their statistics summed, then
    each rank's normalised columns, joined, against the whole row."""
    rng = np.random.default_rng(F)
    y = torch.from_numpy(rng.standard_normal((rows, 2 * F)).astype(
        np.float32) * 2)
    gamma = torch.from_numpy((1 + 0.1 * rng.standard_normal(F)).astype(
        np.float32))
    whole = fg.geglu_layernorm_reference(y, gamma)
    ys = [tten.take_part(y, 1, 2, 2, r) for r in range(2)]
    stats = sum(fg.geglu_stats_reference(p) for p in ys)
    parts = [fg.geglu_norm_reference(p, stats, tten.take_part(gamma, 0, 1, 2, r),
                                     F) for r, p in enumerate(ys)]
    np.testing.assert_allclose(tten.join_parts(parts, 1, 1).numpy(),
                               whole.numpy(), atol=SPLIT_TOL, rtol=0)


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _logit_inputs():
    from bevgen_tpu.models.geometry import canonical_rig_inverses
    tf = tiny_configs()[1].transformer
    rng = np.random.default_rng(3)
    ii, ei = canonical_rig_inverses(tf, B)
    return {"ids": rng.integers(0, tf.vocab_size,
                                (B, tf.num_cams, tf.num_cam_tokens)),
            "cond": rng.integers(0, tf.cond_vocab_size, (B, tf.num_cond_tokens)),
            "ii": np.asarray(ii, np.float32), "ei": np.asarray(ei, np.float32)}


def _muse_batch():
    from bevgen_tpu.models.geometry import canonical_rig_inverses
    tf = tiny_configs()[1].transformer
    rng = np.random.default_rng(20)
    tokens = rng.integers(0, tf.vocab_size, (B, tf.num_cams, tf.num_cam_tokens))
    ii, ei = canonical_rig_inverses(tf, B)
    mask = rng.uniform(size=tokens.shape) < np.array(
        [0.75, 0.75, 0.25, 0.25])[:, None, None]
    mask[..., 0] = True
    return {"tokens": tokens, "cond_ids": rng.integers(
                0, tf.cond_vocab_size, (B, tf.num_cond_tokens)),
            "intrinsics_inv": np.asarray(ii), "extrinsics_inv": np.asarray(ei),
            "mask": mask}


def _row_split_inputs():
    """Full-width inputs of layer 0's to_out (heads x dim_head wide) and
    proj_out (F wide): each rank feeds its columns."""
    tf = tiny_configs()[1].transformer
    rng = np.random.default_rng(21)
    F = int(tf.num_embed * tf.ff_mult * 2 / 3)
    return {"to_out": (3 * rng.standard_normal(
                (B * 5, tf.num_heads * tf.dim_head))).astype(np.float32),
            "proj_out": rng.standard_normal((B * 5, F)).astype(np.float32)}


def _inputs(out):
    _, params, tp = tiny_pipelines()
    _, glue_params, glue_tp = tiny_pipelines(glue=True)
    _, ar_params, ar_tp = ar_tiny_pipelines()
    return {
        "lr": LR, "steps": STEPS,
        "configs": {"muse": tp.config, "glue": glue_tp.config,
                    "pipe_greedy": tiny_configs(greedy=True)[1],
                    "glue_greedy": tiny_configs(greedy=True, glue=True)[1],
                    "ar_pipe": ar_tp.config},
        "muse_tree": _np(params["maskgit"]),
        "glue_tree": _np(glue_params["maskgit"]),
        "pipe_tree": _np(params), "glue_pipe_tree": _np(glue_params),
        "ar_pipe_tree": _np(ar_params),
        "logit_inputs": _logit_inputs(), "muse_batch": _muse_batch(),
        "row_split_inputs": _row_split_inputs(),
        # name -> (config, tree, quantized, generate kwargs)
        "tp2_generates": {
            "glue_greedy": ("glue_greedy", "glue_pipe_tree", False, {}),
            "int8_greedy": ("pipe_greedy", "pipe_tree", True, {}),
            "ar_int8_greedy": ("ar_pipe", "ar_pipe_tree", True, {"top_k": 1})},
        "train_args": TRAIN_ARGS, "generate_args": GEN_ARGS,
        **_cli_runs(out, "tp"),
    }


def _cli_runs(out, who):
    """The CLI runs' extra arguments, writing under `out` with the suffix
    `who` (tp: the ranks'; one: one process's)."""
    return {"train_runs": {"glue_train": [
                GLUE, "steps=2", "ckpt_minutes=0",
                f"ckpt_dir={out / f'ck_glue_{who}'}"]},
            "generate_runs": {
                "gen_int8": ["quant=int8", f"out={out / f'int8_{who}'}"],
                "gen_glue": [GLUE, f"out={out / f'glue_{who}'}"]}}


def _spawn(out):
    logs = [open(out / f"worker{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_distributed_worker.py"),
         str(r), str(WORLD), str(out), "tp2"], cwd=REPO, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(WORLD)]
    return procs, logs


def _wait(procs, logs, out):
    """Wait for the ranks; a failing rank stops the other at once."""
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


def _jax_int8_maskgit(jc, params):
    jcq = dataclasses.replace(jc, transformer=jc.transformer.replace(
        quant="int8"))
    qparams = {"params": jq.quantize_dense_tree(params["maskgit"]["params"])}
    return jmg.MaskGit(jcq.transformer, jcq.muse, jnp.float32), qparams


def _jax_logits(x):
    """The JAX package's unsharded glue and int8 MaskGit logits."""
    args = [jnp.asarray(x[k]) for k in ("ids", "cond", "ii", "ei")]
    jp, params, _ = tiny_pipelines(glue=True)
    glue = jmg.MaskGit(jp.maskgit.cfg, jp.maskgit.muse, jnp.float32)
    model, qparams = _jax_int8_maskgit(tiny_configs()[0],
                                       tiny_pipelines()[1])
    return {"glue": np.asarray(jax.jit(lambda p, *a: glue.apply(p, *a).logits)(
                params["maskgit"], *args)),
            "int8": np.asarray(jax.jit(lambda p, *a: model.apply(p, *a).logits)(
                qparams, *args))}


def _jax_greedy_ids():
    """The JAX package's greedy ids of the fake batch: its `generate_fn`
    without the image decode (the tests compare ids), on the weights of
    `tiny_pipelines` under the greedy configs."""
    from bevgen_tpu.models.stage2 import ar_cached as jac
    from bevgen_tpu.models.stage2.maskgit import generate as muse_generate
    from bevgen_tpu.pipelines.generate import BEVGenPipeline
    from bevgen_torch.data.fake import fake_batch

    def arrays(cfg):
        batch = fake_batch(cfg, 2, seed=0)
        return [jnp.asarray(batch[k]) for k in ("segmentation",
                                                "intrinsics_inv",
                                                "extrinsics_inv")]

    def muse_ids(jp, params):
        return np.asarray(jax.jit(lambda p, s, i, e: muse_generate(
            jp.maskgit, p["maskgit"], jp.encode_bev(p, s), i, e,
            jax.random.PRNGKey(0)))(params, *arrays(tiny_configs()[1])))

    out = {}
    for name, glue in (("glue_greedy", True), ("int8_greedy", False)):
        jp = BEVGenPipeline.create(tiny_configs(greedy=True, glue=glue)[0],
                                   dtype=jnp.float32)
        params = tiny_pipelines(glue=glue)[1]
        if not glue:
            jp, params = jp.quantized(params)
        out[name] = muse_ids(jp, params)
    ar_jp, ar_params, ar_tp = ar_tiny_pipelines()
    aq_pipe, aq_params = ar_jp.quantized(ar_params)
    out["ar_int8_greedy"] = np.asarray(jax.jit(
        lambda p, s, i, e: jac.ar_sample_cached(
            aq_pipe.gpt, p["gpt"], aq_pipe.encode_bev(p, s), i, e,
            jax.random.PRNGKey(0), top_k=1))(
        aq_params, *arrays(ar_tp.config)))
    return out


def _one_process_deltas(x):
    """The deltas the one-process glue MaskGit feeds its residual glue."""
    from bevgen_torch.models.stage2 import transformer as ttr
    model = tiny_pipelines(glue=True)[2].maskgit
    deltas = []
    real = ttr.residual_layernorm

    def recording(x_, d, gamma):
        deltas.append(d.detach().clone())
        return real(x_, d, gamma)

    ttr.residual_layernorm = recording
    try:
        with torch.no_grad():
            model(*(torch.from_numpy(np.asarray(x[k]))
                    for k in ("ids", "cond", "ii", "ei")))
    finally:
        ttr.residual_layernorm = real
    return [d.numpy() for d in deltas]


def _one_process_glue_step(batch):
    """The port's one-process glue MaskGit loss and gradients over the
    batch with the draws fixed."""
    model = copy.deepcopy(tiny_pipelines(glue=True)[2].maskgit)
    model.muse = dataclasses.replace(model.muse, cond_drop_prob=0.0)
    model.train()
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    mask = tb.pop("mask")
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


def _one_process_products(inputs):
    """Layer 0's to_out and proj_out of the one-process int8 MaskGit on the
    whole inputs, and to_out's row scale."""
    tr = tiny_pipelines()[2].quantized().maskgit.transformer
    out = {}
    with torch.no_grad():
        for name, mod in (("to_out", tr.layers_0_attn.to_out),
                          ("proj_out", tr.layers_0_ff.proj_out)):
            x = torch.from_numpy(inputs[name])
            out[name] = {"out": mod(x).numpy()}
            if name == "to_out":
                out[name]["scale"] = tq.quantize_activations(x)[1].numpy()
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory, _two_threads):
    """Spawn the two ranks, compute the references meanwhile, wait."""
    from bevgen_torch.scripts import generate, train_stage2
    out = tmp_path_factory.mktemp("tp2")
    inputs = _inputs(out)
    torch.save(inputs, out / "inputs.pt")
    procs, logs = _spawn(out)
    try:
        x = inputs["logit_inputs"]
        ref = {"logits": _jax_logits(x), "ids": _jax_greedy_ids(),
               "deltas": _one_process_deltas(x),
               "step": _one_process_glue_step(inputs["muse_batch"]),
               "products": _one_process_products(inputs["row_split_inputs"])}
        one = _cli_runs(out, "one")
        for args in one["train_runs"].values():
            assert train_stage2.main(TRAIN_ARGS + args) == 0
        for args in one["generate_runs"].values():
            assert generate.main(GEN_ARGS + args) == 0
    finally:
        _wait(procs, logs, out)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return {"out": out, "ranks": ranks, "ref": ref, "inputs": inputs}


def test_the_mesh_is_dp1_by_tp2(run):
    assert [(r["mesh"], r["tp_rank"]) for r in run["ranks"]] == [
        ({"dp": 1, "tp": 2}, t) for t in (0, 1)]


def test_glue_gathered_logits_match_the_jax_unsharded_forward(run):
    for r in run["ranks"]:
        assert r["glue"]["split"]
        np.testing.assert_allclose(r["glue"]["logits"],
                                   run["ref"]["logits"]["glue"],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_residual_glue_gets_the_summed_delta_on_every_rank(run):
    """Every delta (the row-split to_out's and proj_out's outputs, summed
    over tp) is the same on both ranks and is one process's delta."""
    a, b = (r["glue"]["deltas"] for r in run["ranks"])
    want = run["ref"]["deltas"]
    tf = tiny_configs()[1].transformer
    assert len(a) == len(b) == len(want) == 3 * tf.num_layers
    for x, y, w in zip(a, b, want):
        assert np.array_equal(x, y)
        np.testing.assert_allclose(x, w, atol=DELTA_RTOL * np.abs(w).max(),
                                   rtol=0)


@pytest.mark.parametrize("name", ["glue_greedy", "int8_greedy",
                                  "ar_int8_greedy"])
def test_greedy_ids_equal_the_jax_package(run, name):
    for r in run["ranks"]:
        np.testing.assert_array_equal(r["ids"][name], run["ref"]["ids"][name])


def test_glue_step_matches_one_process(run):
    loss, grads = run["ref"]["step"]
    got = run["ranks"][0]["glue_step"]
    np.testing.assert_allclose(got["loss"], loss, rtol=STEP_RTOL, atol=0)
    np.testing.assert_allclose(got["metrics"][0]["loss"], loss,
                               rtol=STEP_RTOL, atol=0)
    g, w = _flat(got["grads"]), _flat(grads)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=max(
            STEP_RTOL * float(np.abs(w[k]).max()), 1e-9), err_msg=k)
    assert got["sliced"] > 20


def test_glue_step_keeps_replicated_parameters_equal(run):
    ranks = [r["glue_step"] for r in run["ranks"]]
    assert all(r["replicated_equal"] for r in ranks)
    assert ranks[1]["metrics"] == ranks[0]["metrics"]
    for key in ("params", "ema"):
        a, b = _flat(ranks[1][key]), _flat(ranks[0][key])
        assert all(np.array_equal(a[k], b[k]) for k in b), key


def test_int8_gathered_logits_match_the_jax_unsharded_forward(run):
    for r in run["ranks"]:
        np.testing.assert_allclose(r["int8"]["logits"],
                                   run["ref"]["logits"]["int8"],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("name", ["to_out", "proj_out"])
def test_row_split_int8_products_equal_one_process_bit_for_bit(run, name):
    want = run["ref"]["products"][name]
    for r in run["ranks"]:
        got = r["int8"]["products"][name]
        assert got["split"] == 1     # row-split: the input axis is cut
        assert np.array_equal(got["out"], want["out"])
        if name == "to_out":
            assert np.array_equal(got["scale"], want["scale"])


def test_int8_fuse_qkv_takes_the_rank_bias(run):
    """The fused q|k|v bias of each layer is the rank's part of q's, k's
    and v's biases, in that order."""
    gpt = run["inputs"]["ar_pipe_tree"]["gpt"]
    gpt = gpt.get("params", gpt)
    for r, res in enumerate(run["ranks"]):
        for i, got in enumerate(res["int8_gpt"]["qkv_bias"]):
            blk = gpt[f"block_{i}"]
            want = np.concatenate([tten.take_part(blk[p]["bias"], 0, 1, 2, r)
                                   for p in ("query", "key", "value")])
            assert np.array_equal(got, want)


def test_int8_trees_merge_to_the_whole_int8_trees_bit_for_bit(run):
    """The ranks' slices of the int8 MaskGit and GPT (quantized whole, then
    cut) merge to the whole int8 trees, as tp = 1 holds them; a rank's
    MaskGit slices equal the whole tree's `split_tp` slice and what
    `load_jax_params(mesh=)` loads from the whole tree into a cut model."""
    assert all(r["int8"]["split_equal"] and r["int8"]["mesh_load_equal"]
               for r in run["ranks"])
    inputs = run["inputs"]
    gpt = inputs["ar_pipe_tree"]["gpt"]
    for key, want in (
            ("int8", tq.quantize_dense_tree(inputs["muse_tree"])),
            ("int8_gpt", tq.quantize_gpt_tree(gpt.get("params", gpt)))):
        want = want.get("params", want)
        slices = [r[key]["slices"] for r in run["ranks"]]
        got = merge_tp(slices, want)
        a, b = _flat(got), _flat(want)
        assert a.keys() == b.keys()
        for k in b:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def _listing(d):
    return sorted(str(p.relative_to(d)) for p in Path(d).rglob("*"))


@pytest.mark.parametrize("name", ["int8", "glue"])
def test_generate_cli_at_tp2_writes_what_one_process_writes(run, name):
    out = run["out"]
    tp, one = out / f"{name}_tp", out / f"{name}_one"
    assert _listing(tp) == _listing(one) == ["batch_0000.npz",
                                             "batch_0001.npz"]
    for f in _listing(one):
        a, b = np.load(tp / f), np.load(one / f)
        np.testing.assert_array_equal(a["ids"], b["ids"])
        np.testing.assert_allclose(a["images"], b["images"], atol=1e-4, rtol=0)
    logs = run["ranks"][0]["logs"][f"gen_{name}"]
    if name == "int8":
        assert any("serving int8" in x for x in logs)
    assert all(r["logs"][f"gen_{name}"] == [] for r in run["ranks"][1:])


def test_train_cli_with_the_glue_at_tp2_writes_what_one_process_writes(run):
    out, logs = run["out"], run["ranks"][0]["logs"]["glue_train"]
    assert logs[-1] == "done" and logs[0].startswith("mesh: {'dp': 1, 'tp': 2}")
    assert run["ranks"][1]["logs"]["glue_train"] == []
    tp, one = out / "ck_glue_tp", out / "ck_glue_one"
    assert _listing(tp) == _listing(one)
    for tag, f in (("step_00000002", "state.pt"), ("step_00000002-EMA",
                                                   "params.pt")):
        a = torch.load(tp / tag / f, weights_only=False)
        b = torch.load(one / tag / f, weights_only=False)
        pa, pb = (x["params"] if "params" in x else x for x in (a, b))
        assert pa.keys() == pb.keys()
        for k in pa:
            assert pa[k].shape == pb[k].shape, k
            torch.testing.assert_close(pa[k], pb[k], rtol=0, atol=2 * LR, msg=k)
