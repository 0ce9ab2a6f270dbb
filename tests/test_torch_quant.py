"""int8 serving of the PyTorch port (`bevgen_torch/ops/quant.py`) against the
JAX package's (`bevgen_tpu/ops/quant.py`) at tiny sizes, fp32 on the CPU.

Held to the JAX package: the int8 trees (`quantize_dense_tree`,
`quantize_gpt_tree`, `dequantize_dense_tree`) leaf for leaf and bit for bit
on the MaskGit tree, every `torch_parity.VARIANTS` tree and the GPT trees;
the quantizers and `int8_matmul` bit for bit (exact .5 ties and values past
the clip among the inputs); `QuantDense` and the AR tree's weight-only
product. Port-side: the converter round trip and its refusals, the
crossover table's rule (`quantized(batch_hint=)`), the generate CLI's
`quant=`, and the entry points' device rules. The whole int8 models (logits,
greedy ids of every variant, the AR sampler and pipeline) are
`tests/test_torch_quant_models.py`: the two were one file, split so that
neither sets the tier-1 run's wall time alone. The kernels' own check needs
the card: `tests/test_torch_guards.py:test_cuda_int8_kernels_match_plain_versions`
(`cuda` marker, skipped here); their plans and the fused route's plain
version are `tests/test_torch_int8_kernels.py`.
"""
import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevgen_tpu.models.stage2 import ar_cached as jax_cached
from bevgen_tpu.ops import quant as jq
from bevgen_torch.core.convert import export_jax_params, load_jax_params
from bevgen_torch.data.fake import fake_batch
from bevgen_torch.models.stage2.gpt import SparseGPT
from bevgen_torch.ops import quant as tq
from bevgen_torch.pipelines import generate as tgen
from torch_parity import (NUSCENES_GPT, VARIANTS, TorchPipeline,
                          ar_tiny_pipelines, ar_tiny_tree, gpt_pair,
                          tiny_configs, tiny_pipelines, tiny_tree,
                          variant_tree)

B = 2
# QuantDense / Int8WeightDense against the JAX modules: the int8 parts are
# exact, so only a reordered fp32 product (the weight-only form) is left
DENSE_RTOL = 1e-6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def assert_trees_identical(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys(), sorted(set(g) ^ set(w))[:10]
    for path, wv in w.items():
        assert g[path].dtype == wv.dtype, (path, g[path].dtype, wv.dtype)
        np.testing.assert_array_equal(g[path], wv, err_msg="/".join(path))


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---- host-side trees ---------------------------------------------------------

TREES = ["default"] + list(VARIANTS)


def _maskgit_tree(name):
    tree = tiny_tree() if name == "default" else variant_tree(name)
    return tree["maskgit"]["params"]


@pytest.mark.parametrize("name", TREES)
def test_quantize_dense_tree_matches_jax(name):
    tree = _maskgit_tree(name)
    got = tq.quantize_dense_tree(tree)
    want = _numpy_tree(jq.quantize_dense_tree(tree))
    assert_trees_identical(got, want)
    assert_trees_identical(tq.dequantize_dense_tree(got),
                           _numpy_tree(jq.dequantize_dense_tree(want)))
    # the static/dynamic split: cross to_kv and to_out without in_scale
    t = got["transformer"]
    assert "in_scale" in t["layers_0_attn"]["to_kv"]
    assert "in_scale" not in t["layers_0_cross_attn"]["to_kv"]
    assert "in_scale" not in t["layers_0_attn"]["to_out"]
    assert "in_scale" in t["to_logits"]
    if "self_cond_to_init_embed" in t:
        assert "kernel" in t["self_cond_to_init_embed"]["proj_in"]


@pytest.mark.parametrize("which", ["ar_pipeline", "plain", "nuscenes"])
def test_quantize_gpt_tree_matches_jax(which):
    if which == "ar_pipeline":
        tree = ar_tiny_tree()["gpt"]["params"]
    else:
        _, jp, _, _ = gpt_pair(**({} if which == "plain" else NUSCENES_GPT))
        tree = _numpy_tree(jp)["params"]
    got = tq.quantize_gpt_tree(tree)
    want = _numpy_tree(jq.quantize_gpt_tree(tree))
    assert_trees_identical(got, want)
    assert set(got["block_0"]["query"]) == {"kernel_q", "scale", "bias"}
    assert set(got["head"]) == {"kernel_q", "scale"}
    assert_trees_identical(
        tq.dequantize_dense_tree(got, tq.GPT_QUANT_LAYER_NAMES),
        _numpy_tree(jq.dequantize_dense_tree(want, jq.GPT_QUANT_LAYER_NAMES)))


def test_layer_names_and_clip_match_jax():
    assert tq.QUANT_LAYER_NAMES == jq.QUANT_LAYER_NAMES
    assert tq.GPT_QUANT_LAYER_NAMES == jq.GPT_QUANT_LAYER_NAMES
    assert tq.CLIP_SIGMA == jq.CLIP_SIGMA


# ---- quantizers and the product ---------------------------------------------

def _activation_cases():
    """fp32 (rows, K) inputs: random rows, a row whose amax is 127 (so its
    dynamic scale is exactly 1 and x.5 entries are exact ties), a row of
    zeros, and a row of halves at a power-of-two scale."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((7, 48)).astype(np.float32) * 3.0
    x[1] = np.arange(48, dtype=np.float32) - 23.5      # ties at scale 1 ...
    x[1, 0] = 127.0                                    # ... amax 127
    x[2] = 0.0
    x[3] = (np.arange(48, dtype=np.float32) - 24) * 0.5
    return x


def _static_cases():
    """(x, in_scale): in_scale powers of two so x * (1 / in_scale) hits exact
    .5 ties, and entries far past the +-127 clip."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 40)).astype(np.float32)
    in_scale = np.full(40, 2.0 ** -4, np.float32)
    in_scale[::3] = 2.0 ** -2
    in_scale[1::5] = (rng.random(8) * 0.1 + 0.01).astype(np.float32)
    x[0] = (np.arange(40, dtype=np.float32) + 0.5) * in_scale   # ties
    x[1] = 50.0 * np.sign(rng.standard_normal(40)).astype(np.float32)
    return x, in_scale


def test_quantize_activations_matches_jax():
    """Against the function as the reference's models run it, jitted: XLA
    computes the row scale max(amax, 1e-8) / 127 as a product with the fp32
    constant 1/127, which differs from the division in the last bit for
    some rows (and then moves some int8 values across a .5 tie)."""
    x = _activation_cases()
    got_q, got_s = tq.quantize_activations(_t(x))
    want_q, want_s = jax.jit(jq.quantize_activations)(jnp.asarray(x))
    assert got_q.dtype == torch.int8 and got_s.shape == (7, 1)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    # the ties round to even
    assert got_q[1, 1].item() == -22 and got_q[1, 2].item() == -22


def test_quantize_activations_static_matches_jax():
    x, in_scale = _static_cases()
    got = tq.quantize_activations_static(_t(x), 1.0 / _t(in_scale))
    want = jax.jit(lambda a, s: jq.quantize_activations_static(a, 1.0 / s))(
        jnp.asarray(x), jnp.asarray(in_scale))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.abs().max().item() == 127
    assert (got[1].abs() == 127).all()


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("static", [False, True])
def test_int8_matmul_matches_jax(static, out_dtype):
    rng = np.random.default_rng(2)
    w = rng.standard_normal((48, 24)).astype(np.float32) / 7.0
    w_q, w_s = jq.quantize_weight(w)
    x_q, x_s = jax.jit(jq.quantize_activations)(
        jnp.asarray(_activation_cases()))
    if static:
        x_s = None
    want = jq.int8_matmul(x_q, x_s, jnp.asarray(w_q), jnp.asarray(w_s),
                          getattr(jnp, out_dtype))
    got = tq.int8_matmul(_t(np.asarray(x_q)),
                         None if x_s is None else _t(np.asarray(x_s)),
                         _t(w_q.T), _t(w_s), getattr(torch, out_dtype))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_quantize_weight_matches_jax():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((32, 20)).astype(np.float32)
    for a, b in zip(tq.quantize_weight(w), jq.quantize_weight(w)):
        np.testing.assert_array_equal(a, b)
    g = 1.0 + 0.1 * rng.standard_normal(32).astype(np.float32)
    for a, b in zip(tq.quantize_weight_static(w, g),
                    jq.quantize_weight_static(w, g)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("static", [False, True])
def test_quant_dense_matches_jax(static):
    rng = np.random.default_rng(4)
    K, N = 40, 36
    w = rng.standard_normal((K, N)).astype(np.float32) / np.sqrt(K)
    gamma = 1.0 + 0.2 * rng.standard_normal(K).astype(np.float32)
    node = jq._quant_node({"kernel": w}, gamma if static else None)
    x = rng.standard_normal((3, 5, K)).astype(np.float32) * gamma
    want = jq.QuantDense(N, dtype=jnp.float32, static_input=static).apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, node)}, jnp.asarray(x))
    m = tq.QuantDense(K, N, torch.float32, static_input=static)
    load_jax_params(m, node)
    with torch.no_grad():
        got = m(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=DENSE_RTOL * np.abs(want).max())
    # the plain version on the padded operand gives the same values
    pad = torch.zeros(tq.padded(N), tq.padded(K), dtype=torch.int8)
    pad[:N, :K] = m.kernel_q
    with torch.no_grad():
        again = tq.int8_dense_reference(_t(x), pad, m.scale, m.in_scale)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_int8_weight_dense_matches_jax():
    rng = np.random.default_rng(5)
    K, N = 64, 48
    w = rng.standard_normal((K, N)).astype(np.float32) / 8.0
    node = jq._quant_node({"kernel": w, "bias": 0.1 * rng.standard_normal(N)
                           .astype(np.float32)})
    x = rng.standard_normal((2, 3, K)).astype(np.float32)
    want = jax_cached._dense(jax.tree_util.tree_map(jnp.asarray, node),
                             jnp.asarray(x))
    m = tq.Int8WeightDense(K, N, True, torch.float32)
    load_jax_params(m, node)
    with torch.no_grad():
        got = m(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=DENSE_RTOL * np.abs(want).max())


def test_quantized_modules_take_no_gradient_and_raise_off_cpu_cuda():
    m = tq.QuantDense(16, 8, torch.float32)
    assert not any(p.requires_grad for p in m.parameters())
    x = torch.zeros(4, 16, device="meta")
    with pytest.raises(ValueError, match="device"):
        tq.int8_dense(x, m.kernel_q.to("meta"), m.scale.to("meta"), None)
    with pytest.raises(ValueError, match="device"):
        tq.w8_linear(x, m.kernel_q.to("meta"), m.scale.to("meta"), None)


# ---- the converter -----------------------------------------------------------

def _int8_pipe(tc):
    return TorchPipeline.create(dataclasses.replace(
        tc, transformer=tc.transformer.replace(quant="int8")), device="cpu",
        dtype=torch.float32)


def test_load_then_export_gives_the_int8_tree_back():
    tree = tiny_tree()
    qtree = tq.quantize_dense_tree(tree["maskgit"]["params"])
    pipe = _int8_pipe(tiny_configs()[1])
    full = dict(tree, maskgit={"params": qtree})
    load_jax_params(pipe, full)
    out = export_jax_params(pipe)
    assert_trees_identical(out["maskgit"]["params"], qtree)
    assert out["maskgit"]["params"]["transformer"]["to_logits"][
        "kernel_q"].dtype == np.int8
    # the AR tree too
    gtree = tq.quantize_gpt_tree(ar_tiny_tree()["gpt"]["params"])
    _, _, tp = ar_tiny_pipelines()
    gpt = SparseGPT(tp.config.transformer.replace(quant="int8"),
                    dtype=torch.float32)
    assert_trees_identical(export_jax_params(load_jax_params(gpt, gtree)),
                           gtree)


def test_quantized_leaves_aimed_at_the_wrong_module_raise():
    tree = tiny_tree()
    qtree = tq.quantize_dense_tree(tree["maskgit"]["params"])
    # an int8 tree into the unquantized pipeline
    plain = TorchPipeline.create(tiny_configs()[1], device="cpu",
                                 dtype=torch.float32)
    with pytest.raises(ValueError, match="quantized leaf"):
        load_jax_params(plain.maskgit, qtree)
    # an int8 scale aimed at a LayerNorm module raises, not loads
    bad = copy.deepcopy(qtree)
    attn = bad["transformer"]["layers_0_attn"]
    attn["norm"]["norm"]["kernel_q"] = attn["to_q"]["kernel_q"]
    int8 = _int8_pipe(tiny_configs()[1])
    with pytest.raises(ValueError, match="kernel_q"):
        load_jax_params(int8.maskgit, bad)
    # a `scale` under a module that is neither a norm nor int8
    bad = copy.deepcopy(tree["maskgit"]["params"])
    bad["critic"]["to_pred"]["scale"] = np.ones(1, np.float32)
    with pytest.raises(ValueError, match="quantized leaf 'scale'"):
        load_jax_params(plain.maskgit, bad)
    # a float kernel aimed at an int8 module
    with pytest.raises(ValueError, match="int8 module"):
        load_jax_params(int8.maskgit, tree["maskgit"]["params"])


# ---- the crossover table and the CLI ----------------------------------------

TABLE = {"comment": "test table", "chip": "test card, 1 W", "source": "test",
         "measurements": {"1": {"bf16": 10.0},
                          "2": {"bf16": 10.0, "int8": 12.0},
                          "3": {"bf16": 10.5, "int8": 11.0},
                          "8": {"bf16": 12.0, "int8": 11.0},
                          "16": {"bf16": 13.0, "int8": 12.5}}}


def test_quantized_batch_hint_follows_the_table(monkeypatch, tmp_path, capsys):
    path = tmp_path / "int8_crossover.json"
    path.write_text(json.dumps(TABLE))
    monkeypatch.setattr(tgen, "CROSSOVER_TABLE", path)
    P = tgen.BEVGenPipeline
    assert P.int8_beats_bf16(2) is True
    assert P.int8_beats_bf16(3) is True
    assert P.int8_beats_bf16(8) is False
    assert P.int8_beats_bf16(16) is False
    assert P.int8_beats_bf16(100) is False   # nearest: 16
    assert P.int8_beats_bf16(1) is True      # nearest with both modes: 2
    tp = tiny_pipelines()[2]
    assert tp.quantized(batch_hint=2).config.transformer.quant == "int8"
    assert tp.quantized(batch_hint=8) is tp
    assert "keeping bf16" in capsys.readouterr().out
    assert tp.quantized(batch_hint=None).config.transformer.quant == "int8"
    # no table: the fallback batch decides
    monkeypatch.setattr(tgen, "CROSSOVER_TABLE", tmp_path / "missing.json")
    assert P.int8_beats_bf16(2) is None
    below = P.INT8_CROSSOVER_BATCH - 1
    assert tp.quantized(batch_hint=below).config.transformer.quant == "int8"
    assert tp.quantized(batch_hint=P.INT8_CROSSOVER_BATCH) is tp


def test_shipped_table_is_the_cards():
    """The table the port ships holds both modes at batches 1-16, measured
    on an NVIDIA card (its name and power limit), and the fallback batch
    is the smallest measured batch where bf16 won (or past the largest)."""
    table = tgen.crossover_table()
    assert set(table) == {"comment", "chip", "source", "measurements"}
    assert "NVIDIA" in table["chip"] and " W" in table["chip"]
    meas = table["measurements"]
    assert sorted(int(b) for b in meas) == [1, 2, 3, 4, 8, 16]
    assert all(set(v) == {"bf16", "int8"} for v in meas.values())
    losing = [int(b) for b, v in meas.items() if v["bf16"] >= v["int8"]]
    want = min(losing) if losing else 2 * max(int(b) for b in meas)
    assert tgen.BEVGenPipeline.INT8_CROSSOVER_BATCH == want


@pytest.mark.parametrize("quant", ["int8", "auto"])
def test_cli_serves_int8_after_a_checkpoint(quant, tmp_path, capsys):
    """The generate CLI at tiny_test on the CPU: `ckpt_path=` loads a
    reference checkpoint of one seed, `quant=` quantizes it, and the ids
    are those of that pipeline's own `quantized()` form."""
    from bevgen_torch.scripts import generate as cli
    from bevgen_torch.scripts.weights_drill import write_reference_ckpt
    base = ["preset=tiny_test", "batch_size=2", "fake=1", "device=cpu",
            "dtype=float32"]
    src, _ = cli.run(base + ["seed=1", f"out={tmp_path / 'a'}"])
    ckpt = tmp_path / "muse.ckpt"
    write_reference_ckpt(src, str(ckpt))
    pipe, outs = cli.run(base + ["seed=2", f"ckpt_path={ckpt}",
                                 f"quant={quant}", f"out={tmp_path / 'b'}"])
    out = capsys.readouterr().out
    assert "loaded muse weights" in out
    int8 = quant == "int8" or tgen.BEVGenPipeline.int8_beats_bf16(2) is not False
    assert pipe.config.transformer.quant == ("int8" if int8 else "none")
    want_pipe = src.quantized() if int8 else src
    batch = fake_batch(src.config, 2, seed=2)
    _, want = want_pipe.generate_fn(batch["segmentation"],
                                    batch["intrinsics_inv"],
                                    batch["extrinsics_inv"],
                                    torch.Generator().manual_seed(2))
    np.testing.assert_array_equal(np.load(outs[0])["ids"], want.numpy())


@pytest.mark.parametrize("quant", ["int8", "auto"])
def test_cli_ar_serves_int8_after_a_checkpoint(quant, tmp_path, capsys):
    from bevgen_torch.scripts import generate as cli
    from bevgen_torch.scripts.weights_drill import write_reference_ckpt
    from test_torch_ar import TINY_AR_CLI
    base = TINY_AR_CLI + ["batch_size=1", "fake=1", "device=cpu"]
    src, _ = cli.run(base + ["seed=1", f"out={tmp_path / 'a'}"])
    ckpt = tmp_path / "ar.ckpt"
    write_reference_ckpt(src, str(ckpt))
    pipe, outs = cli.run(base + ["seed=2", f"ckpt_path={ckpt}",
                                 f"quant={quant}", f"out={tmp_path / 'b'}"])
    assert "loaded ar weights" in capsys.readouterr().out
    assert pipe.config.transformer.quant == "int8"
    batch = fake_batch(src.config, 1, seed=2)
    _, want = src.quantized().generate_fn(
        batch["segmentation"], batch["intrinsics_inv"],
        batch["extrinsics_inv"], torch.Generator().manual_seed(2))
    np.testing.assert_array_equal(np.load(outs[0])["ids"], want.numpy())


def test_cli_rejects_an_unknown_quant(tmp_path):
    from bevgen_torch.scripts import generate as cli
    with pytest.raises(SystemExit, match="unknown quant='bogus'"):
        cli.main(["preset=tiny_test", "fake=1", "device=cpu", "quant=bogus",
                  f"out={tmp_path}"])
    assert not any(tmp_path.iterdir())


# ---- guards ------------------------------------------------------------------

def test_int8_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from bevgen_torch.pipelines.ar_generate import ARPipeline
    from bevgen_torch.scripts import crossover_sweep
    from torch_parity import ar_tiny_configs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tc = tiny_configs()[1]
    q = dataclasses.replace(tc, transformer=tc.transformer.replace(
        quant="int8"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchPipeline.create(q)
    aq = ar_tiny_configs()[1]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ARPipeline.create(dataclasses.replace(
            aq, transformer=aq.transformer.replace(quant="int8")))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        crossover_sweep.main([])
    with pytest.raises(SystemExit, match="device=cuda"):
        crossover_sweep.main(["device=cpu"])
    # a quantized pipeline stays on its pipeline's device
    assert tiny_pipelines()[2].quantized().device.type == "cpu"
