"""Guards of the PyTorch port: it imports nothing of JAX or of the JAX
package, `load_jax_params` accepts exactly the reference's tree (MUSE and
AR pipelines), entry points (serving, AR serving, training and evaluation)
run on CUDA unless asked for the CPU, the attention's and the glue's
autograd Functions run their plain twins on the CPU, and (on a machine with
a card) the CUDA kernels agree with their plain versions and CUDA attention
and glue outputs carry gradients, the block-sparse backward included, and
the int8 serving kernels agree with their plain versions.

The module imports JAX only inside the tests that compare with it, so the
`cuda` test also runs where JAX is missing; there, skip the conftest
(which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_guards.py
"""
import ast
import copy
from pathlib import Path

import numpy as np
import pytest
import torch

from bevgen_torch.core import config as tcfg
from bevgen_torch.core.convert import load_jax_params
from bevgen_torch.pipelines.generate import BEVGenPipeline

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "bevgen_tpu"}


def _port_files():
    return sorted((ROOT / "bevgen_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_or_reference_package():
    files = _port_files()
    assert len(files) > 10
    checked = {str(p.relative_to(ROOT)) for p in files}
    for module in ("ops/attention_bwd.py", "ops/bias_attention.py",
                   "training/optim.py", "training/trainer.py",
                   "training/checkpoints.py", "training/preemption.py",
                   "data/tokens.py", "scripts/train_stage2.py",
                   "scripts/profile_train.py", "models/init.py",
                   "ops/block_sparse.py", "ops/decode_attention.py",
                   "models/stage2/gpt.py", "models/stage2/ar.py",
                   "models/stage2/ar_cached.py", "pipelines/ar_generate.py",
                   "ops/fused_glue.py", "ops/layernorm.py",
                   "data/argoverse.py", "data/camera_geometry.py",
                   "data/datamodule.py", "data/rasterize.py", "data/sync.py",
                   "utils/image.py", "utils/viz.py",
                   "utils/outputs.py", "scripts/cli.py",
                   "scripts/tokenize_data.py", "ops/quant.py",
                   "scripts/crossover_sweep.py", "metrics/fid.py",
                   "metrics/inception.py", "metrics/loftr.py",
                   "metrics/consistency.py", "scripts/metrics_eval.py",
                   "scripts/inference.py", "utils/profiling.py",
                   "data/nuscenes.py", "data/nuscenes_raster.py",
                   "scripts/validate_data.py", "models/geometry.py"):
        assert f"bevgen_torch/{module}" in checked, module
    bad = {str(p.relative_to(ROOT)): sorted(set(_imported_roots(p)) & FORBIDDEN)
           for p in files}
    assert {k: v for k, v in bad.items() if v} == {}


def _tiny_port():
    return BEVGenPipeline.create(tcfg.tiny_test_config(), device="cpu",
                                 dtype="float32")


def tiny_tree():
    from torch_parity import tiny_tree
    return tiny_tree()


def test_load_jax_params_fills_every_parameter():
    tree = tiny_tree()
    pipe = load_jax_params(_tiny_port(), tree)
    w = tree["maskgit"]["params"]["transformer"]["layers_0_attn"]["to_q"]["kernel"]
    np.testing.assert_array_equal(
        pipe.maskgit.transformer.layers_0_attn.to_q.weight.detach().numpy(), w.T)
    k = tree["first_stage"]["params"]["encoder"]["conv_in"]["kernel"]
    np.testing.assert_array_equal(
        pipe.first_stage.encoder.conv_in.weight.detach().numpy(),
        k.transpose(3, 2, 0, 1))


def test_export_jax_params_inverts_load():
    import jax
    from bevgen_torch.core.convert import export_jax_params
    tree = tiny_tree()
    out = export_jax_params(load_jax_params(_tiny_port(), tree))
    assert (jax.tree_util.tree_structure(out)
            == jax.tree_util.tree_structure(tree))
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(out),
                                 jax.tree_util.tree_leaves_with_path(tree)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_load_jax_params_raises_on_extra_leaf():
    tree = copy.deepcopy(tiny_tree())
    tree["maskgit"]["params"]["transformer"]["stray"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="stray"):
        load_jax_params(_tiny_port(), tree)


def test_load_jax_params_raises_on_missing_leaf():
    tree = copy.deepcopy(tiny_tree())
    del tree["maskgit"]["params"]["critic"]
    with pytest.raises(KeyError, match="critic"):
        load_jax_params(_tiny_port(), tree)


def test_load_jax_params_raises_on_shape_mismatch():
    tree = copy.deepcopy(tiny_tree())
    tree["first_stage"]["params"]["codebook"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="codebook"):
        load_jax_params(_tiny_port(), tree)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path):
    from bevgen_torch.core.device import resolve_device
    from bevgen_torch.scripts import generate as cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfg.tiny_test_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BEVGenPipeline.create(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["preset=tiny_test", f"out={tmp_path}"])
    assert BEVGenPipeline.create(cfg, device="cpu").device.type == "cpu"


def test_ar_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                             tmp_path):
    from bevgen_torch.pipelines.ar_generate import ARPipeline
    from bevgen_torch.scripts import generate as cli
    from torch_parity import ar_tiny_configs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ar_tiny_configs()[1]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ARPipeline.create(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["pipeline=ar", "transformer.num_layers=1", f"out={tmp_path}"])
    assert not any(tmp_path.iterdir())
    assert ARPipeline.create(cfg, device="cpu").device.type == "cpu"


def test_data_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                               tmp_path):
    """The data-fed generate and the tokenizer, on real data and on fake
    batches, raise without a card before they read or write anything."""
    from bevgen_torch.scripts import generate as cli
    from bevgen_torch.scripts import tokenize_data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("ARGOVERSE_DATA_DIR", str(tmp_path / "tree"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["preset=tiny_test", "datamodule.split=val",
                  f"out={tmp_path / 'o'}", f"eval_generate={tmp_path / 'e'}"])
    for extra in ([], ["fake=1"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tokenize_data.main(["preset=tiny_test", f"out_dir={tmp_path / 't'}",
                                *extra])
    assert not any(tmp_path.iterdir())


def test_metrics_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch, tmp_path):
    """The evaluation path's entry points raise without a card before they
    read anything: the Inception extractor, the LoFTR matcher (directly and
    through `get_matcher` with weights set) and the metrics_eval CLI."""
    from bevgen_torch.metrics import consistency, fid, loftr
    from bevgen_torch.scripts import metrics_eval
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = loftr.init_random_params(np.random.default_rng(0), fine=False)
    np.savez(tmp_path / "loftr.npz", **params)
    monkeypatch.setenv("BEVGEN_LOFTR_WEIGHTS", str(tmp_path / "loftr.npz"))
    for call in (lambda: fid.make_inception_features(str(tmp_path / "i.npz")),
                 lambda: loftr.LoFTRMatcher(params),
                 consistency.get_matcher,
                 lambda: metrics_eval.main([f"dir={tmp_path / 'missing'}"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert loftr.LoFTRMatcher(params, device="cpu").device.type == "cpu"
    assert consistency.get_matcher("cpu") is not None


def test_inference_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch, tmp_path):
    """The benchmark CLI and the profiling functions that touch the device
    raise without a card before they build or write anything."""
    from bevgen_torch.scripts import inference
    from bevgen_torch.utils import profiling
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
            lambda: inference.main(["preset=tiny_test", "reps=1",
                                    f"trace_dir={tmp_path / 't'}",
                                    "profile=true"]),
            lambda: inference.main(["preset=tiny_test", "platform=gpu"]),
            lambda: profiling.benchmark(lambda: 1),
            profiling.device_memory_stats,
            lambda: profiling.trace(str(tmp_path / "t")).__enter__()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not any(tmp_path.iterdir())
    assert profiling.benchmark(lambda: 1, reps=1, device="cpu")["best_ms"] >= 0


HOST_DATA_PACKAGES = ("cv2", "pandas", "pyarrow", "PIL", "yaml", "rich")


def test_fake_data_paths_import_no_host_data_packages(tmp_path):
    """In a fresh interpreter: every port module that chip_smoke.py imports,
    the nuScenes reader's and `validate_data`'s modules, the generate CLI on
    fake batches (partial decode, reconstruction, the printed config) and the
    tokenizer on fake batches pull in none of cv2, pandas, pyarrow, PIL, yaml
    or rich, which the card's machine is not known to have."""
    import json
    import subprocess
    import sys
    mods = sorted({n.module for n in ast.walk(ast.parse(
        (ROOT / "chip_smoke.py").read_text()))
        if isinstance(n, ast.ImportFrom) and n.module
        and n.module.startswith("bevgen_torch")})
    assert "bevgen_torch.pipelines.generate" in mods
    code = f"""
import importlib, json, sys
sys.path.insert(0, {str(ROOT)!r})
import chip_smoke
for m in {mods!r}:
    importlib.import_module(m)
from bevgen_torch.scripts import generate, tokenize_data
import bevgen_torch.data.nuscenes, bevgen_torch.data.nuscenes_raster
import bevgen_torch.scripts.validate_data
generate.run(["preset=tiny_test", "device=cpu", "fake=1", "batch_size=2",
              "muse.sample_iterations=2", "keep_cameras=ring_front_left",
              "save_rec=true", "out={tmp_path / 'g'}"])
tokenize_data.main(["preset=tiny_test", "device=cpu", "fake=1",
                    "batch_size=2", "out_dir={tmp_path / 't'}"])
print(json.dumps(sorted(m for m in {HOST_DATA_PACKAGES!r} if m in sys.modules)))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert (tmp_path / "t" / "shard_00000.npz").exists()


def test_profile_train_ar_needs_cuda_and_rejects_unknown_pipelines(monkeypatch):
    from bevgen_torch.scripts import profile_train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="unknown pipeline"):
        profile_train.main(["pipeline=bogus"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profile_train.main(["pipeline=ar"])


def _tiny_ar_port():
    from bevgen_torch.pipelines.ar_generate import ARPipeline
    from torch_parity import ar_tiny_configs
    return ARPipeline.create(ar_tiny_configs()[1], device="cpu", dtype="float32")


def test_load_jax_params_fills_and_exports_the_ar_tree():
    import jax
    from bevgen_torch.core.convert import export_jax_params
    from torch_parity import ar_tiny_tree
    tree = ar_tiny_tree()
    pipe = load_jax_params(_tiny_ar_port(), tree)
    gpt = tree["gpt"]["params"]
    np.testing.assert_array_equal(pipe.gpt.block_1.mlp_fc.weight.detach().numpy(),
                                  gpt["block_1"]["mlp_fc"]["kernel"].T)
    np.testing.assert_array_equal(pipe.gpt.block_0.ln1.norm.bias.detach().numpy(),
                                  gpt["block_0"]["ln1"]["norm"]["bias"])
    np.testing.assert_array_equal(pipe.gpt.x_pos_emb.detach().numpy(),
                                  gpt["x_pos_emb"])
    out = export_jax_params(pipe)
    assert (jax.tree_util.tree_structure(out)
            == jax.tree_util.tree_structure(tree))
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(out),
                                 jax.tree_util.tree_leaves_with_path(tree)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_load_jax_params_raises_on_extra_gpt_leaf():
    from torch_parity import ar_tiny_tree
    tree = ar_tiny_tree()
    tree["gpt"]["params"]["block_0"]["stray"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="stray"):
        load_jax_params(_tiny_ar_port(), tree)


def test_load_jax_params_raises_on_missing_gpt_leaf():
    from torch_parity import ar_tiny_tree
    tree = ar_tiny_tree()
    del tree["gpt"]["params"]["block_1"]["value"]
    with pytest.raises(KeyError, match="block_1.value"):
        load_jax_params(_tiny_ar_port(), tree)
    tree = ar_tiny_tree()
    del tree["gpt"]
    with pytest.raises(KeyError, match="gpt"):
        load_jax_params(_tiny_ar_port(), tree)


def test_train_stage2_defaults_to_cuda_and_raises_without_it(monkeypatch,
                                                            tmp_path):
    from bevgen_torch.scripts import train_stage2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_stage2.main(["preset=tiny_test", "steps=1",
                           f"ckpt_dir={tmp_path}"])
    assert not any(tmp_path.iterdir())


def test_cpu_attention_function_runs_the_plain_backward(monkeypatch):
    from bevgen_torch.ops import attention_bwd as ab
    from bevgen_torch.ops import cosine_attention as ca
    calls = []
    plain = ab.attention_bwd_reference
    monkeypatch.setattr(ab, "attention_bwd_reference",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 2, 8, 32, generator=g, requires_grad=True)
    k = ca._l2n(torch.randn(1, 2, 5, 32, generator=g))
    v = torch.randn(1, 2, 5, 32, generator=g)
    nkv = torch.randn(2, 2, 1, 32, generator=g, requires_grad=True)
    out = ca.cosine_attention(q, k, v, nkv, torch.ones(32), torch.ones(32))
    assert out.requires_grad
    assert isinstance(out.grad_fn, ca.CosineAttentionFn._backward_cls)
    launches = ca.cosine_attention_cuda.launches
    out.sum().backward()
    assert calls == [1]
    assert q.grad is not None and nkv.grad is not None
    assert ca.cosine_attention_cuda.launches == launches
    with torch.no_grad():  # serving: no Function, no backward state
        assert ca.cosine_attention(q, k, v, nkv, torch.ones(32),
                                   torch.ones(32)).grad_fn is None


def test_attention_dispatch_has_no_other_device():
    from bevgen_torch.ops.cosine_attention import cosine_attention
    q = torch.zeros(1, 1, 4, 32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        cosine_attention(q, q, q, torch.zeros(2, 1, 1, 32, device="meta"),
                         torch.ones(32), torch.ones(32))


def _cuda_rows(g, B, H, L, D, strided, scale=1.0):
    """(B, H, L, D) bf16 on the card: contiguous, or a head-transposed view
    of a (B, L, H, D) tensor as the transformer hands it over."""
    if strided:
        x = scale * torch.randn(B, L, H, D, generator=g, device="cuda")
        return x.bfloat16().transpose(1, 2)
    return (scale * torch.randn(B, H, L, D, generator=g, device="cuda")).bfloat16()


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from bevgen_torch.ops import cosine_attention as ca
    g = torch.Generator(device="cuda").manual_seed(0)
    for B, H, N, M, D, with_bias, keep, strided in [
            (2, 4, 96, 70, 64, True, [1, 0], False),
            (1, 2, 130, 64, 32, False, None, False),
            (2, 16, 256, 256, 64, True, None, False),
            (2, 4, 96, 70, 64, True, [1, 0], True),
            (2, 3, 200, 257, 64, True, [1, 0], True),
            (1, 4, 130, 1793, 64, True, None, False),
            (2, 3, 70, 257, 32, True, [0, 1], True)]:
        ks = 1 + 0.1 * torch.randn(D, generator=g, device="cuda")
        qs = 1 + 0.1 * torch.randn(D, generator=g, device="cuda")
        q = _cuda_rows(g, B, H, N, D, strided)
        k = (ca._l2n(_cuda_rows(g, B, H, M, D, strided).float())
             * ks).bfloat16()
        if strided:
            k = k.transpose(1, 2).contiguous().transpose(1, 2)
        v = _cuda_rows(g, B, H, M, D, strided)
        nkv = torch.randn(2, H, 1, D, generator=g, device="cuda")
        bias = (torch.rand(N, M, generator=g, device="cuda") * 2
                if with_bias else None)
        kp = None if keep is None else torch.tensor(keep, device="cuda")
        got = ca.cosine_attention(q, k, v, nkv, qs, ks, bias, kp)
        want = ca.cosine_attention_reference(q.float(), k.float(), v.float(),
                                             nkv, qs, ks, bias, kp)
        err = (got.float() - want).abs()
        # bf16 rounding of q^, the softmax weights and the output
        assert err.max().item() <= 2e-2 and err.mean().item() <= 2e-3, \
            (B, H, N, M, D, strided)


@pytest.mark.cuda
def test_cuda_attention_output_has_grad_fn():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from bevgen_torch.ops import cosine_attention as ca
    g = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn(2, 4, 96, 64, generator=g, device="cuda").bfloat16()
    k = ca._l2n(torch.randn(2, 4, 70, 64, generator=g, device="cuda")).bfloat16()
    v = torch.randn(2, 4, 70, 64, generator=g, device="cuda").bfloat16()
    nkv = torch.randn(2, 4, 1, 64, generator=g, device="cuda")
    bias = torch.rand(96, 70, generator=g, device="cuda")
    leaves = [t.requires_grad_() for t in (q, k, v, nkv, bias)]
    before = ca.cosine_attention_cuda.launches
    out = ca.cosine_attention(q, k, v, nkv, torch.ones(64, device="cuda"),
                              torch.ones(64, device="cuda"), bias,
                              torch.tensor([1, 0], device="cuda"))
    assert ca.cosine_attention_cuda.launches == before + 1
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out.float().square().sum(), leaves)
    assert all(gr is not None and torch.isfinite(gr).all() for gr in grads)


@pytest.mark.cuda
def test_cuda_backward_kernels_match_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from bevgen_torch.ops import attention_bwd as ab
    from bevgen_torch.ops import bias_attention as ba
    g = torch.Generator(device="cuda").manual_seed(2)
    for B, H, N, M, D, with_bias, keep, strided in [
            (2, 4, 96, 70, 64, True, [1, 0], False),
            (1, 2, 130, 33, 32, False, None, False),
            (2, 3, 96, 257, 64, True, [1, 0], True),
            (1, 2, 130, 1793, 64, True, None, True)]:
        q = _cuda_rows(g, B, H, N, D, strided, 0.3)
        k = _cuda_rows(g, B, H, M, D, strided, 0.3)
        v = _cuda_rows(g, B, H, M, D, strided)
        do = torch.randn(B, H, N, D, generator=g, device="cuda").bfloat16()
        bias = (torch.rand(N, M, generator=g, device="cuda")
                if with_bias else None)
        kp = None if keep is None else torch.tensor(keep, device="cuda")
        out = ba.bias_attention(q, k, v, bias, kp, 8.0)
        want_out = ba.bias_attention_reference(q.float(), k.float(), v.float(),
                                               bias, kp, 8.0)
        assert (out.float() - want_out).abs().max().item() <= 2e-2
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        got = torch.autograd.grad(ba.bias_attention(*leaves, bias, kp, 8.0),
                                  leaves, do)
        want = ab.attention_bwd_reference(q.float(), k.float(), v.float(),
                                          bias, kp, do.float(), 8.0)
        # bf16 rounding of P, dS and the outputs: 1e-2 relative L2
        for a, w in zip(got, want):
            assert ((a.float() - w).norm() / w.norm()).item() <= 1e-2


def _sparse_cuda_case(g, B, H, L, D, block, nc, num_pad):
    nb = -(-L // block)
    rng = np.random.default_rng(L)
    layout = (rng.uniform(size=(H, nb, nb)) < 0.5) & np.tril(np.ones((nb, nb), bool))
    layout |= np.eye(nb, dtype=bool)
    layout[:, (L - num_pad) // block:, 0] = True
    q, k, v = (torch.randn(B, H, L, D, generator=g, device="cuda").bfloat16()
               for _ in range(3))
    return layout.astype(np.int64), q, k, v


@pytest.mark.cuda
def test_cuda_block_sparse_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from bevgen_torch.ops import block_sparse as bs
    g = torch.Generator(device="cuda").manual_seed(3)
    for B, H, L, D, block, nc, num_pad, with_bias in [
            (2, 3, 200, 64, 8, 24, 8, True), (1, 2, 190, 64, 16, 20, 6, False),
            (2, 4, 256, 64, 128, 64, 0, True)]:
        layout, q, k, v = _sparse_cuda_case(g, B, H, L, D, block, nc, num_pad)
        bias = (torch.randn(L, L, generator=g, device="cuda")
                if with_bias else None)
        attn = bs.SparseAttention(layout, block, nc, num_pad)
        before = bs.block_sparse_attention_cuda.launches
        with torch.no_grad():
            out, lse = attn(q, k, v, bias, return_lse=True)
        assert bs.block_sparse_attention_cuda.launches == before + 1
        want, want_lse = bs.block_sparse_attention_reference(
            q, k, v, torch.from_numpy(layout), block, nc, num_pad, bias,
            return_lse=True)
        err = (out.float() - want.float()).abs()
        # bf16 rounding of the softmax weights and the output
        assert err.max().item() <= 2e-2 and err.mean().item() <= 2e-3
        assert (lse - want_lse).abs().max().item() <= 5e-3


def _rel_errors(got, want):
    d = got.float() - want.float()
    return ((d.norm() / want.float().norm()).item(),
            d.abs().max().item() / want.float().abs().max().item())


@pytest.mark.cuda
def test_cuda_block_sparse_backward_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from bevgen_torch.ops import block_sparse as bs
    g = torch.Generator(device="cuda").manual_seed(4)
    for B, H, L, D, block, nc, num_pad, with_bias in [
            (2, 3, 200, 64, 8, 24, 8, True), (1, 2, 190, 64, 16, 20, 6, False),
            (2, 4, 256, 64, 128, 64, 0, True)]:
        layout, q, k, v = _sparse_cuda_case(g, B, H, L, D, block, nc, num_pad)
        bias = (torch.randn(L, L, generator=g, device="cuda")
                if with_bias else None)
        do = torch.randn(B, H, L, D, generator=g, device="cuda").bfloat16()
        attn = bs.SparseAttention(layout, block, nc, num_pad)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        if with_bias:
            leaves.append(bias.detach().clone().requires_grad_())
        fwd, bwd = (bs.block_sparse_attention_cuda.launches,
                    bs.block_sparse_attention_bwd_cuda.launches)
        out = attn(*leaves[:3], leaves[3] if with_bias else None)
        assert out.grad_fn is not None
        got = torch.autograd.grad(out, leaves, do)
        assert bs.block_sparse_attention_cuda.launches == fwd + 1
        assert bs.block_sparse_attention_bwd_cuda.launches == bwd + (3 if with_bias else 2)
        with torch.no_grad():
            out, lse = attn(q, k, v, bias, return_lse=True)
        want = bs.block_sparse_attention_bwd_reference(
            q.float(), k.float(), v.float(), torch.from_numpy(layout), block,
            nc, num_pad, bias, out, do, lse)
        # bf16 rounding of P, dS and the outputs: 1e-2 relative L2, and no
        # entry off by more than 5% of the largest
        for a, w in zip(got, want):
            rel_l2, rel_max = _rel_errors(a, w)
            assert rel_l2 <= 1e-2 and rel_max <= 5e-2
        if with_bias:  # a bias that needs no gradient skips the dbias kernel
            bwd = bs.block_sparse_attention_bwd_cuda.launches
            again = torch.autograd.grad(attn(*leaves[:3], bias), leaves[:3], do)
            assert bs.block_sparse_attention_bwd_cuda.launches == bwd + 2
            for a, w in zip(again, got):
                assert torch.equal(a, w)


@pytest.mark.cuda
def test_cuda_block_sparse_backward_refuses_other_head_dims():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from bevgen_torch.ops import block_sparse as bs
    g = torch.Generator(device="cuda").manual_seed(6)
    layout, q, k, v = _sparse_cuda_case(g, 1, 2, 128, 32, 16, 16, 0)
    plan = bs.SparseAttention(layout, 16, 16).device_plan(128, q.device)
    lse = torch.zeros(1, 2, 128, device="cuda")
    with pytest.raises(ValueError, match="head dim 32"):
        bs.block_sparse_attention_bwd_cuda(q, k, v, plan.layout, plan.counts,
                                           plan.indices, plan.full,
                                           plan.counts_t, plan.indices_t,
                                           plan.full_t, 16, 16, 0, None,
                                           q, q, lse)


def test_block_sparse_backward_wrapper_raises_for_cpu_tensors():
    from bevgen_torch.ops import block_sparse as bs
    layout = np.tril(np.ones((2, 8, 8), np.int64))
    plan = bs.SparseAttention(layout, 16, 16).device_plan(128, torch.device("cpu"))
    x = torch.zeros(1, 2, 128, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 128)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bs.block_sparse_attention_bwd_cuda(x, x, x, plan.layout, plan.counts,
                                           plan.indices, plan.full,
                                           plan.counts_t, plan.indices_t,
                                           plan.full_t, 16, 16, 0, None,
                                           x, x, lse)
    assert bs.block_sparse_attention_bwd_cuda.launches == 0


@pytest.mark.parametrize("which", ["full", "full_t"])
@pytest.mark.parametrize("bad", ["dtype", "shape"])
def test_block_sparse_wrappers_refuse_bad_full_flags(which, bad):
    """A full-flag tensor of the wrong dtype or shape raises in the
    wrappers' checks, before the device check and before any launch."""
    from bevgen_torch.ops import block_sparse as bs
    layout = np.tril(np.ones((2, 8, 8), np.int64))
    plan = bs.SparseAttention(layout, 16, 16).device_plan(128, torch.device("cpu"))
    flags = getattr(plan, which)
    wrong = (flags.to(torch.int32) if bad == "dtype"
             else flags[:, :, :-1].contiguous())
    plan = plan._replace(**{which: wrong})
    x = torch.zeros(1, 2, 128, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 128)
    err = TypeError if bad == "dtype" else ValueError
    with pytest.raises(err, match=f"^{which} has {bad}"):
        bs.block_sparse_attention_bwd_cuda(x, x, x, plan.layout, plan.counts,
                                           plan.indices, plan.full,
                                           plan.counts_t, plan.indices_t,
                                           plan.full_t, 16, 16, 0, None,
                                           x, x, lse)
    if which == "full":
        with pytest.raises(err, match=f"^full has {bad}"):
            bs.block_sparse_attention_cuda(x, x, x, plan.layout, plan.counts,
                                           plan.indices, plan.full, 16, 16)
    assert bs.block_sparse_attention_cuda.launches == 0
    assert bs.block_sparse_attention_bwd_cuda.launches == 0


@pytest.mark.cuda
def test_cuda_decode_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from bevgen_torch.ops import decode_attention as da
    g = torch.Generator(device="cuda").manual_seed(5)
    for b, H, pl, cap, dh in [(1, 3, 70, 96, 64), (2, 16, 512, 2368, 64),
                              (3, 5, 33, 33, 64)]:
        q = torch.randn(b, H, dh, generator=g, device="cuda").bfloat16()
        kc, vc = (torch.randn(b, H, cap, dh, generator=g, device="cuda").bfloat16()
                  for _ in range(2))
        addend = torch.randn(H, pl, generator=g, device="cuda")
        addend[:, pl // 2:] = da.NEG_INF
        before = da.decode_attention_cuda.launches
        got = da.decode_attention(q, kc[:, :, :pl], vc[:, :, :pl], addend, 0.125)
        assert da.decode_attention_cuda.launches == before + 1
        want = da.decode_attention_reference(q, kc[:, :, :pl], vc[:, :, :pl],
                                             addend, 0.125)
        # both round the weights and the output to bf16 and part by about
        # one bf16 step (2^-8 relative) where a rounding falls the other way
        err = (got.float() - want.float()).abs()
        assert err.max().item() <= 2e-2 * want.float().abs().max().item()
        assert err.mean().item() <= 1e-2 * want.float().abs().mean().item()


def test_glue_cuda_wrappers_raise_for_cpu_tensors():
    from bevgen_torch.ops import fused_glue as fg
    from bevgen_torch.ops import layernorm as ln
    x = torch.zeros(3, 64, dtype=torch.bfloat16)
    g = torch.ones(64)
    for call in (lambda: fg.residual_layernorm_cuda(x, x, g),
                 lambda: fg.geglu_layernorm_cuda(x, g[:32]),
                 lambda: ln.layernorm_cuda(x, g)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    assert fg.residual_layernorm_cuda.launches == 0
    assert fg.geglu_layernorm_cuda.launches == 0
    assert ln.layernorm_cuda.launches == 0


def test_cpu_glue_functions_run_the_twins(monkeypatch):
    from bevgen_torch.ops import fused_glue as fg
    from bevgen_torch.ops import layernorm as ln
    calls = []
    twin = fg.residual_layernorm_reference
    monkeypatch.setattr(fg, "residual_layernorm_reference",
                        lambda *a: calls.append(1) or twin(*a))
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 9, 64, generator=g, requires_grad=True)
    d = torch.randn(2, 9, 64, generator=g)
    gamma = torch.ones(64, requires_grad=True)
    xo, no = fg.residual_layernorm(x, d, gamma)
    assert isinstance(no.grad_fn, fg.ResidualLayerNormFn._backward_cls)
    assert calls == [1]
    (no.sum() + xo.sum()).backward()
    assert calls == [1, 1]  # the backward recomputes through the twin
    assert x.grad is not None and gamma.grad is not None
    y = torch.randn(2, 9, 128, generator=g, requires_grad=True)
    assert isinstance(fg.geglu_layernorm(y, gamma).grad_fn,
                      fg.GegluLayerNormFn._backward_cls)
    assert isinstance(ln.layernorm(x, gamma).grad_fn,
                      ln.LayerNormFn._backward_cls)
    with torch.no_grad():  # serving: no Function, no saved inputs
        assert fg.residual_layernorm(x, d, gamma)[1].grad_fn is None
        assert fg.geglu_layernorm(y, gamma).grad_fn is None
        assert ln.layernorm(x, gamma).grad_fn is None
    for t in (fg.residual_layernorm_cuda, fg.geglu_layernorm_cuda,
              ln.layernorm_cuda):
        assert t.launches == 0


def _glue_cases(g):
    """bf16 inputs at widths even and odd (bf16x2 and scalar accesses)."""
    for rows, F in [(13, 1024), (9, 1003), (4, 2730), (5, 170)]:
        x, d = (torch.randn(rows, F, generator=g, device="cuda").bfloat16()
                for _ in range(2))
        y = torch.randn(rows, 2 * F, generator=g, device="cuda").bfloat16()
        gamma = 1 + 0.2 * torch.randn(F, generator=g, device="cuda")
        yield x, d, y, gamma


@pytest.mark.cuda
def test_cuda_glue_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from bevgen_torch.ops import fused_glue as fg
    from bevgen_torch.ops import layernorm as ln
    g = torch.Generator(device="cuda").manual_seed(7)
    for x, d, y, gamma in _glue_cases(g):
        counts = (fg.residual_layernorm_cuda.launches,
                  fg.geglu_layernorm_cuda.launches, ln.layernorm_cuda.launches)
        xo, no = fg.residual_layernorm(x, d, gamma)
        z = fg.geglu_layernorm(y, gamma)
        n = ln.layernorm(x, gamma)
        assert (fg.residual_layernorm_cuda.launches,
                fg.geglu_layernorm_cuda.launches,
                ln.layernorm_cuda.launches) == tuple(c + 1 for c in counts)
        want_x, _ = fg.residual_layernorm_reference(x, d, gamma)
        assert torch.equal(xo, want_x)  # bit for bit
        # against the twins in fp32 on the same bf16 inputs (the rounded
        # x_new for the residual): the kernels round h and the outputs to
        # bf16, at most 2^-8 + 2^-9 of |out|, under one bf16 step
        for got, want in ((no, ln.layernorm_reference(want_x.float(), gamma)),
                          (z, fg.geglu_layernorm_reference(y.float(), gamma)),
                          (n, ln.layernorm_reference(x.float(), gamma))):
            err = (got.float() - want).abs()
            assert (err <= torch.clamp(2.0 ** -7 * want.abs(), min=2e-2)).all()
            assert err.mean().item() <= 2e-3


@pytest.mark.cuda
def test_cuda_glue_outputs_have_grad_fn():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from bevgen_torch.ops import fused_glue as fg
    from bevgen_torch.ops import layernorm as ln
    g = torch.Generator(device="cuda").manual_seed(8)
    x, d, y, gamma = next(_glue_cases(g))
    leaves = [t.requires_grad_() for t in (x, d, y, gamma)]
    before = fg.residual_layernorm_cuda.launches
    xo, no = fg.residual_layernorm(x, d, gamma)
    assert fg.residual_layernorm_cuda.launches == before + 1
    z = fg.geglu_layernorm(y, gamma)
    n = ln.layernorm(x, gamma)
    assert isinstance(no.grad_fn, fg.ResidualLayerNormFn._backward_cls)
    assert isinstance(z.grad_fn, fg.GegluLayerNormFn._backward_cls)
    assert isinstance(n.grad_fn, ln.LayerNormFn._backward_cls)
    loss = sum(t.float().square().sum() for t in (xo, no, z, n))
    grads = torch.autograd.grad(loss, leaves)
    assert all(gr is not None and torch.isfinite(gr).all() for gr in grads)


@pytest.mark.cuda
def test_cuda_glue_kernels_refuse_other_dtypes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from bevgen_torch.ops import fused_glue as fg
    from bevgen_torch.ops import layernorm as ln
    x = torch.randn(9, 64, device="cuda")           # fp32 activations
    gamma = torch.ones(64, device="cuda")
    with pytest.raises(TypeError, match="bfloat16"):
        fg.residual_layernorm(x, x, gamma)
    with pytest.raises(TypeError, match="bfloat16"):
        fg.geglu_layernorm(torch.randn(9, 128, device="cuda"), gamma)
    with pytest.raises(TypeError, match="bfloat16"):
        ln.layernorm(x, gamma)
    xb = x.bfloat16()                               # bf16 gamma
    with pytest.raises(TypeError, match="float32"):
        fg.residual_layernorm(xb, xb, gamma.bfloat16())


@pytest.mark.cuda
def test_cuda_layernorm_variants_match_plain_version():
    """Row 14's two forms on the card, each where `layernorm_variant` sends
    it (aligned widths up to the cap: the register form; views off 16
    bytes, odd widths, widths above the cap: the general form), against the
    plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from bevgen_torch.ops import layernorm as ln
    g = torch.Generator(device="cuda").manual_seed(3)
    cases = [((2, 64, 1024), 0, "warp"), ((2, 64, 1024), 1, "block"),
             ((2, 64, 1024), 2, "block"), ((3, 13, 1003), 0, "block"),
             ((5, 7, 2048), 0, "warp"), ((4, 9, 4096), 0, "block"),
             ((1, 300, 64), 0, "warp")]
    for shape, off, want in cases:
        n = shape[0] * shape[1] * shape[2]
        buf = torch.randn(n + off, generator=g, device="cuda").bfloat16()
        x = buf[off:].view(shape)
        scale = 1 + 0.1 * torch.randn(shape[-1], generator=g, device="cuda")
        before = dict(ln.layernorm_cuda.launches_by_variant)
        got = ln.layernorm(x, scale)
        after = ln.layernorm_cuda.launches_by_variant
        assert {k: after[k] - before[k] for k in after} == {
            v: int(v == want) for v in ln.VARIANTS}, (shape, off)
        ref = ln.layernorm_reference(x.float(), scale)
        err = (got.float() - ref).abs()
        assert err.max().item() <= 2e-2 and err.mean().item() <= 2e-3


@pytest.mark.cuda
def test_cuda_glue_split_matches_plain_versions():
    """Row 13's split pair on the card against the plain versions, at odd and
    even Fl, at rows that are not a multiple of 4 or 8 and on views 2 bytes
    off 16: the statistics within 1e-4 of their magnitude, the norm within
    the glue's bound, and a misaligned view's outputs (single-element
    accesses) equal bit for bit to an aligned copy's (bf16x2 at even Fl)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from bevgen_torch.ops import fused_glue as fg
    g = torch.Generator(device="cuda").manual_seed(4)
    cases = [(64, 1365), (37, 910), (1537, 1365), (71, 3), (33, 64)]
    for rows, Fl in cases:
        buf = (2 * torch.randn(rows * 2 * Fl + 1, generator=g,
                               device="cuda")).bfloat16()
        gamma = 1 + 0.1 * torch.randn(Fl, generator=g, device="cuda")
        F = 2 * Fl
        for off in (0, 1):
            y = buf[off:off + rows * 2 * Fl].view(rows, 2 * Fl)
            assert y.data_ptr() % 16 == 2 * off
            stats = fg.geglu_stats_cuda(y)
            total = stats * 2                     # another rank's the same
            got = fg.geglu_norm_cuda(y, total, gamma, F)
            ref = fg.geglu_stats_reference(y)
            assert ((stats - ref).abs() <= 1e-4 * ref.abs().clamp_min(1.0)).all()
            want_n = fg.geglu_norm_reference(y.float(), total, gamma, F)
            err = (got.float() - want_n).abs()
            assert (err <= torch.clamp(2.0 ** -7 * want_n.abs(), min=2e-2)).all()
        # the same statistics: the two kinds of access give the same bits
        assert torch.equal(fg.geglu_norm_cuda(y, total, gamma, F),
                           fg.geglu_norm_cuda(y.clone(), total, gamma, F)), (
            rows, Fl)


def _int8_cuda_case(rows, K, N, static, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(rows, K, generator=g, device="cuda") * 2).bfloat16()
    w = torch.randint(-127, 128, (N, K), generator=g, device="cuda",
                      dtype=torch.int8)
    scale = torch.rand(N, generator=g, device="cuda") * 0.01 + 1e-3
    in_scale = (torch.rand(K, generator=g, device="cuda") * 0.05 + 0.01
                if static else None)
    return x, w, scale, in_scale


@pytest.mark.cuda
def test_cuda_int8_kernels_match_plain_versions():
    """The int8 serving kernels (`csrc/int8.cu`, `csrc/int8_gemm.cu`) on the
    card against their plain versions on bf16 activations: the quantizers
    bit for bit (int8 values, zero padding, row scales), `torch._int_mm` on
    the padded operands equal to the exact int32 product, the epilogue bit
    for bit in fp32 and bf16, `int8_linear` bit for bit against that chain
    and the plain version in both output types, and `w8_linear` (the decode
    and the prefill form) within its rounding; a K that w8_linear's 16-byte
    copies cannot take raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from bevgen_torch.ops import quant as tq
    for rows, K, N in ((3584, 1024, 1024), (40, 2730, 1024), (5, 24, 20)):
        for static in (False, True):
            for dtype in (torch.float32, torch.bfloat16):   # the epilogue's
                x, w, scale, in_scale = _int8_cuda_case(rows, K, N, static,
                                                        rows + K)
                Kp, Np = tq.padded(K), tq.padded(N)
                if static:
                    got = tq.quantize_static_cuda(x, in_scale, Kp)[:rows]
                    want = tq.quantize_activations_static(x, 1.0 / in_scale)
                    xs = None
                else:
                    got, xs = tq.quantize_dynamic_cuda(x, Kp)
                    got = got[:rows]
                    want, want_s = tq.quantize_activations(x)
                    assert torch.equal(xs, want_s[:, 0])
                assert torch.equal(got[:, :K], want)
                assert not got[:, K:].any()
                wp = torch.zeros(Np, Kp, dtype=torch.int8, device="cuda")
                wp[:N, :K] = w
                xq = torch.zeros(max(rows, 17), Kp, dtype=torch.int8,
                                 device="cuda")
                xq[:rows] = got
                acc = torch._int_mm(xq, wp.t())
                assert torch.equal(acc[:rows, :N], tq.int8_product(want, w))
                out = tq.int8_epilogue_cuda(acc, scale, xs, rows, dtype)
                ref = tq.int8_epilogue_reference(acc[:rows, :N], scale,
                                                 None if xs is None else xs[:, None],
                                                 dtype)
                assert torch.equal(out, ref)
                op = torch.zeros(Np, tq.padded(K, tq.K_PAD), dtype=torch.int8,
                                 device="cuda")
                op[:N, :K] = w
                fused = tq.int8_linear_cuda(x, op, scale, in_scale, dtype)
                assert torch.equal(fused, out)
                assert torch.equal(fused, tq.int8_dense_reference(
                    x.to(dtype), op, scale, in_scale))
    for M, K, N in ((2, 1024, 3072), (512, 1024, 4096), (2, 4096, 1024),
                    (3, 32, 20), (40, 32, 20)):
        x, w, scale, _ = _int8_cuda_case(M, K, N, False, M + N)
        bias = (torch.randn(N, device="cuda") * 0.1).bfloat16()
        got = tq.w8_linear_cuda(x, w, scale, bias)
        want = tq.w8_linear_reference(x.float(), w, scale, bias.float())
        # three bf16 roundings, each within 2^-8 of the value's size
        assert (got.float() - want).abs().max().item() <= \
            2.0 ** -6 * max(1.0, want.abs().max().item())
    x, w, scale, _ = _int8_cuda_case(3, 24, 20, False, 0)
    with pytest.raises(ValueError, match="K % 16"):
        tq.w8_linear_cuda(x, w, scale, None)


# the scene editor and the host-side scripts (their own guards)
EDITOR_AND_HOST_MODULES = (
    "native.py", "data/rasterize.py", "models/masks.py",
    "models/conditioning.py", "utils/logging.py", "scripts/edit_scene.py",
    "scripts/edit_server.py", "scripts/preprocess.py", "scripts/curate.py",
    "scripts/make_figures.py", "scripts/pseudo_seg.py")


def test_editor_and_host_modules_import_no_jax_or_reference_package():
    """The import guard's walk covers the editor's and the host scripts'
    modules, and none imports JAX or the JAX package; the native core's
    source is the port's own copy."""
    checked = {str(p.relative_to(ROOT)) for p in _port_files()}
    for module in EDITOR_AND_HOST_MODULES:
        path = f"bevgen_torch/{module}"
        assert path in checked, module
        assert not set(_imported_roots(ROOT / path)) & FORBIDDEN, module
    from bevgen_torch import native
    assert native.SRC == ROOT / "bevgen_torch" / "csrc" / "rasterize.cpp"
    assert native.BUILD_DIR == ROOT / "bevgen_torch" / "build"


def test_editor_and_pseudo_seg_default_to_cuda_and_raise_without_it(
        monkeypatch, tmp_path):
    """The edit_scene CLI, `EditSession`, the edit server's CLI and
    pseudo_seg raise without a card before they draw, build, serve or
    write anything."""
    from bevgen_torch.scripts import edit_scene, edit_server, pseudo_seg
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = tmp_path / "seg.pt"
    for call in (
            lambda: edit_scene.main(["preset=tiny_test",
                                     f"out_dir={tmp_path / 'e'}"]),
            lambda: edit_scene.run(["preset=tiny_test", "platform=gpu"]),
            lambda: edit_server.EditSession(tcfg.tiny_test_config()),
            lambda: edit_server.main(["preset=tiny_test", "port=0"]),
            lambda: pseudo_seg.main([f"image_root={tmp_path}",
                                     f"save_dir={tmp_path / 's'}",
                                     f"model_path={model}"]),
            lambda: pseudo_seg._load_model(str(model))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not any(tmp_path.iterdir())
    session = edit_server.EditSession(tcfg.tiny_test_config(), device="cpu")
    assert session.pipe.device.type == "cpu"


def test_editor_on_the_native_route_imports_no_host_data_packages(tmp_path):
    """In a fresh interpreter with BEVGEN_NATIVE_RASTER=1, as chip_smoke.py
    runs the editor: `edit_scene.run`, an `EditSession` request and the
    server's construction pull in none of cv2, pandas, pyarrow, PIL, yaml or
    rich, which the card's machine is not known to have."""
    import json
    import subprocess
    import sys
    code = f"""
import json, os, sys
sys.path.insert(0, {str(ROOT)!r})
from bevgen_torch.core.config import tiny_test_config, apply_overrides
from bevgen_torch.scripts import edit_scene, edit_server
images, batch, raster = edit_scene.run(
    ["preset=tiny_test", "device=cpu", "muse.sample_iterations=2",
     'edits=[{{"op":"add","x":-34,"y":34,"length":4,"width":4}}]'])
assert raster[..., 0].sum() > 0
cfg = apply_overrides(tiny_test_config(), {{"muse.sample_iterations": 2}})
session = edit_server.EditSession(cfg, device="cpu")
out = session.generate(session.annotations, seed=1)
assert len(out["cameras"]) == 3
srv = edit_server.make_server(session, port=0)
srv.server_close()
print(json.dumps(sorted(m for m in {HOST_DATA_PACKAGES!r} if m in sys.modules)))
"""
    env = dict(__import__("os").environ, BEVGEN_NATIVE_RASTER="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
