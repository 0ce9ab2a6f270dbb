"""Guards of the PyTorch port: it imports nothing of JAX or of the JAX
package, `load_jax_params` accepts exactly the reference's tree, entry
points run on CUDA unless asked for the CPU, and (on a machine with a
card) the CUDA kernel agrees with its plain version.

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


def test_attention_dispatch_has_no_other_device():
    from bevgen_torch.ops.cosine_attention import cosine_attention
    q = torch.zeros(1, 1, 4, 32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        cosine_attention(q, q, q, torch.zeros(2, 1, 1, 32, device="meta"),
                         torch.ones(32), torch.ones(32))


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from bevgen_torch.ops import cosine_attention as ca
    g = torch.Generator(device="cuda").manual_seed(0)
    for B, H, N, M, D, with_bias, keep in [(2, 4, 96, 70, 64, True, [1, 0]),
                                            (1, 2, 130, 64, 32, False, None),
                                            (2, 16, 256, 256, 64, True, None)]:
        ks = 1 + 0.1 * torch.randn(D, generator=g, device="cuda")
        qs = 1 + 0.1 * torch.randn(D, generator=g, device="cuda")
        q = torch.randn(B, H, N, D, generator=g, device="cuda").bfloat16()
        k = (ca._l2n(torch.randn(B, H, M, D, generator=g, device="cuda"))
             * ks).bfloat16()
        v = torch.randn(B, H, M, D, generator=g, device="cuda").bfloat16()
        nkv = torch.randn(2, H, 1, D, generator=g, device="cuda")
        bias = (torch.rand(N, M, generator=g, device="cuda") * 2
                if with_bias else None)
        kp = None if keep is None else torch.tensor(keep, device="cuda")
        got = ca.cosine_attention(q, k, v, nkv, qs, ks, bias, kp)
        want = ca.cosine_attention_reference(q.float(), k.float(), v.float(),
                                             nkv, qs, ks, bias, kp)
        err = (got.float() - want).abs()
        # bf16 rounding of q^, the softmax weights and the output
        assert err.max().item() <= 2e-2 and err.mean().item() <= 2e-3
