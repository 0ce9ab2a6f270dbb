"""LPIPS and the paired image metrics of the PyTorch port against the JAX
package on the CPU: LPIPS at full VGG16 widths on 32x32 inputs from one
random npz that both packages load (rtol 1e-5), `LPIPSMetric` with and
without its weights file, `convert_lpips_weights` on synthetic torchvision
and reference files (the same npz), and `psnr`/`ssim` (equal values).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevgen_tpu.metrics import quality as jquality
from bevgen_tpu.models import lpips as jlpips
from bevgen_torch.core.convert import load_jax_params
from bevgen_torch.metrics import quality as tquality
from bevgen_torch.models import lpips as tlpips
from torch_parity import random_tree

VGG_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
VGG_CHANNELS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)


@pytest.fixture(scope="module")
def lpips_npz(tmp_path_factory):
    """A random LPIPS weight file in the JAX package's npz layout."""
    x = jnp.zeros((1, 32, 32, 3))
    tree = random_tree(jax.eval_shape(jlpips.LPIPS().init,
                                      jax.random.PRNGKey(0), x, x), 5)
    flat = {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree["params"])}
    path = tmp_path_factory.mktemp("lpips") / "lpips.npz"
    np.savez(path, **flat)
    return str(path)


def _pair(seed, b=2):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32)
            for _ in range(2))


def test_lpips_matches_jax_at_full_vgg_widths(lpips_npz):
    x, y = _pair(0)
    params = jlpips.load_lpips_params(lpips_npz)
    want = np.asarray(jlpips.LPIPS().apply(params, jnp.asarray(x),
                                           jnp.asarray(y)))
    model = load_jax_params(tlpips.LPIPS(), tlpips.load_lpips_params(lpips_npz))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert got.shape == want.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_lpips_metric_needs_its_weights(lpips_npz, tmp_path):
    assert tlpips.load_lpips_params(str(tmp_path / "missing.npz")) is None
    for arg in (None, str(tmp_path / "missing.npz")):
        m = tquality.LPIPSMetric(arg)
        assert not m.available and not jquality.LPIPSMetric(arg).available
        with pytest.raises(RuntimeError, match="not available"):
            m(np.zeros((1, 32, 32, 3)), np.zeros((1, 32, 32, 3)))
    x, y = ((a + 1) / 2 for a in _pair(1))
    m = tquality.LPIPSMetric(lpips_npz, device="cpu")
    assert m.available
    assert not any(p.requires_grad for p in m.model.parameters())
    np.testing.assert_allclose(m(x, y), jquality.LPIPSMetric(lpips_npz)(x, y),
                               rtol=1e-5)


def test_convert_lpips_weights_writes_the_jax_packages_npz(tmp_path):
    rng = np.random.default_rng(2)
    vgg, cin = {}, 3
    for i, cout in zip(VGG_CONV_IDX, VGG_CHANNELS):
        vgg[f"features.{i}.weight"] = torch.from_numpy(
            rng.standard_normal((cout, cin, 3, 3)).astype(np.float32))
        vgg[f"features.{i}.bias"] = torch.from_numpy(
            rng.standard_normal(cout).astype(np.float32))
        cin = cout
    lins = {f"lin{i}.model.1.weight": torch.from_numpy(
        rng.uniform(size=(1, c, 1, 1)).astype(np.float32))
        for i, c in enumerate((64, 128, 256, 512, 512))}
    torch.save(vgg, tmp_path / "vgg16.pth")
    torch.save(lins, tmp_path / "vgg.pth")
    args = (str(tmp_path / "vgg16.pth"), str(tmp_path / "vgg.pth"))
    jlpips.convert_lpips_weights(*args, str(tmp_path / "jax.npz"))
    tlpips.convert_lpips_weights(*args, str(tmp_path / "port.npz"))
    with np.load(tmp_path / "jax.npz") as want, \
            np.load(tmp_path / "port.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        assert len(want.files) == 2 * 13 + 5
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the converted file fills every parameter of the port's LPIPS
    load_jax_params(tlpips.LPIPS(),
                    tlpips.load_lpips_params(str(tmp_path / "port.npz")))


@pytest.mark.parametrize("shape", [(24, 24, 3), (20, 30)])
def test_psnr_and_ssim_equal_the_jax_modules(shape):
    rng = np.random.default_rng(3)
    a = rng.uniform(size=shape)
    b = np.clip(a + 0.1 * rng.standard_normal(shape), 0, 1)
    assert tquality.psnr(a, b) == jquality.psnr(a, b)
    assert tquality.psnr(a, a) == jquality.psnr(a, a) == float("inf")
    assert tquality.ssim(a, b) == jquality.ssim(a, b)
    assert tquality.ssim(a, b, data_range=2.0) == jquality.ssim(
        a, b, data_range=2.0)
