"""The weights drill of the PyTorch port (`scripts/weights_drill.py`) on the
CPU, and its files against the JAX package: every chain passes; on the
drill's own synthetic files the port's LPIPS, Inception and LoFTR
converters write the JAX converters' arrays; the published checkpoints it
writes load through the JAX package's `load_weights` to the tree that the
port's source pipeline exports; the tokenizer encodes and decodes as the JAX
`SimpleTokenizer` on the drill's miniature merges file.
"""
import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from bevgen_torch.core.convert import export_jax_params
from bevgen_torch.scripts import weights_drill


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


@pytest.fixture(scope="module")
def drilled(tmp_path_factory, _two_threads):
    """(exit code, printed lines, work directory) of one drill run."""
    tmp = tmp_path_factory.mktemp("drill")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = weights_drill.main(["--tmp", str(tmp), "--device", "cpu"])
    return rc, out.getvalue().splitlines(), tmp


def test_drill_passes_every_chain(drilled):
    rc, lines, _ = drilled
    assert rc == 0, lines
    passed = [ln for ln in lines if ln.startswith("[drill] ") and ": PASS" in ln]
    assert len(passed) == len(weights_drill.DRILLS) == 5, lines
    assert all("(forwards on cpu)" in ln for ln in passed)
    assert sum("real artifact:" in ln for ln in lines) == 7
    assert lines[-1] == "[drill] all 5 converter chains green on cpu"


def test_drill_needs_a_card_unless_told_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        weights_drill.main(["--tmp", str(tmp_path)])
    assert not any(tmp_path.iterdir())


def _jax_convert(kind, d, out):
    if kind == "lpips":
        from bevgen_tpu.models.lpips import convert_lpips_weights
        convert_lpips_weights(str(d / "vgg16.pth"), str(d / "vgg.pth"), out)
    elif kind == "inception":
        from bevgen_tpu.metrics.inception import convert_inception_weights
        convert_inception_weights(str(d / "pt_inception.pth"), out)
    else:
        from bevgen_tpu.metrics.loftr import convert_loftr_weights
        convert_loftr_weights(str(d / "loftr_outdoor.ckpt"), out,
                              self_check=False)


@pytest.mark.parametrize("kind", ["lpips", "inception", "loftr"])
def test_port_converters_write_the_jax_arrays(kind, drilled, tmp_path):
    _, _, d = drilled
    want_npz = str(tmp_path / f"{kind}_jax.npz")
    _jax_convert(kind, d, want_npz)
    got, want = np.load(d / f"{kind}.npz"), np.load(want_npz)
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("label,part", [
    ("argoverse_rgb.ckpt", "first_stage"), ("argoverse_bev.ckpt", "cond_stage"),
    ("argoverse_stage_two.ckpt", None)])
def test_published_checkpoints_load_through_jax_load_weights(label, part,
                                                             drilled, capsys):
    """The JAX package's `load_weights` on the drill's file gives the tree
    the port's source pipeline exports: the stage-1 files grafted into the
    example's `first_stage`, the stage-2 file whole."""
    from bevgen_tpu.training.checkpoints import load_weights
    _, _, d = drilled
    src = weights_drill.tiny_pipeline(weights_drill.SOURCE_SEED,
                                      torch.device("cpu"))
    want = export_jax_params(src)
    got = load_weights(str(d / label), want)
    if part is not None:
        got, want = got["first_stage"], want[part]
    g = dict(jax.tree_util.tree_leaves_with_path(got))
    w = dict(jax.tree_util.tree_leaves_with_path(want))
    assert g.keys() == w.keys()
    for path, arr in w.items():
        np.testing.assert_array_equal(np.asarray(g[path]), arr,
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("text", [
    "hello the world", "Hello,   THE world!!", "the 2024 hell_o &amp; he'll",
    "café über naïve 日本"])
def test_tokenizer_matches_jax(text, drilled):
    from bevgen_tpu.utils.tokenizer import SimpleTokenizer as JaxTokenizer
    from bevgen_torch.utils.tokenizer import SimpleTokenizer
    _, _, d = drilled
    path = str(d / "bpe_simple_vocab_16e6.txt.gz")
    port, ref = SimpleTokenizer(path), JaxTokenizer(path)
    ids = port.encode(text)
    assert ids == ref.encode(text)
    assert port.decode(ids) == ref.decode(ids)
    assert port.encoder == ref.encoder and port.bpe_ranks == ref.bpe_ranks
