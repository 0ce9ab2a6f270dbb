"""`models/init.py:reuse_draws`: inside it `init_weights` copies the values
it drew for an earlier module with the same parameters up to that point
instead of drawing them again, and the weights are bit for bit those of a
fresh draw: on a repeated build, on a deeper build that shares a prefix,
on int8 modules, and when the byte limit keeps nothing. Exact comparisons;
`tiny_test` pipelines on the CPU."""
import dataclasses

import pytest
import torch

from bevgen_torch.core import config as tcfg
from bevgen_torch.models import init
from bevgen_torch.pipelines.generate import BEVGenPipeline


@pytest.fixture(autouse=True)
def two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _cfg(layers=2, **tf):
    cfg = tcfg.tiny_test_config()
    return dataclasses.replace(cfg, transformer=cfg.transformer.replace(
        num_layers=layers, **tf))


def _weights(cfg, seed):
    pipe = BEVGenPipeline.create(cfg, device="cpu").init_params(seed=seed)
    return {k: v.clone() for k, v in pipe.state_dict().items()}


def _assert_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _count_draws(monkeypatch):
    calls = []
    real = torch.nn.init.trunc_normal_
    monkeypatch.setattr(torch.nn.init, "trunc_normal_",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    return calls


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_repeated_build_copies_the_same_weights(monkeypatch, quant):
    cfg = _cfg(quant=quant)
    fresh = _weights(cfg, 3)
    calls = _count_draws(monkeypatch)
    with init.reuse_draws(1 << 30):
        first = _weights(cfg, 3)
        n_first = len(calls)
        second = _weights(cfg, 3)
        other_seed = _weights(cfg, 4)
    assert n_first > 0 and len(calls) == 2 * n_first   # seed 4 drew anew
    _assert_equal(first, fresh)
    _assert_equal(second, fresh)
    assert any(not torch.equal(other_seed[k], fresh[k]) for k in fresh)


def test_deeper_build_reuses_the_shared_prefix():
    shallow, deep = _cfg(layers=1), _cfg(layers=3)
    want_shallow, want_deep = _weights(shallow, 0), _weights(deep, 0)
    with init.reuse_draws(1 << 30):
        got_shallow = _weights(shallow, 0)
        got_deep = _weights(deep, 0)
        again_shallow = _weights(shallow, 0)
    _assert_equal(got_shallow, want_shallow)
    _assert_equal(got_deep, want_deep)
    _assert_equal(again_shallow, want_shallow)


def test_zero_byte_limit_keeps_nothing(monkeypatch):
    cfg = _cfg()
    want = _weights(cfg, 1)
    calls = _count_draws(monkeypatch)
    with init.reuse_draws(0):
        a = _weights(cfg, 1)
        n = len(calls)
        b = _weights(cfg, 1)
    assert len(calls) == 2 * n
    _assert_equal(a, want)
    _assert_equal(b, want)
    assert init._reuse is None
