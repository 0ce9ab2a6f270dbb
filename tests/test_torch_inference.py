"""The benchmark-and-trace CLI of the PyTorch port (`scripts/inference.py`,
`utils/profiling.py`) against the JAX package's, on the CPU.

`canonical_rig_inverses` and `get_view_matrix` equal the JAX functions; the
CLI's inputs are the JAX script's numbers (tokens, condition, rig inverses,
stage-1 images from `np.random.default_rng(0)`); each of the nine modes runs
at `tiny_test` and prints a last line with the keys of a JAX `mode=forward`
run; `profile=true` writes a Chrome trace; `benchmark` and
`device_memory_stats` give the JAX keys (zeros on the CPU); an unknown mode
or argument exits.
"""
import json

import numpy as np
import pytest
import torch

from bevgen_tpu.core import config as jcfg
from bevgen_tpu.models import geometry as jgeom
from bevgen_tpu.scripts import inference as jinf
from bevgen_tpu.utils import profiling as jprof
from bevgen_torch.core import config as tcfg
from bevgen_torch.models import geometry as tgeom
from bevgen_torch.scripts import inference as tinf
from bevgen_torch.utils import profiling as tprof

PRESETS = ("argoverse_muse", "nuscenes_ar", "tiny_test")
TINY = ["preset=tiny_test", "device=cpu", "reps=1", "batch_size=2"]


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


def last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def jax_forward_line():
    """The last line of one JAX `mode=forward` run at tiny_test."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jinf.main(["preset=tiny_test", "reps=1", "batch_size=2"])
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("preset", PRESETS)
def test_rig_inverses_and_view_matrix_equal_jax(preset):
    for b in (1, 3):
        got = tgeom.canonical_rig_inverses(tcfg.PRESETS[preset]().transformer, b)
        want = jgeom.canonical_rig_inverses(jcfg.PRESETS[preset]().transformer,
                                            b)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    for args in ((), (200, 100, 50.0, 25.0, 0.25)):
        got, want = tgeom.get_view_matrix(*args), jgeom.get_view_matrix(*args)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("preset", PRESETS)
def test_inputs_equal_the_jax_scripts(preset):
    """The JAX script's draws (`bevgen_tpu/scripts/inference.py`), in its
    order: tokens, cond, then the stage-1 images."""
    b = 2
    cfg = jcfg.PRESETS[preset]()
    tf = cfg.transformer
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, tf.vocab_size, (b, tf.num_cams, tf.num_cam_tokens))
    cond = rng.integers(0, tf.cond_vocab_size, (b, tf.num_cond_tokens))
    ii, ei = jgeom.canonical_rig_inverses(tf, b)
    H, W = cfg.first_stage.cam_res
    imgs = rng.normal(0, 1, (b, H, W, 3)).astype(np.float32)
    got = tinf.draw_inputs(tcfg.PRESETS[preset](), b, images=True)
    for key, want in (("tokens", tokens.astype(np.int32)),
                      ("cond", cond.astype(np.int32)), ("intrinsics_inv", ii),
                      ("extrinsics_inv", ei), ("images", imgs)):
        assert got[key].dtype == want.dtype, key
        np.testing.assert_array_equal(got[key], want, err_msg=key)
    assert "images" not in tinf.draw_inputs(tcfg.PRESETS[preset](), b)


@pytest.mark.parametrize("mode", tinf.MODES)
def test_mode_prints_the_jax_keys(mode, jax_forward_line, capsys):
    assert tinf.main(TINY + [f"mode={mode}"]) == 0
    line = last_json(capsys)
    assert list(line) == list(jax_forward_line)
    assert line["mode"] == mode and line["batch_size"] == 2
    assert line["best_ms"] > 0 and line["mean_ms"] >= line["best_ms"]
    assert (line["bytes_in_use_mb"], line["peak_bytes_in_use_mb"],
            line["bytes_limit_mb"]) == (0.0, 0.0, 0.0)


def test_profile_writes_a_trace(tmp_path, jax_forward_line, capsys):
    trace_dir = tmp_path / "trace"
    tinf.main(TINY + ["mode=decode", "profile=true", f"trace_dir={trace_dir}"])
    line = last_json(capsys)
    assert list(line) == list(jax_forward_line) + ["trace"]
    assert line["trace"] == str(trace_dir)
    events = json.loads((trace_dir / "trace.json").read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("aten::" in n for n in names), "no CPU op in the trace"


def test_benchmark_and_memory_stats_give_the_jax_keys():
    calls = []
    got = tprof.benchmark(lambda x: calls.append(x) or torch.ones(3) * x, 2.0,
                          reps=3, warmup=1, device="cpu")
    want = jprof.benchmark(lambda x: np.ones(3) * x, 2.0, reps=3, warmup=1)
    assert list(got) == list(want)
    assert calls == [2.0] * 4
    assert 0 < got["best_ms"] <= got["mean_ms"]
    mem = tprof.device_memory_stats("cpu")
    assert list(mem) == list(jprof.device_memory_stats())
    assert set(mem.values()) == {0.0}
    synced = []
    tprof.benchmark(lambda: 1, reps=2, warmup=0, sync=synced.append,
                    device="cpu")
    assert synced == [1, 1]


@pytest.mark.filterwarnings("ignore:Error detected in")
def test_enable_nan_checks_turns_on_anomaly_mode():
    assert not torch.is_anomaly_enabled()
    try:
        tprof.enable_nan_checks()
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        x = torch.zeros(2, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            (x / x).sum().backward()
    finally:
        torch.autograd.set_detect_anomaly(False)


def test_unknown_mode_and_argument_exit():
    with pytest.raises(SystemExit, match="^unknown mode bogus$"):
        tinf.main(TINY + ["mode=bogus"])
    with pytest.raises(SystemExit, match="^unknown mode bogus$"):
        jinf.main(["preset=tiny_test", "mode=bogus", "reps=1"])
    with pytest.raises(SystemExit, match="unknown argument"):
        tinf.main(TINY + ["mode=forward", "repz=2"])
    with pytest.raises(SystemExit, match="platform"):
        tinf.main(TINY + ["platform=tpu"])
