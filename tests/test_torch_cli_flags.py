"""The port's CLIs take the flags that the reference's take: `platform=`
(cpu, gpu) and `devices=1` in every CLI (`scripts/cli.py:pop_device`, the
counterpart of `bevgen_tpu/scripts/cli.py:setup_platform`), and in the
generate CLI `print_config` (the composed config as plain text, with the
extra keys of `bevgen_tpu/scripts/generate.py`) and the mesh axes `dp`,
`tp`, `dcn` at 1. Above one device, an unknown platform, or a platform that
disagrees with `device=`, they exit.
"""
import dataclasses
import json

import pytest
import torch

from bevgen_torch.core import config as tcfg
from bevgen_torch.scripts import cli
from bevgen_torch.scripts import generate
from bevgen_torch.scripts import tokenize_data, train_stage1, train_stage2

GEN = ["preset=tiny_test", "fake=1", "batch_size=1",
       "muse.sample_iterations=2"]
EXTRA = ("eval_generate", "ckpt_path", "pipeline", "quant", "split", "fake")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _leaves(cfg):
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            yield from _leaves(v)
        else:
            yield f.name, v


@pytest.mark.parametrize("flags", [
    ["print_config=false"], ["print_config=true"], ["dp=1", "tp=1", "dcn=1"],
    ["platform=cpu"], ["platform=cpu", "devices=1", "device=cpu"],
    ["platform=cpu", "print_config=false", "dp=1"]],
    ids=lambda f: " ".join(f))
def test_generate_takes_the_reference_flags(flags, tmp_path, capsys):
    if "platform=cpu" not in flags:
        flags = flags + ["device=cpu"]
    assert generate.main(GEN + flags + [f"out={tmp_path}"]) == 0
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1])["images"] == 3
    assert (tmp_path / "batch_0000.npz").exists()
    printed = out.startswith("config\n")
    assert printed == ("print_config=false" not in flags)
    if printed:
        # every authored field of the config, then the reference's extras
        text = out.split("\n[generate]")[0]
        want = dataclasses.replace(tcfg.tiny_test_config(), batch_size=1)
        want = dataclasses.replace(want, muse=dataclasses.replace(
            want.muse, sample_iterations=2))
        for name, value in _leaves(want):
            assert f"{name}: {value!r}" in text, name
        assert [ln.split(":")[0].strip() for ln in text.splitlines()[-6:]] \
            == list(EXTRA)


@pytest.mark.parametrize("flags,message", [
    (["dp=2"], "dp=2: the port runs on one device"),
    (["tp=4"], "tp=4: the port runs on one device"),
    (["dcn=auto"], "dcn=auto: the port runs on one device"),
    (["platform=tpu"], "device=cpu"),
    (["devices=2"], "devices=2: the port runs on one device"),
    (["platform=cpu", "device=cuda"], "disagree"),
], ids=lambda f: " ".join(f) if isinstance(f, list) else None)
def test_generate_exits_on_more_than_one_device(flags, message, tmp_path):
    with pytest.raises(SystemExit, match=message):
        generate.main(GEN + flags + [f"out={tmp_path}"])
    assert not any(tmp_path.iterdir())


def test_pop_device():
    for args, want in (({}, "cuda"), ({"platform": "gpu"}, "cuda"),
                       ({"platform": "cuda", "device": "cuda:0"}, "cuda:0"),
                       ({"platform": "cpu", "devices": "1"}, "cpu"),
                       ({"device": "cpu"}, "cpu")):
        rest = dict(args, other="x")
        assert cli.pop_device(rest) == want
        assert rest == {"other": "x"}
    assert cli.pop_device({}, default="cpu") == "cpu"
    with pytest.raises(SystemExit, match="pass a device count"):
        cli.pop_device({"devices": "two"})


def test_the_other_clis_take_platform_cpu(tmp_path, capsys):
    tokenize_data.main(["preset=tiny_test", "platform=cpu", "fake=1",
                        "batch_size=2", f"out_dir={tmp_path / 't'}"])
    assert (tmp_path / "t" / "shard_00000.npz").exists()
    state = train_stage1.run(["preset=tiny_test", "platform=cpu", "steps=1",
                              "batch_size=2", "disc=false", "devices=1"])
    assert state.step == 1
    assert train_stage2.main(["preset=tiny_test", "platform=cpu", "steps=1",
                              "batch_size=2", "dp=1", "tp=1"]) == 0
    assert capsys.readouterr().out.strip().endswith("done")
    for main in (tokenize_data.main, train_stage1.main, train_stage2.main):
        with pytest.raises(SystemExit, match="platform='tpu'"):
            main(["preset=tiny_test", "platform=tpu",
                  f"out_dir={tmp_path / 'x'}"])
