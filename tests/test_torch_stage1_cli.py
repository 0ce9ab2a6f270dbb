"""The port's stage-1 training CLI (`scripts/train_stage1.py`) on the CPU:
`model=cam` with the discriminator (and an LPIPS term) and without it,
`model=bev`, each with a checkpoint directory whose tag reloads into a fresh
model bit for bit; a missing `perceptual_weights` file trains without the
term; an unknown argument exits; the real-data path on the synthetic AV2
tree, and a set ARGOVERSE_DATA_DIR without a tree raises; the CLI defaults
to cuda and raises without a card before it writes anything; and the CLI
and its modules import no JAX, no JAX package and none of cv2, pandas or
PIL.
"""
import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bevgen_torch.core.config import tiny_test_config
from chip_smoke import write_lpips_npz
from bevgen_torch.models.stage1.vq import VQModel, VQSegmentationModel
from bevgen_torch.scripts import train_stage1

ROOT = Path(__file__).resolve().parent.parent
TINY = ["preset=tiny_test", "device=cpu", "batch_size=2", "log_every=1"]


def run_cli(argv, capsys):
    state = train_stage1.run(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    return state, lines, [json.loads(l) for l in lines if l.startswith("{")]


def assert_tag_reloads(ckpt_dir: Path, state, cls, s1cfg):
    tag = ckpt_dir / (ckpt_dir / "LATEST").read_text().strip()
    assert tag.name == f"step_{state.step:08d}"
    saved = torch.load(tag / "state.pt", map_location="cpu", weights_only=False)
    assert saved["step"] == state.step
    fresh = cls(s1cfg)
    fresh.load_state_dict(saved["params"])
    trained = dict(state.model.named_parameters())
    for name, p in fresh.named_parameters():
        assert torch.equal(p, trained[name].detach()), name


@pytest.mark.parametrize("which,extra", [
    ("cam", ["disc=true", "lpips"]), ("cam", ["disc=false"]), ("bev", [])])
def test_train_stage1_cli(tmp_path, capsys, which, extra):
    if "lpips" in extra:
        extra = ["disc=true",
                 f"perceptual_weights={write_lpips_npz(str(tmp_path / 'l.npz'))}"]
    ckpt = tmp_path / "ck"
    state, lines, logs = run_cli(TINY + [f"model={which}", "steps=2",
                                         f"ckpt_dir={ckpt}", *extra], capsys)
    assert lines[-1] == "done" and [m["step"] for m in logs] == [1, 2]
    keys = {"cam": "train/nll_loss" if "disc=true" in extra
            else "train/rec_loss", "bev": "train/bce_loss"}[which]
    for m in logs:
        assert keys in m and m["steps_per_sec"] > 0
        assert all(np.isfinite(v) for v in m.values())
    if "disc=true" in extra:
        assert state.disc is not None and logs[-1]["train/d_weight"] >= 0
    cfg = tiny_test_config()
    assert_tag_reloads(ckpt, state, VQModel if which == "cam" else
                       VQSegmentationModel,
                       cfg.first_stage if which == "cam" else cfg.cond_stage)


def test_missing_perceptual_weights_train_without_the_term(tmp_path, capsys):
    missing = tmp_path / "none.npz"
    _, lines, logs = run_cli(TINY + ["steps=1", f"perceptual_weights={missing}"],
                             capsys)
    assert f"LPIPS weights not found at {missing}" in "\n".join(lines)
    assert lines[-1] == "done" and np.isfinite(logs[0]["train/nll_loss"])


@pytest.mark.parametrize("bad,message", [("bogus=1", "bogus"),
                                         ("model=rgb", "rgb")])
def test_unknown_arguments_exit(bad, message):
    with pytest.raises(SystemExit, match=message):
        train_stage1.main(TINY + ["steps=1", bad])


def test_train_stage1_on_the_av2_tree(tmp_path, monkeypatch, capsys):
    from test_torch_data import write_av2_tree
    tree = write_av2_tree(tmp_path / "av2")
    monkeypatch.setenv("ARGOVERSE_DATA_DIR", str(tree))
    for which, extra in (("cam", ["disc=false"]),
                         ("bev", ["cond_stage.ch=8",
                                  "cond_stage.ch_mult=(1,1,1,1,1)",
                                  "cond_stage.resolution=256"])):
        state, lines, logs = run_cli(TINY + [f"model={which}", "steps=3",
                                             *extra], capsys)
        mode = "per-frame" if which == "cam" else "multi-camera"
        assert any(l.startswith("training on ArgoverseDataset") and mode in l
                   for l in lines), lines
        assert lines[-1] == "done" and state.step == 3 and len(logs) == 3
    monkeypatch.setenv("ARGOVERSE_DATA_DIR", str(tmp_path / "missing"))
    with pytest.raises(FileNotFoundError, match="ARGOVERSE_DATA_DIR"):
        train_stage1.main(TINY + ["steps=1"])


def test_train_stage1_defaults_to_cuda_and_raises_without_it(monkeypatch,
                                                            tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_stage1.main(["preset=tiny_test", "steps=1",
                           f"ckpt_dir={tmp_path / 'ck'}",
                           f"run_dir={tmp_path / 'run'}"])
    assert not any(tmp_path.iterdir())


STAGE1_MODULES = ("bevgen_torch.scripts.train_stage1",
                  "bevgen_torch.training.stage1_trainer",
                  "bevgen_torch.training.losses",
                  "bevgen_torch.models.discriminator",
                  "bevgen_torch.models.lpips",
                  "bevgen_torch.metrics.quality")


def test_stage1_cli_imports_no_jax_or_host_data_packages(tmp_path):
    """In a fresh interpreter: the stage-1 modules, then a fake-data CLI run
    with the discriminator and LPIPS, leave none of jax, bevgen_tpu, cv2,
    pandas or PIL in sys.modules (nor do the sources name jax or
    bevgen_tpu)."""
    for mod in STAGE1_MODULES:
        src = ROOT / (mod.replace(".", "/") + ".py")
        roots = {a.name.split(".")[0] for n in ast.walk(ast.parse(
            src.read_text())) if isinstance(n, ast.Import) for a in n.names}
        roots |= {n.module.split(".")[0] for n in ast.walk(ast.parse(
            src.read_text())) if isinstance(n, ast.ImportFrom) and n.module}
        assert not roots & {"jax", "flax", "optax", "bevgen_tpu"}, mod
    npz = write_lpips_npz(str(tmp_path / "l.npz"))
    code = f"""
import importlib, json, sys
sys.path.insert(0, {str(ROOT)!r})
for m in {STAGE1_MODULES!r}:
    importlib.import_module(m)
from bevgen_torch.scripts import train_stage1
train_stage1.main(["preset=tiny_test", "device=cpu", "steps=1",
                   "batch_size=2", "perceptual_weights={npz}",
                   "ckpt_dir={tmp_path / 'ck'}"])
print(json.dumps(sorted(m for m in ("jax", "bevgen_tpu", "cv2", "pandas",
                                    "PIL") if m in sys.modules)))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
