"""Command-line plumbing shared by the port's scripts.

The counterpart of `bevgen_tpu/scripts/cli.py:28-140`: positional
`key=value` tokens; `preset=<name>` picks a config of `core/config.py`, or
`config=<file.yaml>` loads one (`bevgen_torch/configs/*.yaml`: an optional
`preset` base plus nested field overrides); `modes=[a,b]` layers the
reference's mode mixins in order; dotted keys override any field
(`transformer.num_layers=2`). yaml is imported only when `config=` is
given. `pop_device` takes the reference's `platform=`/`devices=` flags
beside the port's `device=`; `pop_mesh` the mesh axes `dp`, `tp`, `dcn`
(data and tensor parallelism over the processes that torchrun starts).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Tuple

from bevgen_torch.core.config import PRESETS, PipelineConfig, apply_overrides
from bevgen_torch.parallel import distributed


def parse_argv(argv: List[str]) -> Dict[str, str]:
    args = {}
    for a in argv:
        if "=" not in a:
            raise SystemExit(f"expected key=value, got {a!r}")
        k, v = a.split("=", 1)
        args[k.lstrip("-")] = v
    return args


def pop_flag(args: Dict[str, str], key: str, default: str = "false") -> bool:
    """Pop a true/false argument."""
    return args.pop(key, default).lower() in ("1", "true", "yes")


PLATFORM_DEVICES = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


def pop_device(args: Dict[str, str], default: str = "cuda") -> str:
    """Pop `device` and the reference's platform flags (`cli.setup_platform`
    there): `platform=cpu` means device=cpu, `platform=gpu` (or cuda)
    device=cuda; `devices=1` is accepted. Exits on another platform, on a
    platform and a device that disagree, and on `devices` above 1 (one
    process drives one device: start one per device with torchrun). Returns
    the device string; under torchrun a bare `cuda` is the rank's own card,
    `cuda:<LOCAL_RANK % device count>`."""
    platform = args.pop("platform", None)
    device = args.pop("device", None)
    devices = args.pop("devices", "1")
    if not devices.isdigit() or int(devices) < 1:
        raise SystemExit(f"devices={devices!r}: pass a device count")
    if int(devices) > 1:
        raise SystemExit(f"devices={devices}: the port runs on one device per "
                         "process; start one process per device with torchrun "
                         "--nproc_per_node=N and pass dp=N")
    if platform is None:
        return _rank_device(device or default)
    if platform not in PLATFORM_DEVICES:
        raise SystemExit(f"platform={platform!r}: the port runs on cpu or "
                         "gpu (cuda); pick its device with device=cpu|cuda")
    if device is not None and device.split(":")[0] != PLATFORM_DEVICES[platform]:
        raise SystemExit(f"platform={platform} and device={device} disagree; "
                         "pass one of them")
    return _rank_device(device or PLATFORM_DEVICES[platform])


def _rank_device(device: str) -> str:
    """A bare `cuda` under torchrun (LOCAL_RANK set): the rank's card."""
    if device != "cuda" or "LOCAL_RANK" not in os.environ:
        return device
    import torch
    return f"cuda:{distributed.local_rank() % max(torch.cuda.device_count(), 1)}"


def _count(name: str, val: str, auto: bool = False) -> str:
    if not (val.isdigit() and int(val) >= 1) and not (auto and val == "auto"):
        raise SystemExit(f"{name}={val!r}: pass a positive count"
                         + (" or auto" if auto else ""))
    return val


def pop_mesh(args: Dict[str, str], device: str, transformer=None):
    """Pop the mesh axes `dp`, `tp` and `dcn` (N or auto) over the
    processes that torchrun started (`WORLD_SIZE`): dcn x dp x tp must be
    their number, and dp defaults to it / (dcn x tp); `dcn=auto` makes each
    node's ranks one dcn row. Returns None in one process (every axis 1),
    else joins the process group (nccl on cuda, gloo on cpu) and returns the
    `parallel.sharding.Mesh`. Exits on a `tp` that does not divide the
    heads of `transformer` (the stage-2 config), on axes that do not
    multiply to the process count, on more than one rank in one process,
    and on `dcn=auto` without ranks. Every form runs under tp: the fused
    glue (serving and training) and int8 serving (quantized whole, then
    cut) as well."""
    from bevgen_torch.parallel import sharding
    dp = args.pop("dp", None)
    dp = None if dp is None else int(_count("dp", dp))
    tp = int(_count("tp", args.pop("tp", "1")))
    dcn = _count("dcn", args.pop("dcn", "1"), auto=True)
    world = distributed.world_size_from_env()
    if tp > 1 and transformer is not None and transformer.num_heads % tp:
        raise SystemExit(f"tp={tp}: num_heads={transformer.num_heads} is "
                         f"not divisible by tp")
    if dcn == "auto" and world == 1:
        raise SystemExit("dcn=auto groups the ranks by node, and this run has "
                         "no ranks: start them with torchrun --nnodes=M "
                         "--nproc_per_node=N")
    if dcn != "auto":
        ranks = int(dcn) * (dp or max(world // (int(dcn) * tp), 1)) * tp
        tp_axis, tp_x = (f" tp={tp}", " x tp") if tp > 1 else ("", "")
        if world == 1 and ranks > 1:
            kind = "data-parallel ranks" if tp == 1 else "ranks"
            raise SystemExit(
                f"dp={dp or 1} dcn={dcn}{tp_axis}: {ranks} {kind} in one "
                f"process; start one process per rank with torchrun "
                f"--nproc_per_node={ranks}")
        if ranks != world:
            raise SystemExit(f"dp={dp} dcn={dcn}{tp_axis}: dcn x dp{tp_x} must "
                             f"equal the {world} processes started")
    if world == 1:
        return None
    joined = distributed.initialize(device=device)
    try:
        mesh = (sharding.make_multislice_mesh(tp=tp, device=device)
                if dcn == "auto"
                else sharding.make_mesh(dp=dp, tp=tp, dcn=int(dcn),
                                        device=device))
    except ValueError as e:
        raise SystemExit(str(e))
    mesh.owns_group = joined
    return mesh


def config_text(cfg, extra: Dict[str, object] = None) -> str:
    """The composed config as indented plain text, one authored field a line
    (derived properties omitted), then the `extra` keys: what the
    reference's `cli.print_config_tree` renders with rich."""
    lines = ["config"]

    def add(name, value, depth):
        pad = "  " * depth
        if dataclasses.is_dataclass(value):
            lines.append(f"{pad}{name}")
            for f in dataclasses.fields(value):
                add(f.name, getattr(value, f.name), depth + 1)
        else:
            lines.append(f"{pad}{name}: {value!r}")

    for f in dataclasses.fields(cfg):
        add(f.name, getattr(cfg, f.name), 1)
    for k, v in (extra or {}).items():
        lines.append(f"  {k}: {v!r}")
    return "\n".join(lines)


def pop_pipeline_kind(args: Dict[str, str]) -> bool:
    """Pop `pipeline` (muse|ar); True for ar. Exits on an unknown value."""
    pipeline = args.pop("pipeline", "muse")
    if pipeline not in ("muse", "ar"):
        raise SystemExit(f"unknown pipeline={pipeline!r} (muse|ar)")
    return pipeline == "ar"


def pop_quant(args: Dict[str, str]) -> str:
    """Pop `quant` (none|int8|auto). Exits on an unknown value with the
    reference's message."""
    quant = args.pop("quant", "none")
    if quant not in ("none", "int8", "auto"):
        raise SystemExit(f"unknown quant={quant!r} (none|int8|auto)")
    return quant


def apply_quant(pipe, quant: str, batch_size: int):
    """The pipeline that serves under `quant`: `pipe` itself for none; its
    `quantized()` form for int8 (whatever the batch: the user may want the
    halved weight memory), and for auto with `batch_size` as the hint (the
    MUSE pipeline then keeps bf16 where the card's crossover table says bf16
    serves that batch faster). Applied after any checkpoint is loaded."""
    if quant == "none":
        return pipe
    return pipe.quantized(batch_hint=batch_size if quant == "auto" else None)


def default_preset(ar: bool) -> str:
    return "nuscenes_ar" if ar else "argoverse_muse_7cam"


def check_cameras(dataset_cameras, tf) -> None:
    """Exit naming both counts when a dataset serves another number of
    cameras than the config's `num_cams` (`tf`: its transformer config)."""
    if len(dataset_cameras) != tf.num_cams:
        raise SystemExit(
            f"the dataset serves {len(dataset_cameras)} cameras "
            f"{list(dataset_cameras)}, the config has num_cams={tf.num_cams} "
            f"({tf.cam_names}): pick a preset with "
            f"{len(dataset_cameras)} cameras")


def load_yaml_config(path: str) -> PipelineConfig:
    """A YAML pipeline config: an optional `preset` base (argoverse_muse by
    default) plus nested field overrides; lists become tuples."""
    import yaml
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    preset = data.pop("preset", "argoverse_muse")
    if preset not in PRESETS:
        raise SystemExit(f"{path}: unknown preset {preset!r}; one of "
                         f"{sorted(PRESETS)}")

    def flatten(d, prefix=""):
        out = {}
        for k, v in d.items():
            key = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                out.update(flatten(v, key))
            else:
                out[key] = tuple(v) if isinstance(v, list) else v
        return out

    return _overridden(PRESETS[preset](), flatten(data))


# The reference's list-composable config groups (`modes=[argoverse,generate]`,
# its configs/modes/*.yaml): each mode is a delta applied in list order
# before the explicit key=value overrides, and may give script arguments a
# default where the caller passed none.

def _mode_argoverse(cfg: PipelineConfig):
    """configs/modes/argoverse.yaml: 3 square front ring cameras."""
    tf = cfg.transformer.replace(
        num_cams=3, cam_names="ARGOVERSE_FRONT_CAMERAS",
        dataset="argoverse", cam_res=(256, 256), cam_latent_res=(16, 16))
    return dataclasses.replace(cfg, transformer=tf), {}


def _mode_generate(cfg: PipelineConfig):
    """configs/modes/generate.yaml: the inference task on the test split."""
    return cfg, {"datamodule.split": "test"}


MODES = {"argoverse": _mode_argoverse, "generate": _mode_generate}


def apply_modes(cfg: PipelineConfig, modes_value: str,
                args: Dict[str, str]) -> PipelineConfig:
    """Apply `modes=[a,b]` (or `modes=a,b`) in order; the script-argument
    defaults a mode gives fill only keys the caller did not pass."""
    names = [m.strip() for m in modes_value.strip("[]").split(",")
             if m.strip()]
    for name in names:
        if name not in MODES:
            raise SystemExit(f"unknown mode {name!r}; one of {sorted(MODES)}")
        cfg, injected = MODES[name](cfg)
        for k, v in injected.items():
            args.setdefault(k, v)
    return cfg


def _overridden(cfg: PipelineConfig, overrides: Dict[str, object]
                ) -> PipelineConfig:
    try:
        return apply_overrides(cfg, overrides)
    except (AttributeError, TypeError, ValueError) as e:
        raise SystemExit(f"bad config override {sorted(overrides)}: {e}")


def build_config(args: Dict[str, str], preset_default: str
                 ) -> Tuple[PipelineConfig, Dict[str, str]]:
    """Pop the config keys from `args`: `config=<file.yaml>` or `preset=`
    (default `preset_default`), `modes=`, and every key whose head is a
    field of the config. Returns (config, the other keys, for the script
    to pop). Exits on an unknown preset, mode or field."""
    args = dict(args)
    yaml_path = args.pop("config", None)
    modes_value = args.pop("modes", None)
    if yaml_path:
        if "preset" in args:
            raise SystemExit("pass either config= or preset=, not both")
        cfg = load_yaml_config(yaml_path)
    else:
        preset = args.pop("preset", preset_default)
        if preset not in PRESETS:
            raise SystemExit(f"unknown preset {preset!r}; one of "
                             f"{sorted(PRESETS)}")
        cfg = PRESETS[preset]()
    if modes_value:
        cfg = apply_modes(cfg, modes_value, args)
    fields = {f.name for f in dataclasses.fields(cfg)}
    overrides = {k: v for k, v in args.items() if k.split(".", 1)[0] in fields}
    rest = {k: v for k, v in args.items() if k not in overrides}
    return _overridden(cfg, overrides), rest
