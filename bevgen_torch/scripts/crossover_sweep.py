"""Measure the int8 crossover table on the card.

    python -m bevgen_torch.scripts.crossover_sweep
    python -m bevgen_torch.scripts.crossover_sweep batches=2,4 reps=3 \\
        out=/tmp/int8_crossover.json

Images per second of the `argoverse_muse_7cam` generate (18 MaskGit steps
with the self-critic, full width, seeded random weights, fake batches) in
bf16 and in int8 W8A8 (`BEVGenPipeline.quantized()`), at each batch of
`batches` (default 1,2,3,4,8,16): per batch one warm-up generate of each
mode, then `reps` (default 3) timed generates of each, in turns, with the
host clock around a synchronised generate; the median. Writes the table
that `BEVGenPipeline.quantized(batch_hint=)` reads, by default
`bevgen_torch/configs/int8_crossover.json`: {"comment", "chip" (the card's
name and power limit, as nvidia-smi gives them), "source", "measurements":
{batch: {"bf16": images/s, "int8": images/s}}}. Runs on the card (`device`,
default cuda; it raises without one).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from typing import List, Optional

from bevgen_torch.scripts import cli

DEFAULT_BATCHES = "1,2,3,4,8,16"


def card_name_and_power() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv: Optional[List[str]] = None) -> int:
    import torch
    from bevgen_torch.core.config import argoverse_muse_7cam_config
    from bevgen_torch.core.device import resolve_device
    from bevgen_torch.data.fake import fake_batch
    from bevgen_torch.pipelines.generate import BEVGenPipeline, CROSSOVER_TABLE

    args = cli.parse_argv(sys.argv[1:] if argv is None else argv)
    batches = [int(b) for b in args.pop("batches", DEFAULT_BATCHES).split(",")
               if b]
    reps = int(args.pop("reps", 3))
    seed = int(args.pop("seed", 0))
    out = args.pop("out", str(CROSSOVER_TABLE))
    device = args.pop("device", "cuda")
    if args:
        raise SystemExit(f"unknown argument(s): {sorted(args)}")
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise SystemExit("crossover_sweep measures the card: device=cuda")
    card = card_name_and_power()

    cfg = argoverse_muse_7cam_config()
    pipes = {"bf16": BEVGenPipeline.create(cfg, device=dev).init_params(seed)}
    pipes["int8"] = pipes["bf16"].quantized(batch_hint=None)

    def run(pipe, inputs, s):
        t0 = time.perf_counter()
        pipe.generate_fn(*inputs, torch.Generator(dev).manual_seed(s))
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    meas = {}
    for b in batches:
        batch = fake_batch(cfg, b, seed=seed)
        inputs = (batch["segmentation"], batch["intrinsics_inv"],
                  batch["extrinsics_inv"])
        times = {mode: [] for mode in pipes}
        for mode, pipe in pipes.items():
            run(pipe, inputs, seed)                     # warm-up
        for r in range(reps):
            for mode, pipe in pipes.items():
                times[mode].append(run(pipe, inputs, seed + 1 + r))
        n_img = b * cfg.transformer.num_cams
        row = {}
        for mode, ts in times.items():
            med = sorted(ts)[len(ts) // 2]
            row[mode] = round(n_img / med, 4)
            print(f"[sweep] b={b} {mode}: {', '.join(f'{t:.4f}' for t in ts)} "
                  f"s, median {med:.4f} s = {row[mode]} images/s", flush=True)
        meas[str(b)] = row
    table = {
        "comment": "Measured batch -> images/s of the argoverse_muse_7cam "
                   "generate (18-step self-critic decode, full width, seeded "
                   "random weights) in bf16 and int8 W8A8 on the card named "
                   "in `chip`. Read by BEVGenPipeline.quantized(batch_hint=) "
                   "to keep bf16 where it serves a batch faster; written by "
                   "bevgen_torch/scripts/crossover_sweep.py.",
        "chip": card,
        "source": f"bevgen_torch/scripts/crossover_sweep.py: median of {reps} "
                  f"timed generates per mode after one warm-up, modes in "
                  f"turns; torch {torch.__version__}, CUDA "
                  f"{torch.version.cuda}",
        "measurements": meas,
    }
    with open(out, "w") as f:
        json.dump(table, f, indent=2)
        f.write("\n")
    print(json.dumps(table))
    return 0


if __name__ == "__main__":
    sys.exit(main())
