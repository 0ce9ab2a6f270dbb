"""Sample curation utilities: the port's counterpart of
`bevgen_tpu/scripts/curate.py`.

Reference equivalents:
  find_interesting_nuscenes_samples.py / find_different_*  ->
      `mode=interesting`: rank samples by BEV object density / diversity
      and emit a token list for targeted evaluation;
  filter_generated.py -> `mode=filter`: reorganize + filter generated
      outputs by per-sample quality (PSNR or LPIPS when weights exist).

  python -m bevgen_torch.scripts.curate mode=interesting bev_dir=... out=tokens.txt
  python -m bevgen_torch.scripts.curate mode=different bev_dir=... top=100
  python -m bevgen_torch.scripts.curate mode=filter dir=/data/out keep=0.5 \
      [lpips_weights=lpips.npz device=cpu]

A host-only script: `mode=filter` reads the JPEGs with cv2, which the
card's machine does not have, so it is held on the CPU only. LPIPS (with
`lpips_weights=`) runs on `device` (default cuda; it raises without one).
An unknown argument exits (the JAX script ignores it).
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path
from typing import List, Optional

import numpy as np

from bevgen_torch.scripts import cli


def interesting_scores(bev_dir: Path, max_samples=None):
    """Score BEV rasters by dynamic-object content (channels 0-3)."""
    from bevgen_torch.data.rasterize import load_bev_raster
    files = sorted(bev_dir.rglob("*.npz"))[:max_samples]
    scores = []
    for f in files:
        layers = load_bev_raster(f)
        dyn = layers[..., :4].sum()
        ped = layers[..., 2].sum()
        scores.append((f"{f.parent.name}_{f.stem}",
                       float(dyn + 5.0 * ped)))
    return sorted(scores, key=lambda kv: -kv[1])


def different_scores(bev_dir: Path, top: int, max_samples=None):
    """Greedy max-min diverse subset by BEV raster dissimilarity
    (find_different_nuscenes_samples.py equivalent)."""
    from bevgen_torch.data.rasterize import load_bev_raster
    files = sorted(bev_dir.rglob("*.npz"))[:max_samples]
    if not files:
        return []
    feats = []
    for f in files:
        layers = load_bev_raster(f)
        small = layers[::16, ::16].reshape(-1)   # 16x16 thumbnail features
        feats.append(small)
    feats = np.stack(feats)
    chosen = [0]
    dists = np.linalg.norm(feats - feats[0], axis=1)
    while len(chosen) < min(top, len(files)):
        nxt = int(np.argmax(dists))
        chosen.append(nxt)
        dists = np.minimum(dists, np.linalg.norm(feats - feats[nxt], axis=1))
    return [f"{files[i].parent.name}_{files[i].stem}" for i in chosen]


def filter_outputs(root: Path, keep_frac: float, lpips_npz=None,
                   device: str = "cuda"):
    """Drop the worst (1-keep)x samples by gen-vs-GT distance (LPIPS on
    `device` with `lpips_npz`, else PSNR)."""
    import cv2
    from bevgen_torch.metrics.quality import LPIPSMetric, psnr
    lp = LPIPSMetric(lpips_npz, device=device) if lpips_npz else None
    tokens = sorted(p.name for p in (root / "sample").iterdir()
                    if p.is_dir())
    scored = []
    for tok in tokens:
        gen_files = sorted((root / "sample" / tok).glob("*.jpg"))
        vals = []
        for f in gen_files:
            gt_f = root / "sample_gt" / tok / f.name
            if not gt_f.exists():
                continue
            g = cv2.imread(str(f)).astype(np.float32) / 255.0
            t = cv2.imread(str(gt_f)).astype(np.float32) / 255.0
            if lp is not None and lp.available:
                vals.append(float(lp(g[None, ..., ::-1],
                                     t[None, ..., ::-1])[0]))
            else:
                vals.append(-psnr(g, t))   # lower is better
        scored.append((tok, float(np.mean(vals)) if vals else np.inf))
    scored.sort(key=lambda kv: kv[1])
    keep = {tok for tok, _ in scored[:int(len(scored) * keep_frac)]}
    removed = 0
    for tok, _ in scored:
        if tok not in keep:
            for sub in ("sample", "sample_gt", "viz"):
                p = root / sub / tok
                if p.is_dir():
                    shutil.rmtree(p)
                elif p.with_suffix(".png").exists():
                    p.with_suffix(".png").unlink()
            removed += 1
    return len(keep), removed


def main(argv: Optional[List[str]] = None) -> int:
    args = cli.parse_argv(sys.argv[1:] if argv is None else argv)
    mode = args.pop("mode", "interesting")
    if mode == "filter":
        root = Path(args.pop("dir"))
        keep = float(args.pop("keep", 0.5))
        lpips_npz = args.pop("lpips_weights", None)
        device = cli.pop_device(args)
    elif mode in ("interesting", "different"):
        bev_dir = Path(args.pop("bev_dir"))
        out = Path(args.pop("out", f"{mode}_tokens.txt"))
        top = int(args.pop("top", 100))
    else:
        raise SystemExit(f"unknown mode {mode}")
    if args:
        raise SystemExit(f"unknown argument(s): {sorted(args)}")
    if mode == "interesting":
        scores = interesting_scores(bev_dir)[:top]
        out.write_text("\n".join(tok for tok, _ in scores))
        print(f"wrote {len(scores)} tokens to {out}")
    elif mode == "different":
        tokens = different_scores(bev_dir, top)
        out.write_text("\n".join(tokens))
        print(f"wrote {len(tokens)} tokens to {out}")
    else:
        kept, removed = filter_outputs(root, keep, lpips_npz, device)
        print(json.dumps({"kept": kept, "removed": removed}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
