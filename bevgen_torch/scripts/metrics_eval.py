"""Offline quality metrics over a generated output tree.

    python -m bevgen_torch.scripts.metrics_eval dir=/data/out \\
        [inception_weights=inception.npz lpips_weights=lpips.npz] \\
        [consistency=true per_camera=true max_samples=500 strict=true] \\
        [device=cuda]

The counterpart of `bevgen_tpu/scripts/metrics_eval.py` (the reference's
scripts/metrics_eval.py): FID + LPIPS/SSIM/PSNR over matched sample/ vs
sample_gt/ pairs (or the flat gen/ gt/ nuScenes tree), plus the overlap
consistency of adjacent cameras. `load_pairs` reads the JPEG tree (cv2);
`evaluate` computes the metrics on arrays, the networks on `device`
(default cuda; raises without one). Without `inception_weights` FID falls
back to pixel statistics (`fid_pixelstats(NOT paper FID)`), without
`lpips_weights` `lpips` is null, and consistency uses SIFT unless
``BEVGEN_LOFTR_WEIGHTS`` names a converted LoFTR npz. Prints one JSON line
last. One departure from the JAX CLI: an unknown argument exits (it prints
and ignores one).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

Scene = Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]


def _split_token_cam(stem: str):
    """<token>_<cam> -> (token, cam). Camera names themselves contain
    underscores (CAM_FRONT_LEFT, ring_front_center), so split by
    matching a KNOWN camera-name suffix, longest first."""
    from bevgen_torch.core.config import CAMERA_SETS
    known = sorted({c for cams in CAMERA_SETS.values() for c in cams},
                   key=len, reverse=True)
    for cam in known:
        if stem.endswith("_" + cam):
            return stem[:-(len(cam) + 1)], cam
    tok, _, cam = stem.rpartition("_")
    return tok, cam


def verify_tree_hashes(root: Path, subdirs, strict: bool = True):
    """sha1-verified sample matching (metrics_eval.py:52-74): hash each
    tree's SORTED relative jpg path set and require all trees to agree.
    A partially-written tree (crashed generation run, mid-copy rsync)
    fails loudly here instead of silently pairing a subset. Returns the
    common hash; with strict=False mismatches only warn (the pair
    loaders below then intersect, mirroring the reference's
    'Removed at least N' path before its assert)."""
    import hashlib
    digests = {}
    for sub in subdirs:
        rels = sorted(str(p.relative_to(root / sub))
                      for p in (root / sub).glob("**/*.jpg"))
        digests[sub] = (hashlib.sha1(",".join(rels).encode()).hexdigest(),
                        len(rels))
    uniq = {d for d, _ in digests.values()}
    if len(uniq) > 1:
        detail = ", ".join(f"{s}: {d[:12]} ({n} files)"
                           for s, (d, n) in digests.items())
        if strict:
            raise SystemExit(
                f"[metrics_eval] sample trees differ ({detail}) — "
                "gen/gt pairing would be unverified. Re-run generation "
                "to completion, or pass strict=false to intersect.")
        print(f"[metrics_eval] WARNING: sample trees differ ({detail}); "
              "proceeding on the intersection")
        return None
    h = uniq.pop()
    n = next(iter(digests.values()))[1]
    print(f"Total of {n} samples with hash: {h}")
    return h


def _read_rgb01(path: Path) -> np.ndarray:
    import cv2
    return cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB
                        ).astype(np.float32) / 255.0


def load_pairs_nuscenes(root: Path, max_samples=None, strict: bool = True):
    """Flat gen/ gt/ layout (<token>_<cam>.jpg) — the reference's
    nuScenes mode (metrics_eval.py:52-74)."""
    verify_tree_hashes(root, ["gen", "gt"], strict)
    gens, gts = [], []
    files = sorted((root / "gen").glob("*.jpg"))
    if max_samples:
        files = files[:max_samples]
    by_scene = {}
    for f in files:
        gt_f = root / "gt" / f.name
        if not gt_f.exists():
            continue
        g, t = _read_rgb01(f), _read_rgb01(gt_f)
        gens.append(g)
        gts.append(t)
        tok, cam = _split_token_cam(f.stem)
        by_scene.setdefault(tok, ({}, {}))
        by_scene[tok][0][cam] = g
        by_scene[tok][1][cam] = t
    return np.stack(gens), np.stack(gts), list(by_scene.values())


def load_pairs(root: Path, max_samples=None, strict: bool = True):
    """Matched (gen, gt) image arrays + per-sample cam dicts."""
    if not (root / "sample").exists() and (root / "gen").exists():
        return load_pairs_nuscenes(root, max_samples, strict)
    verify_tree_hashes(root, ["sample", "sample_gt"], strict)
    gen_root, gt_root = root / "sample", root / "sample_gt"
    tokens = sorted(p.name for p in gen_root.iterdir() if p.is_dir())
    if max_samples:
        tokens = tokens[:max_samples]
    gens, gts, scenes = [], [], []
    for tok in tokens:
        if not (gt_root / tok).exists():
            continue
        cams_g, cams_t = {}, {}
        for f in sorted((gen_root / tok).glob("*.jpg")):
            gt_f = gt_root / tok / f.name
            if not gt_f.exists():
                continue
            g, t = _read_rgb01(f), _read_rgb01(gt_f)
            gens.append(g)
            gts.append(t)
            cams_g[f.stem] = g
            cams_t[f.stem] = t
        scenes.append((cams_g, cams_t))
    return np.stack(gens), np.stack(gts), scenes


def evaluate(gen: np.ndarray, gt: np.ndarray, scenes: Sequence[Scene], *,
             lpips=None, feature_fn: Optional[Callable] = None,
             consistency: bool = False, per_camera: bool = False,
             pairs: Optional[Sequence[Tuple[str, str]]] = None,
             matcher: Optional[Callable] = None) -> Dict[str, object]:
    """The metrics of matched (n, h, w, 3) [0, 1] image sets and their
    per-scene camera dicts, unrounded: `psnr` (None for inf), `ssim`,
    `lpips` (None without an available `LPIPSMetric`), FID on
    `feature_fn`'s features (`fid_inception`) or on pixel statistics,
    `fid/<cam>` with `per_camera`, and the mean LoFTR/SIFT confidences with
    `consistency` (`pairs` picked by the rig when None; `matcher` as in
    `consistency.match_strips`)."""
    from bevgen_torch.metrics import consistency as cons
    from bevgen_torch.metrics import fid as fid_mod
    from bevgen_torch.metrics import quality

    results: Dict[str, object] = {}
    # torchmetrics PSNR aggregates GLOBAL squared error across all
    # updates (one PSNR over the whole set), not a mean of per-image
    # PSNRs — and the global form cannot go inf unless EVERY pixel
    # matches (reported as None then, to keep the JSON line RFC-valid)
    p = quality.psnr(gt, gen)
    results["psnr"] = None if np.isinf(p) else float(p)
    # torchmetrics SSIM default reduction IS the mean of per-image SSIMs
    results["ssim"] = float(np.mean(
        [quality.ssim(a, b) for a, b in zip(gt, gen)]))

    if lpips is not None and lpips.available:
        vals = [lpips(gen[i:i + 16], gt[i:i + 16])
                for i in range(0, len(gen), 16)]
        results["lpips"] = float(np.concatenate(vals).mean())
    else:
        results["lpips"] = None

    tag = "fid_inception" if feature_fn else "fid_pixelstats(NOT paper FID)"
    feat = feature_fn or fid_mod.pixel_statistics_features
    results[tag] = fid_mod.fid_from_features(feat(gen), feat(gt))

    if per_camera:
        # per-camera FID (scripts/metrics_eval_front.py equivalent)
        by_cam = {}
        for cams_g, cams_t in scenes:
            for name in cams_g:
                if name in cams_t:
                    by_cam.setdefault(name, ([], []))
                    by_cam[name][0].append(cams_g[name])
                    by_cam[name][1].append(cams_t[name])
        for name, (gs, ts) in sorted(by_cam.items()):
            results[f"fid/{name}"] = fid_mod.fid_from_features(
                feat(np.stack(gs)), feat(np.stack(ts)))

    if consistency:
        if pairs is None:
            # the adjacent-camera pair table of the rig actually in the
            # tree (nuScenes CAM_* vs Argoverse ring_*)
            cams_seen = {c for g, _ in scenes for c in g}
            pairs = (cons.NUSCENES_PAIRS
                     if any(c.startswith("CAM_") for c in cams_seen)
                     else cons.ARGOVERSE_PAIRS)
        ratios = [cons.consistency_ratio(g, t, pairs, matcher)
                  for g, t in scenes]
        results["consistency_gen_conf"] = float(np.mean(
            [r["gen_confidence"] for r in ratios]))
        results["consistency_gt_conf"] = float(np.mean(
            [r["gt_confidence"] for r in ratios]))
    return results


def main(argv: Optional[List[str]] = None) -> int:
    from bevgen_torch.core.device import resolve_device
    from bevgen_torch.metrics import consistency as cons
    from bevgen_torch.metrics import fid as fid_mod
    from bevgen_torch.metrics import quality
    from bevgen_torch.scripts.cli import parse_argv

    args = parse_argv(sys.argv[1:] if argv is None else argv)
    if "dir" not in args:
        raise SystemExit("metrics_eval needs dir=<output tree>")
    root = Path(args.pop("dir"))
    inception_npz = args.pop("inception_weights", "pretrained/inception.npz")
    lpips_npz = args.pop("lpips_weights", "pretrained/lpips.npz")
    do_consistency = args.pop("consistency", "false").lower() == "true"
    per_camera = args.pop("per_camera", "false").lower() == "true"
    max_samples = int(args.pop("max_samples", 0)) or None
    strict = args.pop("strict", "true").lower() != "false"
    device = resolve_device(args.pop("device", "cuda"))
    if args:
        raise SystemExit(f"unknown argument(s): {sorted(args)}")

    gen, gt, scenes = load_pairs(root, max_samples, strict)
    print(f"{len(gen)} matched images, {len(scenes)} scenes")
    results = evaluate(
        gen, gt, scenes,
        lpips=quality.LPIPSMetric(lpips_npz, device=device),
        feature_fn=fid_mod.make_inception_features(inception_npz,
                                                   device=device),
        consistency=do_consistency, per_camera=per_camera,
        matcher=cons.get_matcher(device) if do_consistency else None)
    print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in results.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
