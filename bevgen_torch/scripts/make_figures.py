"""Figure / comparison-site / video generators over an output tree: the
port's counterpart of `bevgen_tpu/scripts/make_figures.py`.

Reference: scripts/figure_generator.py, figure_generator_gt_compare.py
(paper figures + HTML comparison site), gen_video.py / gen_video_log.py
(imageio/ffmpeg videos).

  python -m bevgen_torch.scripts.make_figures dir=/data/out mode=figures
  python -m bevgen_torch.scripts.make_figures dir=/data/out mode=site
  python -m bevgen_torch.scripts.make_figures dir=/data/out mode=video fps=5

A host-only script: it reads and writes images with cv2 and PIL
(`utils/image.py`), which the card's machine does not have, so it is held
on the CPU only. An unknown argument exits (the JAX script prints it and
goes on).
"""
from __future__ import annotations

import html
import sys
from pathlib import Path
from typing import List, Optional

import numpy as np

from bevgen_torch.scripts import cli


def _load(f):
    import cv2
    return cv2.cvtColor(cv2.imread(str(f)), cv2.COLOR_BGR2RGB)


def make_figures(root: Path, out: Path, max_samples=None):
    """Gen-vs-GT comparison strips per sample."""
    from bevgen_torch.utils.image import Im
    tokens = sorted(p.name for p in (root / "sample").iterdir()
                    if p.is_dir())[:max_samples]
    out.mkdir(parents=True, exist_ok=True)
    n = 0
    for tok in tokens:
        gen_files = sorted((root / "sample" / tok).glob("*.jpg"))
        # use only cameras present in EVERY existing source dir so the
        # gen/GT rows stay the same width (a partially-written GT dir —
        # interrupted run, keep_cameras subset — must not abort the
        # whole figures pass on np.concatenate)
        srcs = [s for s in ("sample", "sample_gt")
                if (root / s / tok).exists()]
        names = [f.name for f in gen_files
                 if all((root / s / tok / f.name).exists() for s in srcs)]
        rows = []
        for src in srcs:
            d = root / src / tok
            imgs = [_load(d / nm) for nm in names]
            bev_png = root / "sample" / tok / "bev.png"
            if bev_png.exists() and imgs:
                h = imgs[0].shape[0]
                bev = np.asarray(Im(_load(bev_png)).resize(h, h).np)
                imgs = [bev] + imgs
            if imgs:
                rows.append(np.concatenate(imgs, axis=1))
        if rows and len({r.shape[1] for r in rows}) > 1:
            print(f"[make_figures] skipping {tok}: row widths differ")
            continue
        if rows:
            Im(np.concatenate(rows, axis=0)).save(out / f"{tok}.png")
            n += 1
    return n


def make_site(root: Path, out: Path, max_samples=None):
    """Static HTML comparison site (figure_generator_gt_compare.py)."""
    n = make_figures(root, out / "figures", max_samples)
    rows = "\n".join(
        f'<div><h3>{html.escape(p.stem)}</h3>'
        f'<img src="figures/{p.name}" style="max-width:100%"></div>'
        for p in sorted((out / "figures").glob("*.png")))
    (out / "index.html").write_text(
        f"<html><body><h1>bevgen_torch samples (top: generated, "
        f"bottom: GT)</h1>{rows}</body></html>")
    return n


def make_video(root: Path, out: Path, fps: int = 5, max_samples=None):
    """mp4 of the per-sample viz frames (gen_video.py equivalent)."""
    import cv2
    frames = sorted((root / "viz").glob("*.png"))[:max_samples]
    if not frames:
        # fall back to figure strips
        make_figures(root, out / "frames", max_samples)
        frames = sorted((out / "frames").glob("*.png"))
    if not frames:
        return 0
    first = _load(frames[0])
    h, w = first.shape[:2]
    out.mkdir(parents=True, exist_ok=True)
    vw = cv2.VideoWriter(str(out / "samples.mp4"),
                         cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        img = _load(f)
        if img.shape[:2] != (h, w):
            img = cv2.resize(img, (w, h))
        vw.write(cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    vw.release()
    return len(frames)


def main(argv: Optional[List[str]] = None) -> int:
    args = cli.parse_argv(sys.argv[1:] if argv is None else argv)
    root = Path(args.pop("dir"))
    mode = args.pop("mode", "figures")
    out = Path(args.pop("out", str(root / "figures_out")))
    fps = int(args.pop("fps", 5))
    max_samples = int(args.pop("max_samples", 0)) or None
    if args:
        raise SystemExit(f"unknown argument(s): {sorted(args)}")
    if mode == "figures":
        n = make_figures(root, out, max_samples)
    elif mode == "site":
        n = make_site(root, out, max_samples)
    elif mode == "video":
        n = make_video(root, out, fps, max_samples)
    else:
        raise SystemExit(f"unknown mode {mode}")
    print(f"{mode}: wrote {n} items to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
