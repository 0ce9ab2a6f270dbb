"""Interactive scene-editing web UI.

The port's counterpart of `bevgen_tpu/scripts/edit_server.py`: the
interactive surface of the reference's gradio demo
(scripts/interactive_editing.py:297-343: editable annotation table ->
re-rasterize BEV -> regenerate cameras) as a standard-library
`http.server` app: a vanilla-JS page with an editable cuboid table and a
Generate button, backed by JSON endpoints that run the pipeline.

    BEVGEN_NATIVE_RASTER=1 python -m bevgen_torch.scripts.edit_server \\
        preset=argoverse_muse_7cam port=7860 [host=127.0.0.1] [ckpt_path=...]

Endpoints:
  GET  /                 the editor page
  GET  /api/annotations  current cuboid table rows
  POST /api/generate     {"cuboids": [{category,x,y,yaw,length,width}],
                          "seed": N} -> {"bev": dataURI,
                          "cameras": {name: dataURI}, "ms": wall-time}
                         (HTTP 400 with {"error": ...} on a bad request)

The table IS the annotation state (reference predict() rebuilds the
CuboidList from the edited dataframe each click, :246-279); x is
forward / y is left in ego metres, matching the BEV conventions
(README.md:97-101).

`EditSession` builds the pipeline once, on its device (`device=`, default
cuda; it raises without one; `platform=cpu|gpu`) in the config's dtype
(bf16 unless `dtype=float32`), with seeded random weights unless
`ckpt_path` names a checkpoint. Each request rasterizes the table
(`edit_scene.rasterize_cuboids`: cv2, or the native C++ core under
`BEVGEN_NATIVE_RASTER=1`, which the card's machine needs for want of
cv2), generates at batch 1 with a `torch.Generator` seeded with seed + 1,
and encodes the images. The PNGs are written with the standard library
(`zlib`, `struct`; one deliberate departure: the JAX server uses PIL,
which the card's machine lacks): the same pixels, other bytes. The last
request's raster, ids, images and its time by stage stay in
`EditSession.last`. An unknown argument exits.
"""
from __future__ import annotations

import base64
import json
import struct
import sys
import time
import zlib
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Dict, List, Optional

import numpy as np

from bevgen_torch.scripts import cli
from bevgen_torch.scripts.edit_scene import cuboid_quad, rasterize_cuboids

_DEFAULT_CUBOIDS = [
    {"category": "REGULAR_VEHICLE", "x": 10.0, "y": 0.0, "yaw": 0.0,
     "length": 4.5, "width": 2.0},
    {"category": "REGULAR_VEHICLE", "x": 18.0, "y": 4.0, "yaw": 0.3,
     "length": 4.5, "width": 2.0},
]

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>bevgen_torch scene editor</title>
<style>
 body{font-family:system-ui,sans-serif;margin:2rem;max-width:70rem}
 table{border-collapse:collapse} td,th{border:1px solid #999;padding:4px}
 td[contenteditable]{min-width:4rem;background:#fffbe8}
 img{max-width:100%;margin-top:8px;display:block}
 button{margin:8px 4px;padding:6px 14px}
 #status{color:#555;margin-left:8px}
</style></head><body>
<h2>bevgen_torch scene editor</h2>
<p>Edit cuboids (ego metres: x forward, y left), then Generate.</p>
<table id="tbl"><thead><tr><th>category</th><th>x</th><th>y</th>
<th>yaw</th><th>length</th><th>width</th><th></th></tr></thead>
<tbody></tbody></table>
<button onclick="addRow()">add cuboid</button>
<button onclick="generate()" id="gen">Generate!</button>
<span id="status"></span>
<h3>BEV</h3><img id="bev">
<h3>Cameras</h3><div id="cams"></div>
<script>
const tb = document.querySelector('#tbl tbody');
function addRow(c){
  c = c || {category:'REGULAR_VEHICLE',x:5,y:0,yaw:0,length:4.5,width:2};
  const tr = document.createElement('tr');
  for (const k of ['category','x','y','yaw','length','width']){
    const td = document.createElement('td');
    td.contentEditable = true; td.textContent = c[k]; tr.appendChild(td);
  }
  const td = document.createElement('td');
  td.innerHTML = '<button onclick="this.closest(\\'tr\\').remove()">x</button>';
  tr.appendChild(td); tb.appendChild(tr);
}
function rows(){
  return [...tb.querySelectorAll('tr')].map(tr=>{
    const c=[...tr.querySelectorAll('td')].map(td=>td.textContent.trim());
    return {category:c[0],x:+c[1],y:+c[2],yaw:+c[3],length:+c[4],width:+c[5]};
  });
}
async function generate(){
  document.getElementById('status').textContent = 'generating...';
  document.getElementById('gen').disabled = true;
  try {
    const r = await fetch('/api/generate', {method:'POST',
      headers:{'Content-Type':'application/json'},
      body: JSON.stringify({cuboids: rows(), seed: 0})});
    const out = await r.json();
    if (!r.ok || out.error){
      document.getElementById('status').textContent =
        'error: ' + (out.error || r.status);
      return;
    }
    document.getElementById('bev').src = out.bev;
    const cams = document.getElementById('cams'); cams.innerHTML = '';
    for (const [name, uri] of Object.entries(out.cameras)){
      const h = document.createElement('h4'); h.textContent = name;
      const im = document.createElement('img'); im.src = uri;
      cams.appendChild(h); cams.appendChild(im);
    }
    document.getElementById('status').textContent = out.ms.toFixed(0)+' ms';
  } catch (e) {
    document.getElementById('status').textContent = 'error: ' + e;
  } finally {
    document.getElementById('gen').disabled = false;
  }
}
fetch('/api/annotations').then(r=>r.json()).then(rs=>rs.forEach(addRow));
</script></body></html>
"""


def cuboid_quads(rows: List[dict]):
    """Table rows -> (category, (4,3) ego footprint) list (same math as
    edit_scene.apply_edits 'add')."""
    return [(e.get("category", "REGULAR_VEHICLE"),
             cuboid_quad(float(e["x"]), float(e["y"]),
                         float(e.get("yaw", 0.0)), float(e["length"]),
                         float(e["width"])))
            for e in rows]


_PNG_COLOR_TYPES = {1: 0, 3: 2, 4: 6}   # channels -> gray, RGB, RGBA


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data +
            struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_bytes(arr: np.ndarray) -> bytes:
    """An (h, w), (h, w, 3) or (h, w, 4) uint8 image as a PNG file: 8-bit
    gray, RGB or RGBA, every row unfiltered (filter type 0), one zlib
    stream."""
    a = np.ascontiguousarray(np.asarray(arr, np.uint8))
    if a.ndim == 2:
        a = a[..., None]
    h, w, c = a.shape
    if c not in _PNG_COLOR_TYPES:
        raise ValueError(f"PNG of {c} channels: expected 1, 3 or 4")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, w * c)],
                          axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR_TYPES[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr) +
            _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) +
            _png_chunk(b"IEND", b""))


def _png_uri(arr: np.ndarray) -> str:
    return ("data:image/png;base64," +
            base64.b64encode(png_bytes(arr)).decode())


class EditSession:
    """Model + rasterizer behind the endpoints: one pipeline, reused."""

    def __init__(self, cfg, ckpt_path: Optional[str] = None, seed: int = 0,
                 device: str = "cuda"):
        from bevgen_torch.core.device import resolve_device
        from bevgen_torch.pipelines.generate import BEVGenPipeline
        from bevgen_torch.training.checkpoints import load_weights

        self.cfg = cfg
        self.pipe = BEVGenPipeline.create(
            cfg, device=resolve_device(device)).init_params(seed)
        if ckpt_path:
            load_weights(ckpt_path, self.pipe)
        self.annotations = [dict(r) for r in _DEFAULT_CUBOIDS]
        self.last: Optional[Dict[str, object]] = None

    def rasterize(self, rows: List[dict]) -> np.ndarray:
        return rasterize_cuboids(cuboid_quads(rows),
                                 self.cfg.cond_stage.resolution)

    def generate(self, rows: List[dict], seed: int = 0) -> Dict[str, object]:
        import torch
        from bevgen_torch.data import camera_geometry as cg
        from bevgen_torch.data.fake import fake_batch
        from bevgen_torch.utils import viz

        t0 = time.perf_counter()
        seg = self.rasterize(rows)
        t1 = time.perf_counter()
        batch = fake_batch(self.cfg, batch_size=1, seed=seed)
        gen = torch.Generator(device=self.pipe.device).manual_seed(seed + 1)
        images, ids = self.pipe.generate_fn(
            seg[None], batch["intrinsics_inv"], batch["extrinsics_inv"], gen)
        images = images.float().cpu().numpy()[0]   # waits for the device
        t2 = time.perf_counter()
        cams = {}
        names = self.cfg.transformer.camera_names
        for i, name in enumerate(names):
            rgb = np.clip(cg.denormalize_image(images[i]), 0, 1)
            cams[str(name)] = _png_uri((rgb * 255).astype(np.uint8))
        bev_uri = _png_uri(viz.viz_bev(seg).np)
        t3 = time.perf_counter()
        self.last = {"segmentation": seg, "ids": ids.cpu(), "images": images,
                     "ms": {"rasterize": (t1 - t0) * 1e3,
                            "generate": (t2 - t1) * 1e3,
                            "encode": (t3 - t2) * 1e3}}
        return {"bev": bev_uri, "cameras": cams, "ms": (t3 - t0) * 1e3}


def make_server(session: EditSession, host: str = "127.0.0.1",
                port: int = 0) -> HTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/":
                self._send(200, _PAGE.encode(), "text/html; charset=utf-8")
            elif self.path == "/api/annotations":
                self._send(200, json.dumps(session.annotations).encode(),
                           "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/api/generate":
                return self._send(404, b"not found", "text/plain")
            n = int(self.headers.get("Content-Length", "0"))
            try:
                req = json.loads(self.rfile.read(n) or b"{}")
                out = session.generate(req.get("cuboids", []),
                                       int(req.get("seed", 0)))
            except Exception as e:  # surface errors to the page
                return self._send(400, json.dumps(
                    {"error": repr(e)}).encode(), "application/json")
            self._send(200, json.dumps(out).encode(), "application/json")

        def log_message(self, *a):  # quiet test runs
            pass

    return HTTPServer((host, port), Handler)


def main(argv: Optional[List[str]] = None) -> int:
    args = cli.parse_argv(sys.argv[1:] if argv is None else argv)
    cfg, args = cli.build_config(args, "argoverse_muse")
    device = cli.pop_device(args)
    host = args.pop("host", "127.0.0.1")
    port = int(args.pop("port", "7860"))
    ckpt_path = args.pop("ckpt_path", None)
    if args:
        raise SystemExit(f"unknown argument(s): {sorted(args)}")
    session = EditSession(cfg, ckpt_path, seed=cfg.seed, device=device)
    srv = make_server(session, host, port)
    print(f"scene editor at http://{host}:{srv.server_address[1]}/",
          flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
