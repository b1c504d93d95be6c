"""A browser-based annotation editor.

Counterpart of the root ``tools/label_server.py``, the editing half of
the reference's Windows-only labeling GUI (scd-label/FormMain.cs). It
serves a single-page canvas editor over plain ``http.server`` (PIL is
its only dependency) and reads and writes the one-``.txt``-per-image
marker format through ``scd_resnet_tpu_torch.data.labels``, so the
annotations made here feed ``python -m scd_resnet_tpu_torch.preprocess``
unchanged.

Interaction model (mirrors FormMain.cs:178-246):
  * drag            — new marker major axis (drag start = head, drag end
                      = tail, matching ``new Marker(point2, point1, ...)``
                      at FormMain.cs:194-196)
  * next click      — minor width = 2x perpendicular distance to the axis
                      (FormMain.cs:214, GetLength at 565-575)
  * next click      — halo radius = distance from the axis center
                      (FormMain.cs:218); commits the marker
  * click in a halo — select (FormMain.cs:224-229); drag moves it
  * Delete/Backspace— remove selected (FormMain.cs:607-612)
  * s               — swap head/tail of selected, or all if none
                      (FormMain.cs:633-644)
  * +/- or wheel    — zoom (FormMain.cs:355-361, 597-605)
  * Ctrl+S / Save   — write the .txt ("F2" floats, FormMain.cs:392-399)

Usage:
    python -m scd_resnet_tpu_torch.tools.label_server -i imgs/ -a annots/ \
        [-p 8741] [--host ...]
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import mimetypes
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import unquote

from scd_resnet_tpu_torch.data.labels import (
    Marker,
    load_markers,
    save_markers,
    validate_markers,
)

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")

PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>scd-label</title>
<style>
  body { margin:0; display:flex; height:100vh; font:13px sans-serif;
         background:#1e1e24; color:#ddd; }
  #side { width:230px; min-width:230px; background:#26262e; padding:8px;
          overflow-y:auto; border-right:1px solid #3a3a44; }
  #side h1 { font-size:14px; margin:2px 0 8px; color:#fff; }
  #files div { padding:3px 6px; cursor:pointer; border-radius:3px;
               white-space:nowrap; overflow:hidden; text-overflow:ellipsis; }
  #files div:hover { background:#34343e; }
  #files div.active { background:#3d5a80; color:#fff; }
  #main { flex:1; overflow:auto; position:relative; }
  canvas { display:block; cursor:crosshair; }
  #bar { position:fixed; right:8px; top:8px; background:#26262ecc;
         padding:6px 10px; border-radius:6px; z-index:5; }
  #bar button { margin-left:6px; background:#3d5a80; color:#fff;
                border:none; padding:4px 10px; border-radius:4px;
                cursor:pointer; }
  #bar button:hover { background:#4d6a90; }
  #msg { color:#9c9; margin-right:4px; }
  #help { position:fixed; right:8px; bottom:8px; background:#26262ecc;
          padding:6px 10px; border-radius:6px; color:#999; max-width:340px; }
  .dirty { color:#fc6 !important; }
</style></head><body>
<div id="side"><h1>scd-label</h1><div id="files"></div></div>
<div id="main"><canvas id="cv"></canvas></div>
<div id="bar"><span id="msg"></span>
  <button onclick="zoomBy(2)">+</button>
  <button onclick="zoomBy(0.5)">&minus;</button>
  <button onclick="swapEnds()">swap</button>
  <button onclick="save()">save</button></div>
<div id="help">drag: new axis &middot; click: width, then halo &middot;
click marker: select &middot; drag selected: move &middot; del: remove
&middot; s: swap &middot; ctrl+s: save</div>
<script>
"use strict";
let images = [], current = null, markers = [], selected = -1;
let zoom = 1, img = new Image(), dirty = false;
// creation state machine: idle -> axis(dragging) -> width -> halo
let stage = "idle", p1 = null, p2 = null, width = 0, mouse = null;
let moving = false, moveStart = null, moveOrig = null;
const cv = document.getElementById("cv"), ctx = cv.getContext("2d");

function msg(t, isDirty) {
  const el = document.getElementById("msg");
  el.textContent = t; el.className = isDirty ? "dirty" : "";
}
function setDirty(d) { dirty = d; msg(d ? "unsaved changes" : "", d); }

async function loadList() {
  images = await (await fetch("api/images")).json();
  const holder = document.getElementById("files");
  holder.innerHTML = "";
  for (const name of images) {
    const row = document.createElement("div");
    row.textContent = name;
    row.onclick = () => open(name);
    row.id = "f-" + name;
    holder.appendChild(row);
  }
  if (images.length) open(images[0]);
}
async function open(name) {
  if (dirty && !confirm("Discard unsaved changes?")) return;
  current = name; selected = -1; stage = "idle"; setDirty(false);
  for (const row of document.getElementById("files").children)
    row.className = row.id === "f-" + name ? "active" : "";
  markers = await (await fetch("api/markers/" + encodeURIComponent(name))).json();
  img = new Image();
  img.onload = () => { fitZoom(); draw(); };
  img.src = "api/image/" + encodeURIComponent(name);
}
function fitZoom() {
  const avail = document.getElementById("main").clientWidth - 16;
  zoom = Math.min(1, avail / img.width);
}
function zoomBy(f) { zoom *= f; draw(); }

function center(m) { return { x: (m.tail_x + m.head_x) / 2,
                              y: (m.tail_y + m.head_y) / 2 }; }
function dist(a, b) { return Math.hypot(a.x - b.x, a.y - b.y); }
// perpendicular distance from point c to the p1-p2 line (GetLength)
function perp(a, b, c) {
  const dx = b.x - a.x, dy = b.y - a.y, n = Math.hypot(dx, dy);
  if (n < 1e-2) return 0;
  return Math.abs(dy * (c.x - a.x) - dx * (c.y - a.y)) / n;
}

function drawMarker(m, sel) {
  const c = center(m);
  ctx.lineWidth = 2 / zoom;
  ctx.strokeStyle = sel ? "#ffd166" : "#ff4040";
  ctx.beginPath();
  ctx.moveTo(m.tail_x, m.tail_y); ctx.lineTo(m.head_x, m.head_y);
  ctx.stroke();
  // head tick so the axis direction is visible (the GUI draws the head end)
  ctx.fillStyle = sel ? "#ffd166" : "#ff8080";
  ctx.beginPath();
  ctx.arc(m.head_x, m.head_y, 3 / zoom, 0, 7); ctx.fill();
  ctx.strokeStyle = sel ? "#ffd166" : "#40ff40";
  ctx.lineWidth = 1 / zoom;
  ctx.beginPath(); ctx.arc(c.x, c.y, m.width / 2, 0, 7); ctx.stroke();
  ctx.strokeStyle = sel ? "#ffd166" : "#40a0ff";
  ctx.lineWidth = 2 / zoom;
  ctx.beginPath(); ctx.arc(c.x, c.y, m.halo_radius, 0, 7); ctx.stroke();
}
function draw() {
  cv.width = Math.max(1, Math.round(img.width * zoom));
  cv.height = Math.max(1, Math.round(img.height * zoom));
  ctx.setTransform(zoom, 0, 0, zoom, 0, 0);
  ctx.imageSmoothingEnabled = zoom < 1;
  if (img.width) ctx.drawImage(img, 0, 0);
  markers.forEach((m, i) => drawMarker(m, i === selected));
  // live preview of the marker under construction
  if (stage !== "idle" && p1 && mouse) {
    const q = stage === "axis" ? mouse : p2;
    const c = { x: (p1.x + q.x) / 2, y: (p1.y + q.y) / 2 };
    ctx.strokeStyle = "#fff"; ctx.lineWidth = 2 / zoom;
    ctx.beginPath(); ctx.moveTo(p1.x, p1.y); ctx.lineTo(q.x, q.y); ctx.stroke();
    if (stage === "width" || stage === "halo") {
      const w = stage === "width" ? perp(p1, p2, mouse) : width / 2;
      ctx.strokeStyle = "#40ff40"; ctx.lineWidth = 1 / zoom;
      ctx.beginPath(); ctx.arc(c.x, c.y, Math.max(w, 0.5), 0, 7); ctx.stroke();
    }
    if (stage === "halo") {
      ctx.strokeStyle = "#40a0ff"; ctx.lineWidth = 1 / zoom;
      ctx.beginPath();
      ctx.arc(c.x, c.y, Math.max(dist(c, mouse), 0.5), 0, 7); ctx.stroke();
    }
  }
}
function pos(ev) {
  const r = cv.getBoundingClientRect();
  return { x: (ev.clientX - r.left) / zoom, y: (ev.clientY - r.top) / zoom };
}
cv.onmousedown = (ev) => {
  const p = pos(ev);
  if (stage === "width") {          // click fixes the minor width
    width = 2 * perp(p1, p2, p);
    stage = "halo"; draw(); return;
  }
  if (stage === "halo") {           // click fixes the halo and commits
    const c = { x: (p1.x + p2.x) / 2, y: (p1.y + p2.y) / 2 };
    const halo = dist(c, p);
    if (width > 1e-2 && halo > 1e-2) {
      // drag start = head, drag end = tail (FormMain.cs:194-196)
      markers.push({ tail_x: p2.x, tail_y: p2.y, head_x: p1.x,
                     head_y: p1.y, width: width, halo_radius: halo });
      selected = markers.length - 1; setDirty(true);
    }
    stage = "idle"; draw(); return;
  }
  // idle: select if inside a halo, else start a new axis
  for (let i = markers.length - 1; i >= 0; i--) {
    if (dist(center(markers[i]), p) <= markers[i].halo_radius) {
      selected = i; moving = true; moveStart = p;
      moveOrig = Object.assign({}, markers[i]);
      draw(); return;
    }
  }
  selected = -1; stage = "axis"; p1 = p; mouse = p; draw();
};
cv.onmousemove = (ev) => {
  mouse = pos(ev);
  if (moving && selected >= 0) {
    const dx = mouse.x - moveStart.x, dy = mouse.y - moveStart.y;
    const m = markers[selected];
    m.tail_x = moveOrig.tail_x + dx; m.tail_y = moveOrig.tail_y + dy;
    m.head_x = moveOrig.head_x + dx; m.head_y = moveOrig.head_y + dy;
    setDirty(true);
  }
  if (stage !== "idle" || moving) draw();
};
cv.onmouseup = (ev) => {
  if (moving) { moving = false; return; }
  if (stage === "axis") {
    p2 = pos(ev);
    stage = dist(p1, p2) <= 1e-2 ? "idle" : "width";  // FormMain.cs:186-189
    draw();
  }
};
cv.onwheel = (ev) => {
  if (!ev.ctrlKey) return;
  ev.preventDefault(); zoomBy(ev.deltaY < 0 ? 1.25 : 0.8);
};
function swapEnds() {
  // selected marker, or every marker when none selected (FormMain.cs:633)
  const targets = selected >= 0 ? [markers[selected]] : markers;
  for (const m of targets) {
    [m.tail_x, m.head_x] = [m.head_x, m.tail_x];
    [m.tail_y, m.head_y] = [m.head_y, m.tail_y];
  }
  if (targets.length) setDirty(true);
  draw();
}
async function save() {
  if (!current) return;
  let res;
  try {
    res = await fetch("api/markers/" + encodeURIComponent(current),
      { method: "POST", body: JSON.stringify(markers) });
  } catch (err) {
    msg("SAVE FAILED: " + err, true);
    return;  // keep the dirty flag — nothing was written
  }
  if (!res.ok) {
    let detail = res.status;
    try { detail = (await res.json()).error || detail; } catch (e) {}
    msg("SAVE FAILED: " + detail, true);
    return;  // keep the dirty flag
  }
  const report = await res.json();
  setDirty(false);
  msg(report.problems.length
      ? "saved; " + report.problems.length + " warnings" : "saved", false);
}
window.onkeydown = (ev) => {
  if (ev.key === "Delete" || ev.key === "Backspace") {
    if (selected >= 0) { markers.splice(selected, 1); selected = -1;
                         setDirty(true); draw(); }
  } else if (ev.key === "s" && !ev.ctrlKey) { swapEnds(); }
  else if (ev.key === "s" && ev.ctrlKey) { ev.preventDefault(); save(); }
  else if (ev.key === "+" || ev.key === "=") { zoomBy(2); }
  else if (ev.key === "-") { zoomBy(0.5); }
  else if (ev.key === "Escape") { stage = "idle"; selected = -1; draw(); }
};
loadList();
</script></body></html>
"""


def _annotation_path(annotations_dir: str, image_name: str) -> str:
    return os.path.join(
        annotations_dir, os.path.splitext(image_name)[0] + ".txt")


class LabelHandler(BaseHTTPRequestHandler):
    """API: / (page), /api/images, /api/image/<n>, /api/markers/<n>."""

    images_dir: str = "."
    annotations_dir: str = "."
    quiet: bool = True

    def log_message(self, fmt, *args):  # noqa: D102 - silence default spam
        if not self.quiet:
            super().log_message(fmt, *args)

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, obj, code: int = 200) -> None:
        self._send(code, json.dumps(obj).encode(), "application/json")

    def _image_name(self, prefix: str):
        """Decode and validate the path component after ``prefix``."""
        name = unquote(self.path[len(prefix):])
        if (os.path.basename(name) != name or name.startswith(".")
                or not name):
            return None
        return name

    def do_GET(self):  # noqa: N802 - http.server API
        if self.path in ("/", "/index.html"):
            self._send(200, PAGE.encode(), "text/html; charset=utf-8")
        elif self.path == "/api/images":
            names = sorted(
                n for n in os.listdir(self.images_dir)
                if n.lower().endswith(IMAGE_EXTS))
            self._send_json(names)
        elif self.path.startswith("/api/image/"):
            self._serve_image()
        elif self.path.startswith("/api/markers/"):
            name = self._image_name("/api/markers/")
            if name is None:
                return self._send_json({"error": "bad name"}, 400)
            path = _annotation_path(self.annotations_dir, name)
            markers = load_markers(path) if os.path.exists(path) else []
            self._send_json([dataclasses.asdict(m) for m in markers])
        else:
            self._send_json({"error": "not found"}, 404)

    def _serve_image(self):
        name = self._image_name("/api/image/")
        path = os.path.join(self.images_dir, name) if name else None
        if not (name and os.path.exists(path)):
            return self._send_json({"error": "not found"}, 404)
        if name.lower().endswith((".tif", ".tiff")):
            # browsers cannot render TIFF: transcode to PNG on the fly
            from PIL import Image

            buf = io.BytesIO()
            with Image.open(path) as im:
                im.convert("RGB").save(buf, "PNG")
            self._send(200, buf.getvalue(), "image/png")
        else:
            ctype = mimetypes.guess_type(name)[0] or "application/octet-stream"
            with open(path, "rb") as f:
                self._send(200, f.read(), ctype)

    def do_POST(self):  # noqa: N802 - http.server API
        if not self.path.startswith("/api/markers/"):
            return self._send_json({"error": "not found"}, 404)
        name = self._image_name("/api/markers/")
        if name is None:
            return self._send_json({"error": "bad name"}, 400)
        length = int(self.headers.get("Content-Length", "0"))
        try:
            rows = json.loads(self.rfile.read(length))
            markers = [
                Marker(float(r["tail_x"]), float(r["tail_y"]),
                       float(r["head_x"]), float(r["head_y"]),
                       float(r["width"]), float(r["halo_radius"]))
                for r in rows
            ]
        except (ValueError, KeyError, TypeError) as exc:
            return self._send_json({"error": f"bad markers: {exc}"}, 400)
        os.makedirs(self.annotations_dir, exist_ok=True)
        save_markers(_annotation_path(self.annotations_dir, name), markers)
        self._send_json({"saved": len(markers),
                         "problems": validate_markers(markers)})


def make_server(images_dir: str, annotations_dir: str, host: str = "127.0.0.1",
                port: int = 0, quiet: bool = True) -> ThreadingHTTPServer:
    """Build (but do not start) the annotation server; port 0 = ephemeral."""
    handler = type("BoundLabelHandler", (LabelHandler,), {
        "images_dir": images_dir,
        "annotations_dir": annotations_dir,
        "quiet": quiet,
    })
    return ThreadingHTTPServer((host, port), handler)


def serve_background(images_dir: str, annotations_dir: str,
                     host: str = "127.0.0.1", port: int = 0):
    """Start in a daemon thread; returns (server, bound_port) — test hook."""
    server = make_server(images_dir, annotations_dir, host, port)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, server.server_address[1]


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m scd_resnet_tpu_torch.tools.label_server",
        description="browser-based SCD annotation editor")
    parser.add_argument("-i", dest="images", required=True,
                        help="directory of slide images")
    parser.add_argument("-a", dest="annotations", required=True,
                        help="directory of .txt annotation files")
    parser.add_argument("-p", dest="port", type=int, default=8741)
    parser.add_argument("--host", default="127.0.0.1")
    args = parser.parse_args(argv)

    server = make_server(args.images, args.annotations, args.host, args.port,
                         quiet=False)
    print(f"scd-label serving {args.images} at "
          f"http://{args.host}:{server.server_address[1]}/  (ctrl-c to stop)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
