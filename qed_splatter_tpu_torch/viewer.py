"""Live web viewer (port of ``viewer.py``; ``vis="viewer"`` and ``cli
view``).

A dependency-free HTTP server that renders the *current* gaussian state on
demand. An orbit-controls HTML page polls ``/render`` with camera
parameters; frames render through the eval path on the card and return as
PNG (:mod:`~qed_splatter_tpu_torch.data.png`). It runs in a daemon thread
beside training (the trainer hands it a snapshot of the params and the
metrics at every log) or alone over a checkpoint (``cli view``).

Endpoints, as the JAX viewer's: ``/`` (the page), ``/render`` (orbit pose,
size, depth view, crop box), ``/webgl`` (the client-side splat renderer,
:mod:`.viewer_webgl`), ``/splats`` (the packed 32-byte buffer), ``/meta``,
``/status`` (step, metrics, gaussian count, paused), ``/control``
(pause / resume, which the trainer polls between dispatches),
``/keyframe`` and ``/campath`` (camera-path authoring, nerfstudio's
camera-path JSON).

Renders run on server threads, under ``torch.no_grad()``, on a snapshot of
the params taken under :attr:`ViewerState.lock`. On the card each holds
``engine.scan_runner.CAPTURE_LOCK`` around its device work (so does
``/splats``): the trainer captures CUDA graphs of the step in the global
capture mode, where a CUDA call from another thread would invalidate the
capture, and holds the same lock across each warm-up and capture. A render
asked for during a capture waits for it to end.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from qed_splatter_tpu_torch import resolve_device

_PAGE = """<!DOCTYPE html>
<html><head><title>qed-splatter-tpu viewer</title><style>
body { margin:0; background:#111; color:#eee; font-family:sans-serif; }
#hud { position:fixed; top:8px; left:8px; background:#0009; padding:10px;
       border-radius:6px; font-size:13px; max-width:330px; }
#train { color:#8fd; margin-top:4px; }
label { display:inline-block; margin-right:6px; }
input[type=number] { width:52px; background:#222; color:#eee;
                     border:1px solid #444; }
select { background:#222; color:#eee; border:1px solid #444; }
img { display:block; margin:auto; margin-top:20px; max-width:95vw; }
.row { margin-top:4px; }
</style></head><body>
<div id="hud">
  <div>drag: orbit &middot; wheel: zoom &middot;
       <a href="/webgl" style="color:#9cf">webgl view</a> &middot;
       <span id="s"></span></div>
  <div id="train"></div>
  <div class="row">
    <label>res <select id="res">
      <option>480</option><option selected>640</option>
      <option>960</option><option>1280</option></select></label>
    <label><input type="checkbox" id="depth"/> depth</label>
  </div>
  <div class="row"><label><input type="checkbox" id="crop"/> crop box</label>
    <button id="pause">pause</button>
  </div>
  <div class="row">
    <button id="addkf">+ keyframe</button>
    <button id="clearkf">clear</button>
    <span id="kfn">0 kf</span>
    <label>s <input type="number" id="secs" value="5" step="1"/></label>
    <label>fps <input type="number" id="fps" value="24" step="1"/></label>
    <a id="savepath" href="#" style="color:#9cf">save path</a>
  </div>
  <div class="row">c
    <input type="number" id="ccx" value="0" step="0.1"/>
    <input type="number" id="ccy" value="0" step="0.1"/>
    <input type="number" id="ccz" value="0" step="0.1"/></div>
  <div class="row">sz
    <input type="number" id="csx" value="2" step="0.1"/>
    <input type="number" id="csy" value="2" step="0.1"/>
    <input type="number" id="csz" value="2" step="0.1"/></div>
</div>
<img id="v" width="640"/>
<script>
let az=0.0, el=0.2, r=3.0, busy=false, dirty=true;
const img=document.getElementById('v'), hud=document.getElementById('s');
const $=id=>document.getElementById(id);
for (const id of ['res','depth','crop','ccx','ccy','ccz','csx','csy','csz'])
  $(id).addEventListener('change', ()=>{dirty=true;});
function tick(){
  if(dirty && !busy){
    busy=true; dirty=false;
    const t0=performance.now();
    const w=parseInt($('res').value), h=Math.round(w*0.75);
    img.width=w;
    let u=`/render?az=${az.toFixed(3)}&el=${el.toFixed(3)}&r=${r.toFixed(2)}`
         +`&w=${w}&h=${h}&depth=${$('depth').checked?1:0}`;
    if($('crop').checked){
      u+=`&crop=1&ccx=${$('ccx').value}&ccy=${$('ccy').value}`
        +`&ccz=${$('ccz').value}&csx=${$('csx').value}`
        +`&csy=${$('csy').value}&csz=${$('csz').value}`;
    }
    fetch(u+`&_=${Date.now()}`).then(r=>r.blob()).then(b=>{
      img.src=URL.createObjectURL(b);
      hud.textContent=`az ${az.toFixed(2)} el ${el.toFixed(2)} r ${r.toFixed(1)} (${(performance.now()-t0).toFixed(0)} ms)`;
      busy=false;
    }).catch(()=>{busy=false;});
  }
  requestAnimationFrame(tick);
}
let drag=false,lx=0,ly=0;
img.onmousedown=e=>{drag=true;lx=e.clientX;ly=e.clientY;};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{ if(!drag) return;
  az+=(e.clientX-lx)*0.01; el+=(e.clientY-ly)*0.01;
  el=Math.max(-1.5,Math.min(1.5,el)); lx=e.clientX; ly=e.clientY; dirty=true;};
window.onwheel=e=>{ r*=(1+Math.sign(e.deltaY)*0.1); r=Math.max(0.2,r); dirty=true;};
function poll(){
  fetch('/status').then(r=>r.json()).then(st=>{
    let t=`step ${st.step}`;
    if(st.metrics){
      if(st.metrics.loss!==undefined) t+=` · loss ${st.metrics.loss.toFixed(4)}`;
      if(st.metrics.psnr!==undefined) t+=` · psnr ${st.metrics.psnr.toFixed(2)}`;
    }
    if(st.gaussian_count) t+=` · ${st.gaussian_count.toLocaleString()} gaussians`;
    if(st.training) { t+=' · training'; dirty=true; }
    document.getElementById('train').textContent=t;
  }).catch(()=>{});
}
setInterval(poll, 2000); poll();
let paused=false;
$('pause').onclick=()=>{
  fetch(`/control?cmd=${paused?'resume':'pause'}`).then(r=>r.json()).then(st=>{
    paused=st.paused; $('pause').textContent=paused?'resume':'pause';
  });
};
$('addkf').onclick=()=>{
  fetch(`/keyframe?az=${az.toFixed(4)}&el=${el.toFixed(4)}&r=${r.toFixed(3)}`)
    .then(r=>r.json()).then(st=>{$('kfn').textContent=`${st.count} kf`;});
};
$('clearkf').onclick=()=>{
  fetch('/keyframe?clear=1').then(r=>r.json())
    .then(st=>{$('kfn').textContent=`${st.count} kf`;});
};
$('savepath').onclick=(e)=>{
  e.preventDefault();
  const u=`/campath?seconds=${$('secs').value}&fps=${$('fps').value}`;
  const a=document.createElement('a');
  a.href=u; a.download='camera_path.json'; a.click();
};
tick();
</script></body></html>"""


def _encode_png(rgb01: np.ndarray) -> bytes:
    from qed_splatter_tpu_torch.data.png import encode_png

    return encode_png(np.clip(np.asarray(rgb01) * 255.0, 0, 255).astype(
        np.uint8))


class ViewerState:
    """Thread-shared state: a snapshot of the params, the metrics, the
    controls and the render closure. ``timings`` keeps (render ms, PNG
    encode ms) of each ``/render``: the render between CUDA events on the
    card (the host clock on the CPU), the encode on the host clock."""

    def __init__(self, cfg, target=(0.0, 0.0, 0.0), crop=None,
                 device="cuda"):
        self.cfg = cfg
        self.target = target
        self.default_crop = crop
        self.device = resolve_device(device)
        self.lock = threading.Lock()
        self.params = None
        self.step = 0
        self.gaussian_count: Optional[int] = None
        self.metrics: Dict[str, float] = {}
        self.training = False
        # trainer control (pause / resume): the Trainer polls this between
        # dispatches
        self.paused = False
        # camera-path authoring keyframes: (az, el, radius) orbit poses
        self.keyframes: list = []
        self.timings: List[Tuple[float, float]] = []

    def _device_work(self):
        """The lock a thread holds around its CUDA work (none on the
        CPU)."""
        if self.device.type == "cuda":
            from qed_splatter_tpu_torch.engine.scan_runner import CAPTURE_LOCK

            return CAPTURE_LOCK
        return contextlib.nullcontext()

    def camera_path_json(self, seconds: float, fps: float,
                         width: int, height: int, fov: float) -> dict:
        """The authored keyframes interpolated into nerfstudio's
        camera-path JSON (``data.camera_path.load_camera_path`` and
        ns-render read it)."""
        from qed_splatter_tpu_torch.testing import orbit_c2w_opengl

        with self.lock:
            kfs = list(self.keyframes)
        if len(kfs) < 2:
            raise ValueError("need at least 2 keyframes")
        n = max(int(round(seconds * fps)), 2)
        kf = np.asarray(kfs, np.float64)              # [K, 3] az, el, r
        # piecewise-linear in orbit space with uniform time per segment;
        # azimuth interpolates along the shorter wrap direction
        daz = np.diff(kf[:, 0])
        daz = (daz + np.pi) % (2 * np.pi) - np.pi
        kf[1:, 0] = kf[0, 0] + np.cumsum(daz)
        t = np.linspace(0.0, len(kfs) - 1.0, n)
        seg = np.clip(t.astype(int), 0, len(kfs) - 2)
        frac = t - seg
        interp = kf[seg] * (1 - frac)[:, None] + kf[seg + 1] * frac[:, None]
        frames = []
        for az, el, r in interp:
            c2w = np.eye(4, dtype=np.float64)
            c2w[:3, :4] = orbit_c2w_opengl(
                float(r), float(az), float(el), target=self.target
            )[:3, :4]
            frames.append({
                "camera_to_world": c2w.reshape(-1).tolist(),
                "fov": fov,
                "aspect": width / height,
            })
        return {
            "camera_type": "perspective",
            "render_width": width,
            "render_height": height,
            "fps": fps,
            "seconds": seconds,
            "camera_path": frames,
        }

    def update(self, params, step: int,
               metrics: Optional[Dict[str, float]] = None) -> None:
        """Snapshot ``params`` (a copy on the viewer's device: the trainer
        updates its tensors in place) with the step and the metrics."""
        from qed_splatter_tpu_torch.models.gaussians import (
            FIELDS,
            GaussianParams,
        )

        snap = GaussianParams(**{
            f: getattr(params, f).detach().to(self.device, copy=True)
            for f in FIELDS})
        count = int(snap.num_alive())
        with self.lock:
            self.params = snap
            self.step = int(step)
            self.gaussian_count = count
            if metrics is not None:
                self.training = True
                self.metrics = {
                    k: float(v) for k, v in metrics.items()
                    if isinstance(v, (int, float, np.floating))
                }

    def render_frame(self, az, el, radius, width, height,
                     crop=None, depth=False) -> np.ndarray:
        """[height, width, 3] float RGB in [0, 1] (or the normalized depth
        as gray) of the orbit pose, through ``render(train=False)``."""
        return self.render_timed(az, el, radius, width, height, crop,
                                 depth)[0]

    def render_timed(self, az, el, radius, width, height, crop=None,
                     depth=False) -> Tuple[np.ndarray, float]:
        """:meth:`render_frame` and the render's ms."""
        from qed_splatter_tpu_torch.models.splatfacto import render
        from qed_splatter_tpu_torch.testing import orbit_c2w_opengl

        with self.lock:
            params = self.params
            step = self.step
        if params is None:
            return np.zeros((height, width, 3), np.float32), 0.0
        c2w = orbit_c2w_opengl(radius, az, el, target=self.target)
        f = 0.8 * max(width, height)
        K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]],
                     np.float32)
        cuda = self.device.type == "cuda"
        with self._device_work(), torch.no_grad():
            if cuda:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            t0 = time.perf_counter()
            out = render(params, c2w, K, width, height, self.cfg, step=step,
                         train=False, device=self.device,
                         crop_box=crop if crop is not None
                         else self.default_crop)
            if cuda:
                ev[1].record()
            if depth and out.depth is not None:
                d = out.depth[..., 0].cpu().numpy()
                dn = (d - d.min()) / max(float(d.max() - d.min()), 1e-9)
                img = np.stack([dn, dn, dn], axis=-1)
            else:
                img = out.rgb.cpu().numpy()
            ms = (ev[0].elapsed_time(ev[1]) if cuda
                  else 1e3 * (time.perf_counter() - t0))
        return img, ms

    def splat_buffer(self) -> Tuple[bytes, int]:
        """(the packed 32-byte-per-splat buffer, its step); empty before
        the first snapshot."""
        from qed_splatter_tpu_torch.engine.checkpoint import pack_splat_buffer

        with self.lock:
            params, step = self.params, self.step
        if params is None:
            return b"", 0
        with self._device_work():
            return pack_splat_buffer(params), step


def make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # silent
            pass

        def _send(self, code: int, ctype: str, body: bytes, headers=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            for k, v in headers:
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            q = parse_qs(url.query)

            def fget(k, d):
                return float(q.get(k, [d])[0])

            if url.path == "/":
                self._send(200, "text/html", _PAGE.encode())
            elif url.path == "/render":
                try:
                    crop = None
                    if q.get("crop", ["0"])[0] == "1":
                        from qed_splatter_tpu_torch.models.crop import CropBox

                        crop = CropBox(
                            center=(fget("ccx", 0), fget("ccy", 0),
                                    fget("ccz", 0)),
                            size=(fget("csx", 2), fget("csy", 2),
                                  fget("csz", 2)),
                        )
                    rgb, render_ms = state.render_timed(
                        fget("az", 0.0), fget("el", 0.2), fget("r", 3.0),
                        int(fget("w", 640)), int(fget("h", 480)),
                        crop=crop,
                        depth=q.get("depth", ["0"])[0] == "1",
                    )
                    t0 = time.perf_counter()
                    body = _encode_png(rgb)
                    encode_ms = 1e3 * (time.perf_counter() - t0)
                    with state.lock:
                        state.timings.append((render_ms, encode_ms))
                    self._send(200, "image/png", body)
                except Exception as e:  # keep the viewer alive
                    self._send(500, "application/json",
                               json.dumps({"error": str(e)}).encode())
            elif url.path == "/webgl":
                from qed_splatter_tpu_torch.viewer_webgl import WEBGL_PAGE

                self._send(200, "text/html", WEBGL_PAGE.encode())
            elif url.path == "/splats":
                body, step = state.splat_buffer()
                self._send(200, "application/octet-stream", body,
                           [("X-Step", str(step))])
            elif url.path == "/meta":
                body = json.dumps(
                    {"target": list(map(float, state.target))}).encode()
                self._send(200, "application/json", body)
            elif url.path == "/control":
                cmd = q.get("cmd", [""])[0]
                with state.lock:
                    if cmd == "pause":
                        state.paused = True
                    elif cmd == "resume":
                        state.paused = False
                    body = json.dumps({"paused": state.paused}).encode()
                self._send(200, "application/json", body)
            elif url.path == "/keyframe":
                with state.lock:
                    if q.get("clear", ["0"])[0] == "1":
                        state.keyframes.clear()
                    else:
                        state.keyframes.append((
                            float(q.get("az", ["0"])[0]),
                            float(q.get("el", ["0.2"])[0]),
                            float(q.get("r", ["3.0"])[0]),
                        ))
                    body = json.dumps(
                        {"count": len(state.keyframes)}).encode()
                self._send(200, "application/json", body)
            elif url.path == "/campath":
                try:
                    doc = state.camera_path_json(
                        seconds=float(q.get("seconds", ["5"])[0]),
                        fps=float(q.get("fps", ["24"])[0]),
                        width=int(q.get("w", ["1920"])[0]),
                        height=int(q.get("h", ["1080"])[0]),
                        fov=float(q.get("fov", ["50"])[0]),
                    )
                    self._send(200, "application/json",
                               json.dumps(doc, indent=2).encode(),
                               [("Content-Disposition",
                                 'attachment; filename="camera_path.json"')])
                except Exception as e:
                    self._send(400, "application/json",
                               json.dumps({"error": str(e)}).encode())
            elif url.path == "/status":
                with state.lock:
                    body = json.dumps({
                        "step": state.step,
                        "ready": state.params is not None,
                        "training": state.training,
                        "paused": state.paused,
                        "metrics": state.metrics,
                        "gaussian_count": state.gaussian_count,
                    }).encode()
                self._send(200, "application/json", body)
            else:
                self.send_response(404)
                self.end_headers()

    return Handler


class Viewer:
    """Daemon-thread HTTP viewer (``port=0`` picks a free port)."""

    def __init__(self, cfg, port: int = 7007, target=(0.0, 0.0, 0.0),
                 crop=None, device="cuda"):
        self.state = ViewerState(cfg, target=target, crop=crop,
                                 device=device)
        self.server = ThreadingHTTPServer(
            ("0.0.0.0", port), make_handler(self.state)
        )
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(
            target=self.server.serve_forever, daemon=True
        )

    def start(self) -> None:
        self.thread.start()
        print(f"Viewer running at http://localhost:{self.port} "
              f"(interactive WebGL: http://localhost:{self.port}/webgl)")

    def update(self, params, step,
               metrics: Optional[Dict[str, float]] = None) -> None:
        self.state.update(params, step, metrics)

    def stop(self) -> None:
        if self.thread.is_alive():     # shutdown() waits for serve_forever
            self.server.shutdown()
        self.server.server_close()
