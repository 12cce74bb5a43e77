"""Live web viewer: the reference's Pangolin GUI, rebuilt transport-style.

JAX counterpart of Viewer/FrameDrawer/MapDrawer's online GUI
(reference: src/Viewer.cc:54-169 — menu switches "Follow Camera",
"Show Points/KeyFrames/Graph", "Localization Mode", "Reset";
FrameDrawer.cc:38+ current-frame overlay; MapDrawer.cc:44-228 3D map/
graph/camera rendering). A Pangolin/OpenGL window makes no sense for a
headless accelerator host, so the viewer is a tiny stdlib HTTP server:

  GET  /            one-page UI (canvas map render + live frame overlay)
  GET  /state.json  map points, keyframes, covisibility graph, pose, stats
  GET  /frame.png   current frame with tracked-feature overlay
  POST /control     {"localization": bool} | {"reset": true}

The page's toggles mirror the reference's menu booleans; Localization
Mode drives System::ActivateLocalizationMode exactly like
Viewer.cc:116-125 does.
"""
from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .frame_drawer import draw_frame
from .map_drawer import covisibility_edges

_PAGE = """<!doctype html><html><head><title>orb_slam2 viewer</title>
<style>
body{font-family:sans-serif;background:#111;color:#ddd;margin:12px}
canvas,img{border:1px solid #444;background:#000}
label{margin-right:14px}#bar{margin:8px 0}
button{margin-right:8px}
</style></head><body>
<h3>orb_slam2_with_comment_tpu — live viewer</h3>
<div id="bar">
<label><input type="checkbox" id="pts" checked>points</label>
<label><input type="checkbox" id="kfs" checked>keyframes</label>
<label><input type="checkbox" id="graph" checked>graph</label>
<label><input type="checkbox" id="follow" checked>follow camera</label>
<label><input type="checkbox" id="loc">localization mode</label>
<button onclick="doReset()">reset</button>
<span id="status"></span>
</div>
<img id="frame" width="640" height="500" src="/frame.png">
<canvas id="map" width="640" height="500"></canvas>
<script>
const cv = document.getElementById('map'), cx = cv.getContext('2d');
let scale = 40, off = [320, 250];
document.getElementById('loc').onchange = e =>
  fetch('/control', {method:'POST', body:JSON.stringify({localization:e.target.checked})});
function doReset(){ fetch('/control', {method:'POST', body:JSON.stringify({reset:true})}); }
function proj(p, C){ // top-down x/z view, optionally camera-centered
  return [off[0]+(p[0]-C[0])*scale, off[1]+(p[2]-C[2])*scale];
}
async function tick(){
  try{
    const s = await (await fetch('/state.json')).json();
    document.getElementById('status').textContent =
      ` state=${s.state} kf=${s.keyframes.length} pts=${s.points.length}` +
      ` inliers=${s.n_inliers}`;
    const C = document.getElementById('follow').checked && s.camera ?
      s.camera : [0,0,0];
    cx.fillStyle='#000'; cx.fillRect(0,0,cv.width,cv.height);
    if(document.getElementById('pts').checked){
      cx.fillStyle='#888';
      for(const p of s.points){const q=proj(p,C);cx.fillRect(q[0],q[1],1.5,1.5);}
    }
    if(document.getElementById('graph').checked){
      cx.strokeStyle='#2a6'; cx.beginPath();
      for(const e of s.edges){
        const a=proj(s.keyframes[e[0]],C), b=proj(s.keyframes[e[1]],C);
        cx.moveTo(a[0],a[1]); cx.lineTo(b[0],b[1]);
      } cx.stroke();
    }
    if(document.getElementById('kfs').checked){
      cx.fillStyle='#48f';
      for(const k of s.keyframes){const q=proj(k,C);cx.fillRect(q[0]-2,q[1]-2,4,4);}
    }
    if(s.camera){const q=proj(s.camera,C);
      cx.strokeStyle='#f44';cx.strokeRect(q[0]-4,q[1]-4,8,8);}
    document.getElementById('frame').src = '/frame.png?' + Date.now();
  }catch(e){}
  setTimeout(tick, 500);
}
tick();
</script></body></html>"""


def _png_bytes(img_rgb: np.ndarray) -> bytes:
    """Encode an RGB uint8 image as PNG via matplotlib (no extra deps)."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    from matplotlib.image import imsave
    buf = io.BytesIO()
    imsave(buf, img_rgb, format="png")
    return buf.getvalue()


class Viewer:
    """Background HTTP viewer bound to a System (reference: Viewer thread
    spawned by System.cc:105-108 when bUseViewer)."""

    def __init__(self, system, host: str = "127.0.0.1", port: int = 8765):
        self.system = system
        self._img = None  # latest raw frame (numpy, grayscale)
        self._lock = threading.Lock()
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence per-request stderr spam
                pass

            def _send(self, code, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/state.json"):
                    self._send(200, viewer._state_json(), "application/json")
                elif self.path.startswith("/frame.png"):
                    png = viewer._frame_png()
                    if png is None:
                        self._send(404, b"no frame", "text/plain")
                    else:
                        self._send(200, png, "image/png")
                else:
                    self._send(200, _PAGE.encode(), "text/html")

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    msg = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError:
                    msg = {}
                if msg.get("reset"):
                    viewer.system.reset()
                if "localization" in msg:
                    if msg["localization"]:
                        viewer.system.activate_localization_mode()
                    else:
                        viewer.system.deactivate_localization_mode()
                self._send(200, b"{}", "application/json")

        self.server = ThreadingHTTPServer((host, port), Handler)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(
            target=self.server.serve_forever, daemon=True,
            name="viewer-http")
        self.thread.start()

    # -- per-frame hook (drivers call this; cheap: stores a reference) ----
    def push_frame(self, img: np.ndarray) -> None:
        with self._lock:
            self._img = img

    # -- snapshot builders -------------------------------------------------
    def _state_json(self) -> bytes:
        tr = self.system.tracker
        m = tr.map
        n_kf = tr.n_kf_host
        pts = np.asarray(m.lm_pw)[np.asarray(m.lm_valid)]
        kfs = np.asarray(m.kf_R[:n_kf]), np.asarray(m.kf_t[:n_kf])
        centers = (-np.einsum("nij,ni->nj", kfs[0], kfs[1])
                   if n_kf else np.zeros((0, 3)))
        try:
            edges = covisibility_edges(m, n_kf)
        except Exception:
            edges = []
        cam = None
        if tr.trajectory:
            _, R, t = tr.trajectory[-1]
            R, t = np.asarray(R), np.asarray(t)
            cam = (-R.T @ t).tolist()
        doc = {
            "state": tr.state.name,
            "n_inliers": int(tr._n_inliers),
            "points": np.round(pts[::max(1, len(pts) // 2000)], 3).tolist(),
            "keyframes": np.round(centers, 3).tolist(),
            "edges": [[int(a), int(b)] for a, b, *_ in edges],
            "camera": cam,
        }
        return json.dumps(doc).encode()

    def _frame_png(self) -> bytes | None:
        with self._lock:
            img = self._img
        tr = self.system.tracker
        if img is None or tr.last_obs is None:
            return None
        obs = tr.last_obs
        try:
            import jax.numpy as jnp
            overlay = draw_frame(
                np.asarray(img, np.float32), np.asarray(obs.feats.xy),
                np.asarray(obs.lm), np.asarray(obs.feats.valid),
                state=tr.state.name, n_kf=tr.n_kf_host,
                n_lm=int(jnp.sum(tr.map.lm_valid)))
        except Exception:
            return None
        return _png_bytes(overlay)

    def close(self):
        self.server.shutdown()
        self.server.server_close()
