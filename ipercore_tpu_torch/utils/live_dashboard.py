"""Live training dashboard (the port's own copy of
`ipercore_tpu/utils/live_dashboard.py`): the babysitting role of the reference's
TensorBoardX/Visdom visualizers (`utils/visualizers/tb_visualizer.py:10-76`,
`visdom_visualizer.py`) without external services — a stdlib HTTP server that
renders the JSONL metrics log as auto-refreshing loss curves (inline SVG) and
shows the latest saved image panels.

Usage (wired into `services/train.py` via `--live_port`):

    dash = LiveDashboard(log_path, panels_dir, port=6006)
    dash.start()          # daemon thread; serves http://localhost:<port>/
    ...
    dash.stop()
"""
from __future__ import annotations

import html
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional


def _read_metrics(path: str, max_rows: int = 5000) -> list[dict]:
    if not path or not os.path.exists(path):
        return []
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return rows[-max_rows:]


def _svg_chart(rows: list[dict], key: str, width: int = 560,
               height: int = 160) -> str:
    ys = [float(r[key]) for r in rows
          if key in r and isinstance(r[key], (int, float))]
    if len(ys) < 2:
        return ""
    lo, hi = min(ys), max(ys)
    span = (hi - lo) or 1.0
    pts = " ".join(
        f"{i * (width - 20) / (len(ys) - 1) + 10:.1f},"
        f"{height - 18 - (y - lo) / span * (height - 36):.1f}"
        for i, y in enumerate(ys))
    return (
        f'<div class="chart"><h3>{html.escape(key)} '
        f'<small>last={ys[-1]:.4g} min={lo:.4g} max={hi:.4g}</small></h3>'
        f'<svg width="{width}" height="{height}">'
        f'<rect width="100%" height="100%" fill="#fafafa" stroke="#ddd"/>'
        f'<polyline fill="none" stroke="#0a6" stroke-width="1.5" '
        f'points="{pts}"/></svg></div>')


def render_page(log_path: str, panels_dir: Optional[str],
                refresh_s: int = 5) -> bytes:
    rows = _read_metrics(log_path)
    keys: list[str] = []
    for r in rows:
        for k, v in r.items():
            if k not in ("t", "step", "iter") and isinstance(v, (int, float)) \
                    and k not in keys:
                keys.append(k)
    charts = "".join(_svg_chart(rows, k) for k in keys[:16])
    last = rows[-1] if rows else {}
    table = "".join(
        f"<tr><td>{html.escape(str(k))}</td>"
        f"<td>{v:.5g}</td></tr>" if isinstance(v, float) else
        f"<tr><td>{html.escape(str(k))}</td><td>{html.escape(str(v))}</td></tr>"
        for k, v in last.items())
    panels = ""
    if panels_dir and os.path.isdir(panels_dir):
        pngs = sorted(f for f in os.listdir(panels_dir) if f.endswith(".png"))
        for name in pngs[-4:]:
            panels += (f'<div><h3>{html.escape(name)}</h3>'
                       f'<img src="/panel/{html.escape(name)}" '
                       f'style="max-width:95%"/></div>')
    body = (
        f"<!doctype html><html><head><title>ipercore_tpu training</title>"
        f'<meta http-equiv="refresh" content="{refresh_s}">'
        f"<style>body{{font-family:sans-serif;margin:16px}}"
        f".chart{{display:inline-block;margin:6px}}"
        f"h3{{margin:4px 0;font-size:13px}}small{{color:#888}}"
        f"table{{border-collapse:collapse}}td{{border:1px solid #ddd;"
        f"padding:2px 8px;font-size:13px}}</style></head><body>"
        f"<h2>ipercore_tpu training — {len(rows)} records</h2>"
        f"<table>{table}</table>{charts}{panels}</body></html>")
    return body.encode()


class LiveDashboard:
    """Daemon HTTP server over a MetricsLogger JSONL file + panel dir."""

    def __init__(self, log_path: str, panels_dir: Optional[str] = None,
                 port: int = 6006, host: str = "127.0.0.1"):
        self.log_path = log_path
        self.panels_dir = panels_dir
        self.port = port
        self.host = host
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "LiveDashboard":
        dash = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence request spam
                pass

            def do_GET(self):
                if self.path.startswith("/panel/") and dash.panels_dir:
                    name = os.path.basename(self.path[len("/panel/"):])
                    p = os.path.join(dash.panels_dir, name)
                    if os.path.exists(p):
                        self.send_response(200)
                        self.send_header("Content-Type", "image/png")
                        self.end_headers()
                        with open(p, "rb") as f:
                            self.wfile.write(f.read())
                        return
                    self.send_response(404)
                    self.end_headers()
                    return
                page = render_page(dash.log_path, dash.panels_dir)
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.end_headers()
                self.wfile.write(page)

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._server.server_address[1]  # resolve port 0
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        print(f"[dashboard] live at http://{self.host}:{self.port}/", flush=True)
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
