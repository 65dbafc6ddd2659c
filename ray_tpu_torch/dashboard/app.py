"""Dashboard: the port's state over HTTP, with a one-page frontend.

The port's counterpart of ``ray_tpu/dashboard/app.py``: a
``ThreadingHTTPServer`` on driver threads over the port's state API
(``util/state/api.py``) and metrics, as the reference's runs in its
driver. Endpoints:

  /                     the page
  /api/overview         the card ledger: CPU slots and cards, total and
                        free, and each card's leased share (the reference's
                        ``cluster_resources``; the port has no object store)
  /api/nodes            the host
  /api/tenants          each tenant's policy and the proxy's counts
  /api/actors           the driver's actors (dead ones too)
  /api/workers          its live processes (actors and ranks)
  /api/tasks            call counts by name and state, and the calls pending
  /api/stacks[?worker=] every thread's stack in each live actor
  /api/timeline         chrome://tracing JSON: calls and merged spans
  /api/logs[?worker=]   the captured log files, or one process's output
                        (``&source=err`` its stderr; dead processes too)
  /metrics              Prometheus text of the merged metrics
                        (``state.cluster_metrics``)

``/api/objects`` and ``/api/drains`` answer 404 with the reason: one host
has no object store and no node to drain.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>ray_tpu_torch dashboard</title>
<style>
 body{font-family:system-ui,sans-serif;margin:0;background:#f6f7f9;color:#1a1c20}
 header{background:#15314d;color:#fff;padding:10px 20px;font-size:18px}
 header small{opacity:.7;margin-left:12px}
 main{padding:16px 20px;max-width:1200px;margin:auto}
 .cards{display:flex;gap:12px;flex-wrap:wrap;margin-bottom:16px}
 .card{background:#fff;border-radius:8px;padding:12px 16px;min-width:150px;
       box-shadow:0 1px 3px rgba(0,0,0,.08)}
 .card h3{margin:0 0 4px;font-size:12px;text-transform:uppercase;color:#667}
 .card .v{font-size:22px;font-weight:600}
 .bar{height:6px;background:#e4e7ec;border-radius:3px;margin-top:6px}
 .bar i{display:block;height:100%;background:#2f7bd9;border-radius:3px}
 table{border-collapse:collapse;width:100%;background:#fff;border-radius:8px;
       overflow:hidden;box-shadow:0 1px 3px rgba(0,0,0,.08);margin-bottom:16px}
 th,td{padding:7px 10px;text-align:left;font-size:13px;border-bottom:1px solid #eef0f3}
 th{background:#fafbfc;color:#556;font-weight:600}
 h2{font-size:14px;color:#334;margin:18px 0 8px}
 pre{background:#101418;color:#cde;padding:12px;border-radius:8px;overflow:auto;
     font-size:11px;max-height:400px}
 button{background:#2f7bd9;color:#fff;border:0;border-radius:6px;padding:6px 12px;
        cursor:pointer;font-size:13px}
 .ok{color:#1a7f37}.bad{color:#c62828}
</style></head><body>
<header>ray_tpu_torch dashboard<small id="ts"></small></header>
<main>
 <div class="cards" id="cards"></div>
 <h2>Nodes</h2><table id="nodes"></table>
 <h2>Tenants</h2><table id="tenants"></table>
 <h2>Actors</h2><table id="actors"></table>
 <h2>Workers</h2><table id="workers"></table>
 <h2>Task states</h2><table id="tasks"></table>
 <h2>Profiling <button onclick="stacks()">Dump worker stacks</button>
    <a href="/api/timeline" download="timeline.json"><button>Download timeline</button></a></h2>
 <pre id="stacks" style="display:none"></pre>
</main>
<script>
const fmt=(n)=>typeof n==='number'?(Number.isInteger(n)?n:n.toFixed(2)):n;
function table(el,rows,cols){
  const t=document.getElementById(el);
  if(!rows||!rows.length){t.innerHTML='<tr><td>(none)</td></tr>';return}
  cols=cols||Object.keys(rows[0]);
  t.innerHTML='<tr>'+cols.map(c=>`<th>${c}</th>`).join('')+'</tr>'+
   rows.map(r=>'<tr>'+cols.map(c=>`<td>${fmt(r[c]??'')}</td>`).join('')+'</tr>').join('');
}
async function j(u){return (await fetch(u)).json()}
async function refresh(){
 try{
  const o=await j('/api/overview');
  const cards=[];
  for(const [k,v] of Object.entries(o.resources||{})){
    const used=v.total-v.available;
    cards.push(`<div class="card"><h3>${k}</h3><div class="v">${fmt(used)} / ${fmt(v.total)}</div>
      <div class="bar"><i style="width:${v.total?100*used/v.total:0}%"></i></div></div>`);
  }
  for(const [c,s] of Object.entries(o.cards||{})){
    cards.push(`<div class="card"><h3>card ${c}</h3><div class="v">${fmt(s.leased)} / 1 leased</div>
      <div class="bar"><i style="width:${100*s.leased}%"></i></div></div>`);
  }
  document.getElementById('cards').innerHTML=cards.join('');
  table('nodes',await j('/api/nodes'));
  table('tenants',(await j('/api/tenants')).map(t=>({tenant:t.tenant,
    weight:t.weight,priority:t.priority,quota:JSON.stringify(t.quota||{}),
    inflight:t.inflight,shed:t.shed})));
  table('actors',(await j('/api/actors')).slice(0,50));
  table('workers',(await j('/api/workers')).slice(0,50));
  const ts=await j('/api/tasks');
  table('tasks',Object.entries(ts.summary||{}).map(([k,v])=>({state:k,count:v})));
  document.getElementById('ts').textContent=new Date().toLocaleTimeString();
 }catch(e){document.getElementById('ts').textContent='disconnected: '+e}
}
async function stacks(){
 const el=document.getElementById('stacks');el.style.display='block';
 el.textContent='collecting...';
 const s=await j('/api/stacks');
 el.textContent=Object.entries(s).map(([w,t])=>`=== worker ${w} ===\\n${t}`).join('\\n\\n')||'(no workers)';
}
refresh();setInterval(refresh,2000);
</script></body></html>"""

_NO_SOURCE = {
    "/api/objects": "the port has no object store (state.list_objects is not ported)",
    "/api/drains": "the port runs on one host, whose node is never drained "
                   "(state.drain_status is not ported)",
}


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def _send(self, code: int, body: bytes, content_type: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj, code=200):
        self._send(code, json.dumps(obj, default=str).encode(), "application/json")

    def do_GET(self):
        from ray_tpu_torch.util import metrics
        from ray_tpu_torch.util.state import api as st

        try:
            parsed = urlparse(self.path)
            path, q = parsed.path, parse_qs(parsed.query)
            target = (q.get("worker") or [None])[0]
            if path in ("/", "/index.html"):
                self._send(200, _PAGE.encode(), "text/html; charset=utf-8")
            elif path == "/api/overview":
                self._json(_overview())
            elif path == "/api/nodes":
                self._json(st.list_nodes())
            elif path == "/api/tenants":
                self._json(st.tenant_stats())
            elif path == "/api/actors":
                self._json(st.list_actors())
            elif path == "/api/workers":
                self._json(st.list_workers())
            elif path == "/api/tasks":
                self._json({"summary": st.summarize_tasks(), "recent": st.list_tasks(limit=100)})
            elif path == "/api/stacks":
                self._json(st.get_worker_stacks(target))
            elif path == "/api/timeline":
                self._json(st.timeline())
            elif path == "/api/logs":
                if target:
                    source = (q.get("source") or ["out"])[0]
                    self._json({"text": st.get_log(target, source=source)})
                else:
                    self._json(st.list_logs())
            elif path == "/metrics":
                self._send(200, metrics.render_prometheus(st.cluster_metrics()).encode(),
                           "text/plain; version=0.0.4")
            elif path in _NO_SOURCE:
                self._json({"error": f"{path}: {_NO_SOURCE[path]}"}, code=404)
            else:
                self._json({"error": f"unknown path {path}"}, code=404)
        except BrokenPipeError:
            pass
        except Exception as e:  # noqa: BLE001 — the request's error, as a 500
            try:
                self._json({"error": repr(e)}, code=500)
            except OSError:
                pass


def _overview() -> dict:
    """The card ledger's CPU slots and cards, total and free, and each
    card's leased share."""
    from ray_tpu_torch._private.cards import default_ledger

    ledger = default_ledger()
    cards, free = ledger.card_ids(), ledger.free()
    resources = {"CPU": {"total": ledger.cpu_total(), "available": free.cpus},
                 "GPU": {"total": float(len(cards)),
                         "available": sum(free.shares.get(c, 0.0) for c in cards)}}
    return {"resources": resources,
            "cards": {c: {"leased": 1.0 - free.shares.get(c, 0.0)} for c in cards}}


_server: Optional[ThreadingHTTPServer] = None


def start_dashboard(host: str = "127.0.0.1", port: int = 8265) -> int:
    """Start the dashboard on driver threads (once); returns its port.
    ``port=0`` takes a free one."""
    global _server
    if _server is not None:
        return _server.server_address[1]
    _server = ThreadingHTTPServer((host, port), _Handler)
    _server.daemon_threads = True
    threading.Thread(target=_server.serve_forever, daemon=True, name="dashboard-http").start()
    return _server.server_address[1]


def stop_dashboard() -> None:
    global _server
    if _server is not None:
        _server.shutdown()
        _server.server_close()
        _server = None
