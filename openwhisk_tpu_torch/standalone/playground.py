"""Dev playground UI for the standalone server.

Rebuild of the reference standalone's playground
(core/standalone/.../StandaloneOpenWhisk.scala `--no-ui` option +
PlaygroundLauncher): a single self-contained HTML page served beside
/api/v1 that creates, lists and invokes actions over the REST API with the
standalone guest credentials pre-wired. No external assets — the page must
work with zero egress.
"""
from __future__ import annotations

import base64

from aiohttp import web

_PAGE = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>OpenWhisk-TPU playground</title>
<style>
  body { font-family: system-ui, sans-serif; margin: 2rem auto; max-width: 64rem;
         color: #222; }
  h1 { font-size: 1.3rem; }
  textarea, input, select { font-family: ui-monospace, monospace;
         font-size: 0.9rem; width: 100%; box-sizing: border-box; }
  textarea { min-height: 9rem; }
  #params { min-height: 3rem; }
  button { margin: 0.3rem 0.5rem 0.3rem 0; padding: 0.4rem 1rem; }
  pre { background: #f4f4f4; padding: 0.8rem; overflow-x: auto;
        white-space: pre-wrap; }
  .row { display: flex; gap: 1rem; } .row > div { flex: 1; }
  .muted { color: #777; font-size: 0.85rem; }
</style>
</head>
<body>
<h1>OpenWhisk-TPU playground</h1>
<p class="muted">Dev UI on the standalone server — actions run as
<code>guest</code> against <code>/api/v1</code> on this port.</p>
<div class="row">
  <div>
    <label>Action name <input id="name" value="hello"></label>
    <label>Code (python:3)
      <textarea id="code">def main(args):
    name = args.get('name', 'stranger')
    return {'greeting': 'Hello ' + name + '!'}</textarea></label>
    <label>Invoke parameters (JSON) <textarea id="params">{"name": "TPU"}</textarea></label>
    <button id="save">Save action</button>
    <button id="run">Invoke (blocking)</button>
    <span class="muted">actions: <select id="actions"></select></span>
  </div>
  <div>
    <label>Result <pre id="out">—</pre></label>
    <label>Activation <pre id="act">—</pre></label>
  </div>
</div>
<script>
const AUTH = "Basic __AUTH__";
const H = {"Authorization": AUTH, "Content-Type": "application/json"};
const $ = id => document.getElementById(id);
async function api(method, path, body) {
  const r = await fetch("/api/v1" + path,
    {method, headers: H, body: body === undefined ? undefined : JSON.stringify(body)});
  let j = null;
  try { j = await r.json(); } catch (e) {}
  return {status: r.status, body: j};
}
async function refresh() {
  const r = await api("GET", "/namespaces/_/actions");
  if (r.status !== 200) return;
  const sel = $("actions"); sel.innerHTML = "";
  for (const a of r.body) {
    const o = document.createElement("option");
    o.textContent = a.name; sel.appendChild(o);
  }
}
$("actions").onchange = async () => {
  const name = $("actions").value;
  const r = await api("GET", "/namespaces/_/actions/" + name);
  if (r.status === 200 && r.body.exec && typeof r.body.exec.code === "string") {
    $("name").value = name; $("code").value = r.body.exec.code;
  }
};
$("save").onclick = async () => {
  const r = await api("PUT",
    "/namespaces/_/actions/" + $("name").value + "?overwrite=true",
    {exec: {kind: "python:3", code: $("code").value}});
  $("out").textContent = r.status === 200 ? "saved (version " +
    r.body.version + ")" : JSON.stringify(r.body, null, 2);
  refresh();
};
$("run").onclick = async () => {
  let params = {};
  try { params = JSON.parse($("params").value || "{}"); }
  catch (e) { $("out").textContent = "bad params JSON: " + e; return; }
  $("out").textContent = "running…";
  const r = await api("POST",
    "/namespaces/_/actions/" + $("name").value + "?blocking=true", params);
  if (r.body && r.body.response) {
    $("out").textContent = JSON.stringify(r.body.response.result, null, 2);
    const {activationId, duration, logs} = r.body;
    $("act").textContent = JSON.stringify({activationId, duration, logs}, null, 2);
  } else {
    $("out").textContent = "HTTP " + r.status + "\\n" +
      JSON.stringify(r.body, null, 2);
  }
};
refresh();
</script>
</body>
</html>
"""


def playground_routes(guest_uuid: str, guest_key: str):
    """(method, path, handler) triples for Controller's extra_routes seam."""
    auth = base64.b64encode(f"{guest_uuid}:{guest_key}".encode()).decode()
    page = _PAGE.replace("__AUTH__", auth)

    async def serve(request: web.Request) -> web.Response:
        return web.Response(text=page, content_type="text/html")

    async def root(request: web.Request) -> web.Response:
        raise web.HTTPFound("/playground")

    return [("GET", "/playground", serve), ("GET", "/", root)]
