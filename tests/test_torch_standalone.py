"""The port's standalone server against the JAX package's, over HTTP.

One JAX standalone (`balancer="tpu"`, the XLA kernel, no prewarm, no
calibration) and one port standalone (`device="cpu"`, the plain torch
path) boot once for the module, each with its in-process invoker running
python:3 process sandboxes. Every case sends both servers the same
scripted requests (the drives of tests/test_system_standalone.py: action
lifecycle, application error, unknown kind and missing action, sequences,
triggers and rules, packages with parameters, web actions,
require-whisk-auth, throttling) and compares what came back: status codes
and JSON bodies, after masking activation ids, timestamps, durations,
transaction ids and the sandboxes' local ports in their logs. Tolerance: none, the masked bodies must be equal.

The CLI case boots `python -m openwhisk_tpu_torch.standalone --device cpu`
in a subprocess; without `--device`, on a machine without a card, it must
exit non-zero with the no-CUDA message. The import case holds the port's
server modules free of jax and of the JAX package.
"""
import asyncio
import base64
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time

import aiohttp
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import openwhisk_tpu.standalone as JS  # noqa: E402
import openwhisk_tpu_torch.standalone as TS  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUTH = "Basic " + base64.b64encode(
    f"{TS.GUEST_UUID}:{TS.GUEST_KEY}".encode()).decode()
HDRS = {"Authorization": AUTH}
#: a second subject whose namespace may invoke twice a minute
THROTTLED_UUID = "7d3b9e1a-5c2f-4e8b-a6d1-3f9c2b7e4a10"
THROTTLED_KEY = "throttled-subject-key-" + "0" * 42
THROTTLED_HDRS = {"Authorization": "Basic " + base64.b64encode(
    f"{THROTTLED_UUID}:{THROTTLED_KEY}".encode()).decode()}

HELLO_CODE = """
def main(args):
    name = args.get('name', 'stranger')
    print('hello was called with', name)
    return {'greeting': 'Hello ' + name + '!'}
"""
FAIL_CODE = "def main(args):\n    return {'error': 'deliberate failure'}\n"
STEP_CODE = "def main(args):\n    return {'n': args.get('n', 0) + 1}\n"
OK_CODE = "def main(args):\n    return {'ok': True}\n"
WEB_CODE = ("def main(args):\n"
            "    return {'greeting': 'Hi ' + args.get('who', 'web'),"
            " 'method': args.get('__ow_method')}\n")

JAX_ENV = {"CONFIG_whisk_loadBalancer_kernel": "xla",
           "CONFIG_whisk_loadBalancer_prewarm": "false",
           "CONFIG_whisk_loadBalancer_calibrateKernel": "off"}


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def seed_throttled_subject(pkg, controller):
    """A subject in namespace `throttled` limited to two invokes a minute
    (the identity's own limit, which entitlement honours)."""
    E = pkg.core.entity
    ident = E.Identity(
        E.Subject("throttled-subject"),
        E.Namespace(E.EntityName("throttled"), E.UUID(THROTTLED_UUID)),
        E.BasicAuthenticationAuthKey(E.UUID(THROTTLED_UUID),
                                     E.Secret(THROTTLED_KEY)))
    await controller.auth_store.put(E.WhiskAuthRecord(
        ident.subject, [ident.namespace], [ident.authkey],
        limits={"throttled": E.UserLimits(invocations_per_minute=2)}))


class Servers:
    """Both standalones on one event loop in a thread of their own, so the
    in-process invokers keep pinging between test cases."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self.urls = {}
        self.controllers = []

    def run(self, coro, timeout=120.0):
        return asyncio.run_coroutine_threadsafe(
            asyncio.wait_for(coro, timeout), self.loop).result(timeout + 5)

    async def boot(self):
        import openwhisk_tpu
        import openwhisk_tpu_torch
        for name, make, pkg, kw in (
                ("jax", JS.make_standalone, openwhisk_tpu,
                 {"balancer": "tpu"}),
                ("port", TS.make_standalone, openwhisk_tpu_torch,
                 {"device": "cpu"})):
            port = free_port()
            c = await make(port=port, ui=False, **kw)
            self.controllers.append(c)
            await seed_throttled_subject(pkg, c)
            self.urls[name] = f"http://127.0.0.1:{port}"

    async def stop(self):
        for c in self.controllers:
            await c.stop()


@pytest.fixture(scope="module")
def servers():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in JAX_ENV.items():
            mp.setenv(k, v)
        srv = Servers()
        try:
            srv.run(srv.boot())
            yield srv
        finally:
            try:
                srv.run(srv.stop())
            finally:
                srv.loop.call_soon_threadsafe(srv.loop.stop)
                srv.thread.join(10)


# -- masking ---------------------------------------------------------------
_AID = re.compile(r"^[0-9a-f]{32}$")
_LOG_TS = re.compile(r"^\d{4}-\d\d-\d\dT[\d:.]+Z\s+")
#: a sandbox's listening port in its boot log line
_LOCAL_PORT = re.compile(r"127\.0\.0\.1:\d+")
#: keys whose values are clocks, durations or transaction ids
_VOLATILE = {"start", "end", "duration", "updated", "waitTime", "initTime",
             "code"}


def mask(v):
    if isinstance(v, dict):
        out = {}
        for k, x in v.items():
            if k in _VOLATILE and isinstance(x, (int, float, str)):
                out[k] = "<masked>"
            elif k == "value" and v.get("key") in _VOLATILE:
                out[k] = "<masked>"
            else:
                out[k] = mask(x)
        return out
    if isinstance(v, list):
        return [mask(x) for x in v]
    if isinstance(v, str):
        if _AID.match(v):
            return "<aid>"
        return _LOCAL_PORT.sub("127.0.0.1:<port>", _LOG_TS.sub("<ts> ", v))
    return v


class Client:
    """Records (label, status, masked JSON body) for every request."""

    def __init__(self, session, url):
        self.s, self.url, self.log = session, url, []

    async def req(self, label, method, path, headers=HDRS, json=None,
                  api=True):
        url = (f"{self.url}/api/v1{path}" if api else f"{self.url}{path}")
        async with self.s.request(method, url, headers=headers,
                                  json=json) as r:
            try:
                body = await r.json(content_type=None)
            except ValueError:
                body = await r.text()
        self.log.append((label, r.status, mask(body)))
        return r.status, body

    async def poll(self, label, path, until, tries=40):
        """GET `path` until `until(status, body)`; records only whether it
        came true (records land asynchronously after the blocking ack)."""
        ok = False
        for _ in range(tries):
            async with self.s.get(f"{self.url}/api/v1{path}",
                                  headers=HDRS) as r:
                body = await r.json(content_type=None)
                if until(r.status, body):
                    ok = True
                    break
            await asyncio.sleep(0.25)
        self.log.append((label, ok))
        return body


NS = "/namespaces/_"


async def case_lifecycle(c):
    await c.req("unauth", "GET", "/namespaces", headers={})
    hello = {"exec": {"kind": "python:3", "code": HELLO_CODE}}
    await c.req("create", "PUT", f"{NS}/actions/hello", json=hello)
    await c.req("conflict", "PUT", f"{NS}/actions/hello", json=hello)
    await c.req("update", "PUT", f"{NS}/actions/hello?overwrite=true",
                json=hello)
    await c.req("get", "GET", f"{NS}/actions/hello")
    await c.req("list", "GET", f"{NS}/actions?limit=50")
    _, body = await c.req("invoke", "POST",
                          f"{NS}/actions/hello?blocking=true",
                          json={"name": "TPU"})
    await c.req("result", "POST", f"{NS}/actions/hello?blocking=true"
                "&result=true", json={"name": "Whisk"})
    status, _ = await c.req("nonblocking", "POST", f"{NS}/actions/hello",
                            json={})
    aid = body["activationId"]
    await c.poll("record", f"{NS}/activations/{aid}",
                 lambda st, b: st == 200)
    await c.req("record_get", "GET", f"{NS}/activations/{aid}")
    await c.req("logs", "GET", f"{NS}/activations/{aid}/logs")
    await c.req("activation_result", "GET",
                f"{NS}/activations/{aid}/result")
    await c.poll("listed", f"{NS}/activations?name=hello&limit=10",
                 lambda st, b: st == 200 and len(b) >= 3)
    await c.req("delete", "DELETE", f"{NS}/actions/hello")
    await c.req("gone", "GET", f"{NS}/actions/hello")


async def case_application_error(c):
    await c.req("put", "PUT", f"{NS}/actions/failer",
                json={"exec": {"kind": "python:3", "code": FAIL_CODE}})
    await c.req("invoke", "POST", f"{NS}/actions/failer?blocking=true",
                json={})


async def case_unknown_kind_and_missing(c):
    await c.req("bad_kind", "PUT", f"{NS}/actions/x",
                json={"exec": {"kind": "cobol:1959", "code": ""}})
    await c.req("missing", "POST", f"{NS}/actions/nothere?blocking=true",
                json={})


async def case_sequence(c):
    await c.req("step", "PUT", f"{NS}/actions/step",
                json={"exec": {"kind": "python:3", "code": STEP_CODE}})
    await c.req("seq", "PUT", f"{NS}/actions/seq",
                json={"exec": {"kind": "sequence",
                               "components": ["_/step", "_/step", "_/step"]}})
    await c.req("invoke", "POST", f"{NS}/actions/seq?blocking=true",
                json={"n": 10})


async def case_triggers_and_rules(c):
    await c.req("action", "PUT", f"{NS}/actions/thello",
                json={"exec": {"kind": "python:3", "code": HELLO_CODE}})
    await c.req("trigger", "PUT", f"{NS}/triggers/t1",
                json={"parameters": [{"key": "name", "value": "Trigger"}]})
    await c.req("rule", "PUT", f"{NS}/rules/r1",
                json={"trigger": "_/t1", "action": "_/thello"})
    await c.req("rule_get", "GET", f"{NS}/rules/r1")
    await c.req("fire", "POST", f"{NS}/triggers/t1", json={})
    await c.poll("fired", f"{NS}/activations?name=thello",
                 lambda st, b: st == 200 and len(b) >= 1)
    await c.req("deactivate", "POST", f"{NS}/rules/r1",
                json={"status": "inactive"})
    await c.req("fire_inactive", "POST", f"{NS}/triggers/t1", json={})
    await c.req("rules", "GET", f"{NS}/rules")


async def case_packages(c):
    await c.req("package", "PUT", f"{NS}/packages/utils",
                json={"parameters": [{"key": "name", "value": "FromPkg"}]})
    await c.req("action", "PUT", f"{NS}/actions/utils/phello",
                json={"exec": {"kind": "python:3", "code": HELLO_CODE}})
    await c.req("invoke", "POST", f"{NS}/actions/utils/phello?blocking=true",
                json={})
    await c.req("get", "GET", f"{NS}/packages/utils")
    await c.req("binding", "PUT", f"{NS}/packages/bound",
                json={"binding": {"namespace": "guest", "name": "utils"},
                      "parameters": [{"key": "name", "value": "FromBinding"}]})
    await c.req("invoke_bound", "POST",
                f"{NS}/actions/bound/phello?blocking=true&result=true",
                json={})


async def case_web_action(c):
    await c.req("put", "PUT", f"{NS}/actions/webhello",
                json={"exec": {"kind": "python:3", "code": WEB_CODE},
                      "annotations": [{"key": "web-export", "value": True}]})
    await c.req("notweb_put", "PUT", f"{NS}/actions/notweb",
                json={"exec": {"kind": "python:3", "code": HELLO_CODE}})
    await c.req("web", "GET", "/web/guest/default/webhello.json?who=You",
                headers={})
    await c.req("notweb", "GET", "/web/guest/default/notweb.json",
                headers={})


async def case_require_whisk_auth(c):
    for name, value in (("sec", "shhh"), ("auth", True)):
        await c.req(f"put_{name}", "PUT", f"{NS}/actions/{name}",
                    json={"exec": {"kind": "python:3", "code": OK_CODE},
                          "annotations": [
                              {"key": "web-export", "value": True},
                              {"key": "require-whisk-auth", "value": value}]})
    web = "/web/guest/default"
    await c.req("no_header", "GET", f"{web}/sec.json", headers={})
    await c.req("bad_header", "GET", f"{web}/sec.json",
                headers={"X-Require-Whisk-Auth": "wrong"})
    await c.req("good_header", "GET", f"{web}/sec.json",
                headers={"X-Require-Whisk-Auth": "shhh"})
    await c.req("anon", "GET", f"{web}/auth.json", headers={})
    await c.req("authed", "GET", f"{web}/auth.json", headers=HDRS)


async def case_throttling(c):
    ns = "/namespaces/throttled"
    await c.req("put", "PUT", f"{ns}/actions/hello",
                headers=THROTTLED_HDRS,
                json={"exec": {"kind": "python:3", "code": HELLO_CODE}})
    for k in range(3):
        await c.req(f"invoke{k}", "POST",
                    f"{ns}/actions/hello?blocking=true&result=true",
                    headers=THROTTLED_HDRS, json={"name": "T"})


async def case_system_routes(c):
    await c.req("ping", "GET", "/ping", headers={}, api=False)
    await c.req("invokers", "GET", "/invokers", api=False)
    await c.req("namespaces", "GET", "/namespaces")


#: case -> the statuses the port must answer (a floor under the parity)
CASES = {
    "lifecycle": (case_lifecycle, {"unauth": 401, "create": 200,
                                   "conflict": 409, "invoke": 200,
                                   "nonblocking": 202, "gone": 404}),
    "application_error": (case_application_error, {"invoke": 502}),
    "unknown_kind_and_missing": (case_unknown_kind_and_missing,
                                 {"bad_kind": 400, "missing": 404}),
    "sequence": (case_sequence, {"invoke": 200}),
    "triggers_and_rules": (case_triggers_and_rules,
                           {"fire": 202, "fire_inactive": 204}),
    "packages": (case_packages, {"invoke": 200, "invoke_bound": 200}),
    "web_action": (case_web_action, {"web": 200, "notweb": 404}),
    "require_whisk_auth": (case_require_whisk_auth,
                           {"no_header": 401, "bad_header": 401,
                            "good_header": 200, "anon": 401,
                            "authed": 200}),
    "throttling": (case_throttling, {"invoke0": 200, "invoke1": 200,
                                     "invoke2": 429}),
    "system_routes": (case_system_routes, {"ping": 200, "invokers": 200}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_port_answers_as_the_jax_standalone(servers, name):
    case, expected = CASES[name]

    async def drive(url):
        async with aiohttp.ClientSession() as s:
            c = Client(s, url)
            await case(c)
            return c.log

    jax_log = servers.run(drive(servers.urls["jax"]))
    port_log = servers.run(drive(servers.urls["port"]))
    got = {row[0]: row[1] for row in port_log if len(row) == 3}
    for label, status in expected.items():
        assert got[label] == status, (label, port_log)
    assert [row[0] for row in port_log] == [row[0] for row in jax_log]
    for port_row, jax_row in zip(port_log, jax_log):
        assert port_row == jax_row


def test_throttle_message_text(servers):
    """The 429 body carries the entitlement's text in both packages."""
    async def drive(url):
        async with aiohttp.ClientSession() as s:
            c = Client(s, url)
            for _ in range(3):
                await c.req("i", "POST", "/namespaces/throttled/actions/"
                            "hello?blocking=true", headers=THROTTLED_HDRS,
                            json={})
            return c.log[-1]

    jax_row = servers.run(drive(servers.urls["jax"]))
    port_row = servers.run(drive(servers.urls["port"]))
    assert port_row == jax_row
    assert port_row[1] == 429
    assert port_row[2]["error"] == (
        "Too many requests in the last minute (count: exceeded, allowed: "
        "invocations per minute).")


def test_unported_admin_planes_answer_404_naming_the_plane(servers):
    """The device planes' routes (`/admin/slo`, `/admin/alerts`,
    `/admin/anomalies`, `/admin/profile/kernel`, `POST
    /admin/profile/capture`) answer as the JAX standalone's: the same
    status codes and, with the port's added `kernel_builds` census and
    capture `trace_files` set aside, the same JSON shapes; 401 without
    auth. The fleet observatory's merged metrics answer 200 with this
    one member, the disabled quality plane 404, and `GET /admin` lists
    the same routes as the JAX controller's index."""
    planes = ("/admin/slo", "/admin/alerts", "/admin/anomalies",
              "/admin/profile/kernel")

    async def drive(url):
        out = {}
        async with aiohttp.ClientSession() as s:
            base = f"{url}/api/v1/namespaces/_/actions/planeprobe"
            async with s.put(base + "?overwrite=true", headers=HDRS, json={
                    "exec": {"kind": "python:3", "code": OK_CODE}}) as r:
                assert r.status == 200
            async with s.post(base + "?blocking=true", headers=HDRS,
                              json={}) as r:
                assert r.status == 200
            for path in planes + ("/admin/fleet/metrics",
                                  "/admin/placement/quality"):
                async with s.get(url + path, headers=HDRS) as r:
                    out[path] = (r.status, await r.json())
                async with s.get(url + path) as r:
                    out["anonymous " + path] = r.status
            async with s.post(url + "/admin/profile/capture", headers=HDRS,
                              json={"steps": 2}) as r:
                out["capture"] = (r.status, await r.json())
            async with s.post(url + "/admin/profile/capture",
                              json={"steps": 2}) as r:
                out["anonymous capture"] = r.status
            async with s.get(url + "/admin", headers=HDRS) as r:
                out["index"] = await r.json()
            async with s.get(url + "/admin/placement/occupancy",
                             headers=HDRS) as r:
                out["occupancy"] = (r.status, await r.json())
        return out

    port = servers.run(drive(servers.urls["port"]))
    jax = servers.run(drive(servers.urls["jax"]))
    prof = port["/admin/profile/kernel"][1]
    assert prof.pop("kernel_builds") == []  # no nvcc on the CPU path
    assert prof["capture"].pop("trace_files") == []
    assert prof["kernel"] == "torch" and jax[
        "/admin/profile/kernel"][1]["kernel"] == "xla"
    for path in planes + ("capture",):
        assert port[path][0] == jax[path][0] == 200, path
        assert shape(port[path][1]) == shape(jax[path][1]), path
    for path in planes:
        assert port["anonymous " + path] == jax["anonymous " + path] == 401
    assert port["anonymous capture"] == jax["anonymous capture"] == 401
    slo = port["/admin/slo"][1]
    assert slo["enabled"] and slo["kernel"] == "device"
    assert slo["global"]["count"] >= 1
    assert port["/admin/alerts"][1]["rules"] == \
        jax["/admin/alerts"][1]["rules"]
    assert port["/admin/profile/kernel"][1]["compiles"]["unexpected"] == 0
    assert port["capture"][1] == jax["capture"][1]
    # the fleet observatory is on by default: its merged view answers
    # with this one member, as the JAX controller's does
    status, body = port["/admin/fleet/metrics"]
    assert status == jax["/admin/fleet/metrics"][0] == 200
    assert len(body["members"]) == 1
    assert body["members"][0]["role"] == "controller"
    assert shape(body) == shape(jax["/admin/fleet/metrics"][1])
    assert body["members_missing"] == []
    status, body = port["/admin/placement/quality"]
    assert status == 404 and "placement quality plane" in body["error"]
    rows = {r["path"]: r for r in port["index"]["routes"]}
    for path in planes + ("/admin/profile/capture",):
        assert rows[path]["enabled"] is True
    assert rows["/admin/fleet/metrics"]["enabled"] is True
    assert rows == {r["path"]: r for r in jax["index"]["routes"]}
    assert rows["/admin/placement/occupancy"]["enabled"] is True
    status, occ = port["occupancy"]
    assert status == 200 and occ["invokers"][0]["invoker"] == "invoker0"
    assert occ["kernel"] == "repair"


def shape(v):
    """A JSON value's shape: dict keys with their values' shapes; lists
    and scalars by kind (their contents depend on the run)."""
    if isinstance(v, dict):
        return {k: shape(x) for k, x in sorted(v.items())}
    return "list" if isinstance(v, list) else "scalar"


def test_restored_admin_routes_answer_as_the_jax_standalone(servers):
    """The flight recorder, host observatory, trace store and incident
    routes: the same status codes and, after masking, the same shapes as
    the JAX standalone's, after one blocking invoke."""
    async def drive(url):
        out = {}
        async with aiohttp.ClientSession() as s:
            base = f"{url}/api/v1/namespaces/_/actions/adminprobe"
            async with s.put(base + "?overwrite=true", headers=HDRS, json={
                    "exec": {"kind": "python:3", "code": OK_CODE}}) as r:
                assert r.status == 200
            async with s.post(base + "?blocking=true", headers=HDRS,
                              json={}) as r:
                assert r.status == 200
                aid = (await r.json())["activationId"]
            for path in ("/admin/placement/recent?limit=4",
                         f"/admin/placement/explain/{aid}",
                         "/admin/placement/explain/" + "0" * 32,
                         "/admin/profile/host", "/admin/traces",
                         "/admin/trace/local/" + "f" * 32,
                         "/admin/trace/" + "f" * 32,
                         "/admin/incidents",
                         "/admin/incident/local/inc-zzz"):
                async with s.get(url + path, headers=HDRS) as r:
                    out[path.replace(aid, "<aid>")] = (
                        r.status, mask(await r.json()))
            async with s.get(url + "/admin/traces") as r:
                out["anonymous"] = r.status
            async with s.post(url + "/admin/profile/host/capture",
                              headers=HDRS, json={"seconds": 0.05}) as r:
                out["capture"] = (r.status, sorted(await r.json()))
        return out

    port = servers.run(drive(servers.urls["port"]))
    jax = servers.run(drive(servers.urls["jax"]))
    for out in (port, jax):  # dicts keyed by what the run saw
        out["/admin/profile/host"][1]["gc"].pop("p99_ms")
        out["/admin/traces"][1]["stats"].pop("kept_total")
    assert {k: v[0] if isinstance(v, tuple) else v for k, v in port.items()} \
        == {k: v[0] if isinstance(v, tuple) else v for k, v in jax.items()}
    for key in port:
        if isinstance(port[key], tuple) and key != "capture":
            assert shape(port[key][1]) == shape(jax[key][1]), key
    assert port["capture"] == jax["capture"]
    recent = port["/admin/placement/recent?limit=4"][1]
    assert recent["enabled"] and recent["records"]
    jrecent = jax["/admin/placement/recent?limit=4"][1]
    assert shape(recent["records"][-1]) == shape(jrecent["records"][-1])
    assert shape(recent["records"][-1]["decisions"][0]) == \
        shape(jrecent["records"][-1]["decisions"][0])
    status, explained = port["/admin/placement/explain/<aid>"]
    assert status == 200 and explained["decision"]["invoker"] == "invoker0"
    host = port["/admin/profile/host"][1]
    assert host["enabled"] and host["installed"] and host["loop_lag"]["ticks"]
    assert port["/admin/incidents"][0] == 404
    assert port["anonymous"] == 401


# -- the CLI ---------------------------------------------------------------
def test_cli_boots_on_the_cpu_and_exits_on_sigterm():
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "openwhisk_tpu_torch.standalone", "--device",
         "cpu", "--no-ui", "--port", str(port)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        async def invoke():
            url = f"http://127.0.0.1:{port}/api/v1/namespaces/_/actions/h"
            async with aiohttp.ClientSession() as s:
                deadline = time.monotonic() + 60
                while True:
                    try:
                        async with s.put(url, headers=HDRS, json={
                                "exec": {"kind": "python:3",
                                         "code": HELLO_CODE}}) as r:
                            assert r.status == 200
                            break
                    except aiohttp.ClientConnectionError:
                        assert time.monotonic() < deadline, "no boot"
                        await asyncio.sleep(0.2)
                async with s.post(url + "?blocking=true&result=true",
                                  headers=HDRS, json={"name": "CLI"}) as r:
                    return r.status, await r.json()

        assert asyncio.run(asyncio.wait_for(invoke(), 90)) == (
            200, {"greeting": "Hello CLI!"})
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=30)
        assert proc.returncode == 0, err
        assert "device=cpu" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def cardless_cli():
    """One fresh interpreter without a visible card: it imports the port's
    server modules, notes which jax or JAX-package modules came with them,
    then runs `python -m openwhisk_tpu_torch.standalone` without `--device`
    (`runpy`, as `-m` does)."""
    code = (
        "import runpy, sys\n"
        "import openwhisk_tpu_torch.standalone\n"
        "import openwhisk_tpu_torch.controller.core\n"
        "import openwhisk_tpu_torch.controller.api\n"
        "import openwhisk_tpu_torch.invoker.reactive\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or"
        " k.startswith('jax.') or k == 'openwhisk_tpu' or"
        " k.startswith('openwhisk_tpu.'))\n"
        "print('foreign modules:', bad, flush=True)\n"
        f"sys.argv = ['standalone', '--no-ui', '--port', '{free_port()}']\n"
        "runpy.run_module('openwhisk_tpu_torch.standalone',"
        " run_name='__main__')\n")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_cli_without_a_card_exits_with_the_reason(cardless_cli):
    """The default device is the card: on a machine without one the CLI
    fails before it boots anything."""
    assert cardless_cli.returncode != 0
    assert "no CUDA device is available" in cardless_cli.stderr
    assert "listening" not in cardless_cli.stdout


def test_make_standalone_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        asyncio.run(TS.make_standalone(port=free_port(), ui=False))


# -- the import closure ----------------------------------------------------
def test_server_modules_import_neither_jax_nor_the_jax_package(cardless_cli):
    assert "foreign modules: []" in cardless_cli.stdout, (
        cardless_cli.stdout + cardless_cli.stderr)


_JAX_PKG_IMPORT = re.compile(
    r"^\s*(?:from|import)\s+(?:openwhisk_tpu|jax)(?:\.|\s|$)", re.M)


def test_port_sources_name_no_jax_package_import():
    """No source of the port imports `openwhisk_tpu` (without `_torch`) or
    jax, at module level or inside a function."""
    offenders = []
    pkg = os.path.join(ROOT, "openwhisk_tpu_torch")
    for dirpath, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    if _JAX_PKG_IMPORT.search(fh.read()):
                        offenders.append(os.path.relpath(path, ROOT))
    assert not offenders
