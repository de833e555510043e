"""API-gateway route management and the edge proxy in the port (the
counterpart of `tests/test_edge_routemgmt.py`).

The route manager's cases run on both packages' `ApiRouteManager`
(`[jax]` / `[port]`). The edge's cases run each package's `EdgeProxy`
(`[jax-edge]` / `[port-edge]`) in front of the port's standalone on the
CPU (`make_standalone(device="cpu")`): the API routes through the edge
and `/metrics` denied, gateway route dispatch, the vanity-namespace
rewrite, and failover past a dead upstream. Then `python -m
openwhisk_tpu_torch.edge` runs as a process in front of the same
standalone and imports no torch and no jax.
"""
import asyncio
import base64
import importlib
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import aiohttp
import pytest

from torch_ha_cases import SIDES  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

WEB_CODE = """
def main(args):
    return {'greeting': 'Hello ' + args.get('who', 'world') + '!'}
"""


def _pkg(name, mod):
    root = "openwhisk_tpu" if name == "jax" else "openwhisk_tpu_torch"
    return importlib.import_module(f"{root}.{mod}")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _apidoc(base="/hello", rel="/greet", verb="get", action="webhello",
            **extra):
    doc = {"gatewayBasePath": base, "gatewayPath": rel, "gatewayMethod": verb,
           "action": {"name": action, "namespace": "guest"},
           "responsetype": "json"}
    doc.update(extra)
    return doc


def _route_manager(side):
    rm = _pkg(side, "controller.routemgmt")
    store = _pkg(side, "database.memory_store").MemoryArtifactStore()
    return rm, rm.ApiRouteManager(store)


sides = pytest.mark.parametrize("side", SIDES)


@sides
def test_create_get_delete_cycle(side):
    async def go():
        _m, rm = _route_manager(side)
        view = await rm.create_api("guest", _apidoc())
        assert view["basePath"] == "/hello"
        assert "/greet" in view["swagger"]["paths"]
        await rm.create_api("guest", _apidoc(verb="post"))
        await rm.create_api("guest", _apidoc(rel="/bye", apiName="hello-api"))
        apis = await rm.get_apis("guest")
        assert len(apis) == 1
        assert set(apis[0]["swagger"]["paths"]["/greet"]) == {"get", "post"}
        only = await rm.get_apis("guest", base_path="/hello",
                                 rel_path="/greet", verb="post")
        assert set(only[0]["swagger"]["paths"]) == {"/greet"}
        assert set(only[0]["swagger"]["paths"]["/greet"]) == {"post"}
        byname = await rm.get_apis("guest", base_path="hello-api")
        assert byname and byname[0]["basePath"] == "/hello"
        await rm.delete_api("guest", "/hello", "/greet", "post")
        apis = await rm.get_apis("guest")
        assert set(apis[0]["swagger"]["paths"]["/greet"]) == {"get"}
        await rm.delete_api("guest", "/hello", "/bye")
        assert "/bye" not in (await rm.get_apis("guest"))[0]["swagger"][
            "paths"]
        await rm.delete_api("guest", "/hello", "/greet")
        assert await rm.get_apis("guest") == []

    asyncio.run(go())


@sides
def test_validation_errors(side):
    async def go():
        m, rm = _route_manager(side)
        for bad in ({"gatewayBasePath": "/x"}, _apidoc(verb="teapot"),
                    _apidoc(responsetype="yaml")):
            with pytest.raises(m.ApiManagementException):
                await rm.create_api("guest", bad)

    asyncio.run(go())


@sides
def test_swagger_install_and_match(side):
    async def go():
        _m, rm = _route_manager(side)
        await rm.create_api("guest", _apidoc())
        await rm.create_api("guest", _apidoc(base="/hello/deep",
                                             rel="/greet", action="deep"))
        assert (await rm.match("GET", "/hello/deep/greet"))["action"] == \
            "deep"
        assert (await rm.match("GET", "/hello/greet"))["action"] == \
            "webhello"
        assert await rm.match("POST", "/hello/greet") is None
        assert await rm.match("GET", "/nothing") is None
        await rm.create_api("guest", {"swagger": {
            "swagger": "2.0", "basePath": "/sw", "info": {"title": "sw"},
            "paths": {"/p": {"get": {"x-openwhisk": {
                "namespace": "guest", "package": "", "action": "webhello",
                "responsetype": "json",
                "url": "/api/v1/web/guest/default/webhello.json"}}}}}})
        assert (await rm.match("GET", "/sw/p"))["action"] == "webhello"

    asyncio.run(go())


# -- the edge in front of the port's standalone -------------------------------------
edges = pytest.mark.parametrize("edge_side", SIDES,
                                ids=[f"{s}-edge" for s in SIDES])


def _hdrs():
    from openwhisk_tpu_torch.standalone import GUEST_KEY, GUEST_UUID
    auth = base64.b64encode(f"{GUEST_UUID}:{GUEST_KEY}".encode()).decode()
    return {"Authorization": f"Basic {auth}",
            "Content-Type": "application/json"}


def _run_edge(edge_side, fn, domain="", dead_upstream=False):
    from openwhisk_tpu_torch.standalone import make_standalone
    EdgeProxy = _pkg(edge_side, "edge").EdgeProxy
    c_port, e_port = _free_port(), _free_port()
    cbase, ebase = f"http://127.0.0.1:{c_port}", f"http://127.0.0.1:{e_port}"

    async def go():
        controller = await make_standalone(port=c_port, device="cpu")
        urls = ([f"http://127.0.0.1:{_free_port()}"] if dead_upstream
                else []) + [cbase]
        edge = EdgeProxy.for_controllers(
            urls, domain=domain,
            route_matcher=controller.route_manager.match)
        await edge.start(host="127.0.0.1", port=e_port)
        try:
            async with aiohttp.ClientSession() as s:
                async with s.put(
                        f"{cbase}/api/v1/namespaces/_/actions/webhello",
                        headers=_hdrs(),
                        json={"exec": {"kind": "python:3", "code": WEB_CODE},
                              "annotations": [{"key": "web-export",
                                               "value": True}]}) as r:
                    assert r.status == 200
                return await fn(s, cbase, ebase)
        finally:
            await edge.stop()
            await controller.stop()

    return asyncio.run(asyncio.wait_for(go(), 90))


@edges
def test_proxy_api_routes_and_deny_metrics(edge_side):
    async def go(s, cbase, ebase):
        out = {}
        async with s.get(f"{ebase}/api/v1") as r:
            out["info"] = r.status
        async with s.get(f"{ebase}/metrics") as r:
            out["metrics"] = r.status
        async with s.get(f"{ebase}/api/v1/namespaces/_/actions",
                         headers=_hdrs()) as r:
            out["list"] = (r.status, [a["name"] for a in await r.json()])
            out["transid"] = r.headers.get("X-Request-ID") is not None
        return out

    out = _run_edge(edge_side, go)
    assert out == {"info": 200, "metrics": 403, "list": (200, ["webhello"]),
                   "transid": True}


@edges
def test_gateway_route_dispatch(edge_side):
    async def go(s, cbase, ebase):
        async with s.put(f"{cbase}/api/v1/namespaces/_/apis",
                         headers=_hdrs(), json={"apidoc": _apidoc()}) as r:
            assert r.status == 200, await r.text()
        out = {}
        async with s.get(f"{ebase}/hello/greet?who=Edge") as r:
            out["hit"] = (r.status, await r.json())
        async with s.get(f"{ebase}/hello/nope") as r:
            out["miss"] = r.status
        async with s.get(f"{cbase}/api/v1/namespaces/_/apis",
                         headers=_hdrs()) as r:
            out["apis"] = [a["basePath"] for a in (await r.json())["apis"]]
        async with s.delete(
                f"{cbase}/api/v1/namespaces/_/apis?basepath=/hello",
                headers=_hdrs()) as r:
            out["del"] = r.status
        async with s.get(f"{ebase}/hello/greet") as r:
            out["after_del"] = r.status
        return out

    out = _run_edge(edge_side, go)
    assert out == {"hit": (200, {"greeting": "Hello Edge!"}), "miss": 404,
                   "apis": ["/hello"], "del": 204, "after_del": 404}


@edges
def test_vanity_namespace_rewrite(edge_side):
    async def go(s, cbase, ebase):
        hdrs = {"Host": "guest.example.test"}
        out = {}
        async with s.get(f"{ebase}/default/webhello.json?who=Vanity",
                         headers=hdrs) as r:
            out["vanity"] = (r.status, await r.json())
        async with s.get(f"{ebase}/api/v1", headers=hdrs) as r:
            out["api_untouched"] = r.status
        return out

    out = _run_edge(edge_side, go, domain="example.test")
    assert out == {"vanity": (200, {"greeting": "Hello Vanity!"}),
                   "api_untouched": 200}


@edges
def test_upstream_failover(edge_side):
    async def go(s, cbase, ebase):
        codes = []
        for _ in range(3):
            async with s.get(f"{ebase}/api/v1") as r:
                codes.append(r.status)
        return codes

    assert _run_edge(edge_side, go, dead_upstream=True) == [200, 200, 200]


def test_the_edge_cli_proxies_and_imports_neither_torch_nor_jax():
    """`python -m openwhisk_tpu_torch.edge` in front of a port standalone
    (`--device cpu`): `/api/v1` answers through it, `/metrics` is denied,
    SIGTERM exits 0; what it loaded holds no torch and no jax."""
    from openwhisk_tpu_torch.standalone import make_standalone
    c_port, e_port = _free_port(), _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONUNBUFFERED"] = "1"
    probe = ("import runpy, sys, atexit\n"
             "atexit.register(lambda: print('MODULES', sorted({m.split('.')[0]"
             " for m in sys.modules}), flush=True))\n"
             "sys.argv = ['edge'] + sys.argv[1:]\n"
             "runpy.run_module('openwhisk_tpu_torch.edge', run_name='__main__')\n")

    async def go():
        controller = await make_standalone(port=c_port, device="cpu")
        proc = subprocess.Popen(
            [sys.executable, "-c", probe, "--port", str(e_port),
             "--controllers", f"http://127.0.0.1:{c_port}"], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        try:
            codes = {}
            async with aiohttp.ClientSession() as s:
                t0 = time.monotonic()
                while time.monotonic() - t0 < 30:
                    try:
                        async with s.get(
                                f"http://127.0.0.1:{e_port}/api/v1") as r:
                            codes["api"] = r.status
                            break
                    except aiohttp.ClientError:
                        await asyncio.sleep(0.1)
                async with s.get(f"http://127.0.0.1:{e_port}/metrics") as r:
                    codes["metrics"] = r.status
        finally:
            proc.terminate()
            out, _ = await asyncio.to_thread(proc.communicate, timeout=30)
            await controller.stop()
        return codes, proc.returncode, out

    codes, rc, out = asyncio.run(asyncio.wait_for(go(), 90))
    assert codes == {"api": 200, "metrics": 403}, out
    assert rc == 0, out
    mods = eval(out.split("MODULES ", 1)[1].splitlines()[0])
    assert "openwhisk_tpu_torch" in mods
    assert not {"torch", "jax", "jaxlib", "openwhisk_tpu"} & set(mods)
