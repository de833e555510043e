"""A process container's port against another process drawing the same
port while the sandbox starts, in both packages.

The JAX package's `ProcessContainerFactory` picks a sandbox's port by
binding port 0 and closing the socket; the sandbox binds that port once
its interpreter is up. Another invoker process on the host can draw the
same port in that window. Its sandbox then holds the port, this sandbox
fails to bind and exits, and this container's requests reach the other
one. When that other sandbox is paused (SIGSTOP), a run here waits out its
time limit: the 502 "action exceeded its time limit" of ROADMAP Queue 3.

Each case stands in for the other process with a listening socket that
never answers (a stopped sandbox accepts connections into its backlog and
answers none), bound to the container's port just before the sandbox is
spawned. In the JAX package it binds, and the container's /init waits out
its limit. The port's factory binds and listens on the socket itself and
hands it to the sandbox (`OW_LISTEN_FD`), so the intruder cannot bind, and
the container's runs are served by its own sandbox.
"""
import asyncio
import importlib
import socket

import pytest

CODE = "import os\ndef main(a):\n    return {'pid': os.getpid(), 'n': a.get('n')}\n"
INIT_LIMIT_S = 2.0


def _pkg(side):
    root = "openwhisk_tpu" if side == "jax" else "openwhisk_tpu_torch"
    return (importlib.import_module(f"{root}.containerpool"),
            importlib.import_module(f"{root}.core.entity"))


async def _intruded(side, monkeypatch):
    cp, E = _pkg(side)
    intruder = {}
    spawn = asyncio.create_subprocess_exec

    async def spawn_after_intruder(program, *args, **kw):
        # args: "-u", the proxy's path, the port
        port = int(args[2])
        s = socket.socket()
        try:
            s.bind(("127.0.0.1", port))
            s.listen()
            intruder["socket"] = s
        except OSError as e:
            s.close()
            intruder["refused"] = e
        return await spawn(program, *args, **kw)

    monkeypatch.setattr(asyncio, "create_subprocess_exec",
                        spawn_after_intruder)
    factory = cp.ProcessContainerFactory()
    c = await factory.create_container(None, "held", "python:3", E.MB(128))
    monkeypatch.setattr(asyncio, "create_subprocess_exec", spawn)
    out = {"bound": "socket" in intruder, "pid": c.proc.pid}
    try:
        try:
            out["init_ms"] = await c.initialize(
                {"code": CODE, "main": "main"}, timeout=INIT_LIMIT_S)
        except cp.InitializationError as e:
            out["init_error"] = str(e)
        else:
            out["runs"] = [(await c.run({"n": n}, {}, timeout=5)).response
                           for n in range(3)]
    finally:
        await factory.cleanup()
        if "socket" in intruder:
            intruder["socket"].close()
    return out


def test_reference_sandbox_port_can_be_drawn_by_another_process(monkeypatch):
    out = asyncio.run(_intruded("jax", monkeypatch))
    assert out["bound"], out
    assert "exceeded its time limit" in out["init_error"], out


def test_port_sandbox_holds_its_port_from_before_it_starts(monkeypatch):
    out = asyncio.run(_intruded("port", monkeypatch))
    assert not out["bound"], out
    assert "init_error" not in out, out
    assert out["runs"] == [{"pid": out["pid"], "n": n} for n in range(3)]


@pytest.mark.parametrize("side", ["jax", "port"])
def test_concurrent_containers_get_their_own_sandboxes(side):
    """Two factories (two invokers) create containers at once: each
    container's runs are served by its own sandbox process."""
    cp, E = _pkg(side)

    async def go():
        factories = [cp.ProcessContainerFactory() for _ in range(2)]
        try:
            cs = await asyncio.gather(*[
                f.create_container(None, f"c{i}", "python:3", E.MB(128))
                for i, f in enumerate(factories) for _ in range(3)])
            for c in cs:
                await c.initialize({"code": CODE, "main": "main"}, timeout=30)
            return [(c.proc.pid, (await c.run({"n": 1}, {}, timeout=30))
                     .response["pid"]) for c in cs]
        finally:
            for f in factories:
                await f.cleanup()

    pairs = asyncio.run(go())
    assert all(own == served for own, served in pairs), pairs
