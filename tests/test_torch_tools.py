"""The port's operator tools (`owdeploy`, `wsk`, `wskadmin`), run against
the JAX package's.

  (a) every case of `tests/test_deploy.py`, `test_wsk_package_bind.py` and
      `test_wsk_sequences.py` on both packages (`pkg`; see
      `tests/torch_ported_cases.py`), with free ports in place of the
      reference's fixed ones. The port's standalone is the lean one (the
      JAX standalone's default), and its two-controller `up` places with
      `controllers.device: cpu`;
  (b) `render systemd`, `render k8s` and `render monitoring` of one
      inventory: the two packages' files equal once the JAX package's
      module paths are renamed and its controllers given `--device`;
  (c) `controllers.device`: `--device` on each controller's argv when set,
      no flag when absent, a bad value refused;
  (d) the slice as a whole: one list of `wsk` commands (actions, a
      sequence, a package and its binding, invokes, triggers and rules,
      activations, usage errors) against each package's standalone (the
      JAX package's lean one, the port's TPU balancer on the CPU): the same
      exit codes and the same JSON bodies, activation ids and clocks aside;
      and `wskadmin` over the port's `docstore://` store.
"""
import asyncio
import contextlib
import importlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import aiohttp
import pytest

from tests.test_torch_standalone import mask
from tests.torch_ported_cases import PACKAGES, _free_port, ported

ROOT = Path(__file__).resolve().parents[1]

ported(globals(), "test_deploy",
       ports=("14222", "13321", "13881", "14223", "14233", "13341", "13342",
              "13882"),
       subs={"openwhisk_tpu_torch": [(
           'balancer="tpu")', 'balancer="tpu", device="cpu")')]})
_LEAN = {"openwhisk_tpu_torch": [(
    "make_standalone(port=PORT", 'make_standalone(balancer="lean", port=PORT')]}
ported(globals(), "test_wsk_package_bind", ports=("13283",), subs=_LEAN)
ported(globals(), "test_wsk_sequences", ports=("13287",), subs=_LEAN)


def _deploy(root):
    return importlib.import_module(f"{root}.tools.deploy")


def _inventory(root):
    inv = _deploy(root).load_inventory(None)
    inv["docstore"]["enabled"] = True
    inv["controllers"].update(count=2, balancer="tpu", device="cpu",
                              snapshot_dir="/var/lib/ow", snapshot_interval=5)
    inv["invokers"].update(count=2, container_factory="docker")
    inv["monitoring"]["enabled"] = True
    inv["limits"] = {"invocationsPerMinute": 9}
    return inv


def _as_port(text):
    """A JAX package's render in the port's terms: its module paths
    renamed, its controllers given the inventory's device."""
    return text.replace("openwhisk_tpu.", "openwhisk_tpu_torch.").replace(
        "--balancer tpu", "--balancer tpu --device cpu").replace(
        "- tpu\n", "- tpu\n        - --device\n        - cpu\n")


@pytest.mark.parametrize("target", ["systemd", "k8s", "monitoring"])
def test_renders_equal_up_to_the_rename_and_the_device(target, tmp_path):
    files = {}
    for root in PACKAGES:
        out = tmp_path / root
        render = {"systemd": "render_systemd", "k8s": "render_k8s",
                  "monitoring": "render_monitoring"}[target]
        with contextlib.redirect_stdout(io.StringIO()):
            getattr(_deploy(root), render)(_inventory(root), str(out))
        files[root] = {p.name: p.read_text() for p in sorted(out.iterdir())}
    jax, port = files["openwhisk_tpu"], files["openwhisk_tpu_torch"]
    assert sorted(jax) == sorted(port) and jax
    for name in jax:
        assert _as_port(jax[name]) == port[name], name
    if target != "monitoring":
        assert any("--device" in t for t in port.values())


def test_controllers_device_becomes_the_flag():
    deploy = _deploy("openwhisk_tpu_torch")
    inv = deploy.load_inventory(None)
    inv["controllers"]["count"] = 2

    def ctrl_argv(inv):
        return [s["argv"] for s in deploy.services(inv)
                if s["name"].startswith("controller")]

    assert all("--device" not in a for a in ctrl_argv(inv))
    for device in ("cuda", "cpu"):
        inv["controllers"]["device"] = device
        for a in ctrl_argv(inv):
            assert a[a.index("--device") + 1] == device
    inv["controllers"]["device"] = "tpu"
    with pytest.raises(ValueError, match="controllers.device"):
        deploy.services(inv)
    # the JAX package's services take no such key
    jinv = _deploy("openwhisk_tpu").load_inventory(None)
    jinv["controllers"]["device"] = "cpu"
    assert all("--device" not in s["argv"]
               for s in _deploy("openwhisk_tpu").services(jinv))


def test_the_cli_renders_and_reads_json_inventories(tmp_path):
    """`python -m openwhisk_tpu_torch.tools.deploy -i inv.json render
    systemd` as a process; `status` with nothing running exits 1."""
    inv = tmp_path / "inv.json"
    inv.write_text(json.dumps({"rundir": str(tmp_path / "run"),
                               "controllers": {"device": "cpu"}}))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    cli = [sys.executable, "-m", "openwhisk_tpu_torch.tools.deploy", "-i",
           str(inv)]
    out = subprocess.run(cli + ["render", "systemd", "-o",
                                str(tmp_path / "units")], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    unit = (tmp_path / "units" / "ow-controller0.service").read_text()
    assert "-m openwhisk_tpu_torch.controller" in unit
    assert "--device cpu" in unit
    out = subprocess.run(cli + ["status"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 1 and "no services running" in out.stdout


# -- (d) the slice as a whole --------------------------------------------------
ECHO = "def main(args):\n    return args\n"
STEP = "def main(args):\n    return {'n': args.get('n', 0) + 1}\n"
WHO = "def main(a):\n    return {'who': a.get('who')}\n"

#: the commands, in order: `{echo}`, `{step}`, `{who}` name the action
#: files, `{last}` the last activation id a command printed
COMMANDS = [
    ["action", "create", "echo", "{echo}"],
    ["action", "create", "step", "{step}", "--memory", "128"],
    ["action", "create", "twice", "--sequence", "step,step"],
    ["package", "create", "provider", "-p", "who", "provider"],
    ["action", "create", "provider/who", "{who}"],
    ["package", "bind", "provider", "bound", "-p", "who", "binding"],
    ["action", "invoke", "echo", "-p", "a", "1", "--blocking", "--result"],
    ["action", "invoke", "twice", "-p", "n", "5", "-b", "-r"],
    ["action", "invoke", "bound/who", "-b", "-r"],
    ["action", "invoke", "echo", "-p", "a", "2", "-b"],
    ["action", "invoke", "echo", "-p", "a", "3"],
    ["action", "get", "echo"],
    ["action", "list"],
    ["package", "get", "bound"],
    ["activation", "get", "{last}"],
    ["activation", "result", "{last}"],
    ["trigger", "create", "tick", "-p", "x", "1"],
    ["rule", "create", "onTick", "--trigger", "tick", "--action", "echo"],
    ["rule", "get", "onTick"],
    ["rule", "disable", "onTick"],
    ["rule", "list"],
    ["trigger", "get", "tick"],
    ["action", "update", "echo", "-p", "tag", "v2"],
    ["action", "create", "loop", "--sequence", "loop"],
    ["action", "create", "naked"],
    ["action", "delete", "step"],
    ["action", "get", "step"],
]


async def _standalone(root, port):
    S = importlib.import_module(f"{root}.standalone")
    kw = {} if root == "openwhisk_tpu" else {"device": "cpu"}
    return S, await S.make_standalone(port=port, ui=False, **kw)


def _wsk_run(wsk, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = wsk.main(argv)
    text = out.getvalue()
    return rc, json.loads(text) if text.strip() else None


async def _wsk_session(root, files):
    port = _free_port()
    S, ctrl = await _standalone(root, port)
    wsk = importlib.import_module(f"{root}.tools.wsk")
    host = ["--apihost", f"http://127.0.0.1:{port}", "--auth",
            f"{S.GUEST_UUID}:{S.GUEST_KEY}"]
    log, last = [], None
    try:
        for template in COMMANDS:
            argv = [a.format(last=last, **files) for a in template]
            rc, body = await asyncio.to_thread(_wsk_run, wsk, host + argv)
            if isinstance(body, dict) and "activationId" in body:
                last = body["activationId"]
                await _recorded(port, S, last)
            log.append((template, rc, mask(body)))
        # the activations, once every one above is recorded
        rc, body = await asyncio.to_thread(
            _wsk_run, wsk, host + ["activation", "list"])
        log.append(("activation list", rc, sorted(
            (a["name"], mask(a.get("response", {}).get("result")))
            for a in body)))
    finally:
        await ctrl.stop()
    return log


async def _recorded(port, S, aid):
    auth = aiohttp.BasicAuth(S.GUEST_UUID, S.GUEST_KEY)
    async with aiohttp.ClientSession(auth=auth) as s:
        for _ in range(200):
            async with s.get(f"http://127.0.0.1:{port}/api/v1/namespaces/_/"
                             f"activations/{aid}") as r:
                if r.status == 200:
                    return
            await asyncio.sleep(0.05)
    raise AssertionError(f"activation {aid} never recorded")


def test_one_wsk_command_list_gives_the_same_answers_on_both(tmp_path):
    files = {}
    for name, code in (("echo", ECHO), ("step", STEP), ("who", WHO)):
        (tmp_path / f"{name}.py").write_text(code)
        files[name] = str(tmp_path / f"{name}.py")
    logs = {root: asyncio.run(_wsk_session(root, files)) for root in PACKAGES}
    jax, port = logs["openwhisk_tpu"], logs["openwhisk_tpu_torch"]
    assert len(jax) == len(port) == len(COMMANDS) + 1
    for j, p in zip(jax, port):
        assert j == p, (j, p)
    rcs = [rc for _, rc, _ in port]
    assert rcs.count(0) == len(COMMANDS) - 3 + 1
    assert rcs[COMMANDS.index(["action", "create", "naked"])] == 2
    assert port[6][2] == {"a": 1} and port[7][2] == {"n": 7}
    assert port[8][2] == {"who": "binding"}


def test_wskadmin_over_the_port_docstore(tmp_path, capsys):
    """`wskadmin --db docstore://...` against a port `DocStoreServer` over
    sqlite: create, limits, block, list and `db get`; a JAX package client
    of the same server reads the subject the port's tool wrote."""
    from openwhisk_tpu.database import AuthStore as JaxAuthStore
    from openwhisk_tpu.database import RemoteArtifactStore as JaxRemote
    from openwhisk_tpu_torch.database import (DocStoreServer,
                                              SqliteArtifactStore)
    from openwhisk_tpu_torch.tools import wskadmin

    async def admin(*argv):
        rc = await asyncio.to_thread(wskadmin.main, list(argv))
        return rc, capsys.readouterr().out

    async def go():
        srv = DocStoreServer(SqliteArtifactStore(str(tmp_path / "w.db")),
                             port=0)
        await srv.start()
        port = srv._server.sockets[0].getsockname()[1]
        db = ["--db", f"docstore://127.0.0.1:{port}"]
        try:
            rc, key = await admin(*db, "user", "create", "carol")
            assert rc == 0 and ":" in key
            assert (await admin(*db, "limits", "set", "carol",
                                "--invocations-per-minute", "7"))[0] == 0
            rc, out = await admin(*db, "limits", "get", "carol")
            assert rc == 0 and json.loads(out)["invocationsPerMinute"] == 7
            assert (await admin(*db, "user", "block", "carol"))[0] == 0
            rc, out = await admin(*db, "user", "list")
            assert rc == 0 and "carol (blocked)" in out
            rc, out = await admin(*db, "db", "get", "subjects")
            assert rc == 0 and "carol" in out
            client = JaxRemote("127.0.0.1", port)
            try:
                records = await JaxAuthStore(client).subjects()
            finally:
                await client.close()
            return key.strip(), records
        finally:
            await srv.stop()

    key, records = asyncio.run(go())
    (carol,) = [r for r in records if r.subject.asString == "carol"]
    assert carol.blocked and [k.compact for k in carol.keys] == [key]
    assert carol.limits["carol"].invocations_per_minute == 7
