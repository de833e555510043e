"""The port's multi-process deployment: the broker, invoker and controller
CLIs (`python -m openwhisk_tpu_torch.{messaging,invoker,controller}`), the
invoker id assigner, the import closures of the processes, and the copy
check of every module this deployment copied from the JAX package.

The process cases run the three CLIs on localhost with the controller on
the CPU (`--device cpu` for the TPU balancer), each bounded to 60 s.
"""
import ast
import asyncio
import base64
import io
import json
import os
import signal
import socket
import subprocess
import sys
import time
import tokenize
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from openwhisk_tpu_torch.database import SqliteArtifactStore
from openwhisk_tpu_torch.invoker.id_assigner import InstanceIdAssigner
from openwhisk_tpu_torch.standalone import GUEST_KEY, GUEST_UUID

ROOT = Path(__file__).resolve().parents[1]
AUTH = "Basic " + base64.b64encode(
    f"{GUEST_UUID}:{GUEST_KEY}".encode()).decode()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONUNBUFFERED="1", **extra)
    return env


# -- ref tests/test_distributed.py::TestIdAssigner ----------------------------
def test_stable_id_assignment(tmp_path):
    async def go():
        a = InstanceIdAssigner(SqliteArtifactStore(str(tmp_path / "ids.db")))
        return (await a.assign("invoker-a"), await a.assign("invoker-b"),
                await a.assign("invoker-a"),
                await a.assign("invoker-c", overwrite_id=9),
                await a.assign("invoker-d"))

    id1, id2, id1_again, forced, id_next = asyncio.run(go())
    assert (id1, id2) == (0, 1)
    assert id1_again == 0  # stable across restarts
    assert forced == 9
    assert id_next == 10


def test_concurrent_assignment_has_no_duplicates(tmp_path):
    async def go():
        store = SqliteArtifactStore(str(tmp_path / "ids2.db"))
        return await asyncio.gather(*[
            InstanceIdAssigner(store).assign(f"inv-{i}") for i in range(8)])

    assert sorted(asyncio.run(go())) == list(range(8))  # the CAS loop


_ASSIGN = """
import asyncio, sys, time
from openwhisk_tpu_torch.database import SqliteArtifactStore
from openwhisk_tpu_torch.invoker.id_assigner import InstanceIdAssigner
while time.time() < float(sys.argv[3]):
    pass
store = SqliteArtifactStore(sys.argv[1])
print(asyncio.run(InstanceIdAssigner(store).assign(sys.argv[2])))
"""


@pytest.mark.parametrize("trial", range(2))
@pytest.mark.parametrize("new_file", [False, True])
def test_invoker_processes_claiming_ids_at_once_get_distinct_ids(
        new_file, trial, tmp_path):
    """Six processes on one sqlite file claim ids at the same instant (the
    invokers of a deployment booting together), on a file that exists or
    one they all create: each opens the store, and the store's revision
    check holds across processes, so no two share an id."""
    db = str(tmp_path / "ids.db")
    if not new_file:
        SqliteArtifactStore(db)  # the schema, before the race
    start = time.time() + 2.0
    procs = [subprocess.Popen(
        [sys.executable, "-c", _ASSIGN, db, f"inv-{i}", str(start)],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE, text=True)
        for i in range(6)]
    ids = sorted(int(p.communicate(timeout=60)[0].split()[-1])
                 for p in procs)
    assert ids == list(range(6))


# -- the three processes ----------------------------------------------------
def _http(method, url, body=None, timeout=20.0):
    req = urllib.request.Request(
        url, method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Authorization": AUTH, "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.mark.parametrize("balancer,peers", [
    ("tpu", "openwhisk_tpu_torch"), ("sharding", "openwhisk_tpu_torch"),
    ("tpu", "openwhisk_tpu")])
def test_broker_invoker_and_controller_processes(balancer, peers, tmp_path):
    """Three OS processes on localhost: the broker, one invoker (python:3
    sandboxes) and the port's controller; one blocking invoke answers 200
    with its echo. `peers` names the package of the broker and the
    invoker: the port's, or the JAX package's (the two packages' processes
    on one wire). The invoker runs under `-X importtime`: the port's
    imports no torch."""
    deadline = time.monotonic() + 60.0
    bus, api = _free_port(), _free_port()
    db = str(tmp_path / "whisks.db")
    procs = []

    def start(name, *argv):
        log = open(tmp_path / f"{name}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, *argv], cwd=ROOT, env=_env(), stdout=log,
            stderr=subprocess.STDOUT), log))

    try:
        start("broker", "-m", f"{peers}.messaging", "--port", str(bus))
        start("invoker", "-X", "importtime", "-m",
              f"{peers}.invoker", "--bus", f"127.0.0.1:{bus}",
              "--db", db, "--unique-name", "test-a", "--memory", "1024")
        start("controller", "-m", "openwhisk_tpu_torch.controller",
              "--bus", f"127.0.0.1:{bus}", "--db", db, "--port", str(api),
              "--balancer", balancer, "--seed-guest",
              *(["--device", "cpu"] if balancer == "tpu" else []))
        base = f"http://127.0.0.1:{api}"
        up = None
        while time.monotonic() < deadline:
            try:
                status, up = _http("GET", f"{base}/invokers", timeout=2.0)
                if status == 200 and up.get("invoker0") == "up":
                    break
            except OSError:
                pass
            time.sleep(0.25)
        assert up and up.get("invoker0") == "up", up
        assert up["cluster/size"] == 1
        code = "def main(a):\n    return {'via': 'distributed', 'n': a.get('n')}"
        status, _ = _http("PUT", f"{base}/api/v1/namespaces/_/actions/dhello",
                          {"exec": {"kind": "python:3", "code": code}})
        assert status == 200
        status, body = _http(
            "POST", f"{base}/api/v1/namespaces/_/actions/dhello"
            "?blocking=true&result=true", {"n": 42},
            timeout=max(1.0, deadline - time.monotonic()))
        assert (status, body) == (200, {"via": "distributed", "n": 42})
        status, ready = _http("GET", f"{base}/admin/ready")
        assert status == 200 and ready["cluster_size"] == 1
        status, prof = _http("GET", f"{base}/admin/profile/kernel")
        # the plain torch placement on the CPU, or the sharding policy
        assert status == 200
        assert prof["kernel"] == {"tpu": "torch", "sharding": "cpu"}[balancer]
    finally:
        for p, _log in reversed(procs):
            p.send_signal(signal.SIGTERM)
        rcs = []
        for p, log in reversed(procs):
            try:
                rcs.append(p.wait(timeout=15))
            except subprocess.TimeoutExpired:
                p.kill()
                rcs.append(p.wait())
            log.close()
    assert rcs == [0, 0, 0]  # SIGTERM runs each main's clean shutdown
    imported = [ln.rsplit("|", 1)[-1].strip() for ln in
                (tmp_path / "invoker.log").read_text().splitlines()
                if ln.startswith("import time:")]
    assert f"{peers}.invoker.reactive" in imported
    assert not [m for m in imported if m.split(".")[0] in
                ({"torch", "jax", "openwhisk_tpu", "openwhisk_tpu_torch"}
                 - {peers})]


def _cli(*argv, **env):
    return subprocess.run([sys.executable, "-m", *argv], cwd=ROOT,
                          env=_env(**env), capture_output=True, text=True,
                          timeout=60)


def test_controller_without_a_card_exits_unless_asked_for_the_cpu(tmp_path):
    out = _cli("openwhisk_tpu_torch.controller", "--db",
               str(tmp_path / "w.db"), "--port", str(_free_port()),
               "--bus", "127.0.0.1:1")
    assert out.returncode == 1
    assert "no CUDA device is available" in out.stderr
    assert "up on" not in out.stdout


_ACCEPTS = """
import asyncio, sys
import openwhisk_tpu_torch.controller.__main__ as M
def run(coro):
    frame = coro.cr_frame
    print("ARGS", sorted(vars(frame.f_locals["args"]).items()))
    coro.close()
M.asyncio.run = run
sys.argv = ["controller"] + sys.argv[1:]
M.main()
import torch
print("CUDA_INITIALIZED", torch.cuda.is_initialized())
"""


@pytest.mark.parametrize("argv,named", [
    (["--ha"], "--ha"),
    (["--role", "frontend"], "--role frontend"),
    (["--role", "balancer"], "--role balancer"),
    (["--funnel-to", "1"], "--funnel-to"),
    (["--funnel-depth", "64"], "--funnel-depth"),
])
def test_unported_roles_are_refused_by_name(argv, named, tmp_path):
    """The flags the multi-process slice once refused by name are ported:
    each parses and reaches the boot (`asyncio.run` stubbed) with nothing
    refused; a frontend needs no `--device` and no card, a placing role
    still does."""
    device = [] if argv[:2] == ["--role", "frontend"] else ["--device",
                                                            "cpu"]
    out = subprocess.run(
        [sys.executable, "-c", _ACCEPTS, "--db", str(tmp_path / "w.db"),
         *device, *argv], cwd=ROOT, env=_env(), capture_output=True,
        text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "not ported" not in out.stderr + out.stdout
    args = dict(ast.literal_eval(out.stdout.split("ARGS ", 1)[1]
                                 .splitlines()[0]))
    flag = named.split()[0].lstrip("-").replace("-", "_")
    assert args[flag] == (True if flag == "ha" else
                          named.split()[1] if flag == "role" else
                          int(argv[1]))
    assert "CUDA_INITIALIZED False" in out.stdout


# -- import closures ----------------------------------------------------------
NEW_MODULES = [
    "openwhisk_tpu_torch.spi", "openwhisk_tpu_torch.messaging.tcp",
    "openwhisk_tpu_torch.messaging.__main__",
    "openwhisk_tpu_torch.invoker.id_assigner",
    "openwhisk_tpu_torch.invoker.server",
    "openwhisk_tpu_torch.invoker.__main__",
    "openwhisk_tpu_torch.models.sharding_policy",
    "openwhisk_tpu_torch.controller.loadbalancer.sharding_balancer",
    "openwhisk_tpu_torch.controller.loadbalancer.lean",
    "openwhisk_tpu_torch.controller.loadbalancer.membership",
    "openwhisk_tpu_torch.controller.__main__",
    "openwhisk_tpu_torch.utils.partitions",
    "openwhisk_tpu_torch.controller.loadbalancer.partitions",
    "openwhisk_tpu_torch.controller.loadbalancer.funnel",
    "openwhisk_tpu_torch.controller.loadbalancer.spillover",
    "openwhisk_tpu_torch.edge", "openwhisk_tpu_torch.edge.__main__",
    "openwhisk_tpu_torch.edge.proxy",
    "openwhisk_tpu_torch.database.remote_store",
    "openwhisk_tpu_torch.database.couchdb_store",
    "openwhisk_tpu_torch.database.cosmosdb_store",
    "openwhisk_tpu_torch.database.s3_attachment_store",
    "openwhisk_tpu_torch.database.file_activation_store",
    "openwhisk_tpu_torch.containerpool.docker_factory",
    "openwhisk_tpu_torch.containerpool.kubernetes_factory",
    "openwhisk_tpu_torch.containerpool.yarn_factory",
    "openwhisk_tpu_torch.containerpool.mesos_factory",
    "openwhisk_tpu_torch.messaging.kafka",
    "openwhisk_tpu_torch.tools.deploy", "openwhisk_tpu_torch.tools.wsk",
    "openwhisk_tpu_torch.tools.wskadmin"]


def _closure(mods, also=""):
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n" + also +
            "print(sorted({k.split('.')[0] for k in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return set(ast.literal_eval(out.stdout.splitlines()[-1]))


def test_new_modules_import_neither_jax_nor_the_jax_package():
    roots = _closure(NEW_MODULES)
    assert "torch" in roots  # the controller's balancers
    assert not roots & {"jax", "jaxlib", "openwhisk_tpu"}


def test_the_invoker_process_imports_no_torch():
    """What the invoker main and its run() load, with the container
    factory resolved through the SPI: no torch (an invoker process must
    not start a CUDA context), no jax."""
    also = ("from openwhisk_tpu_torch import spi\n"
            "spi.get('ContainerFactoryProvider')\n"
            "spi.get('InvokerServerProvider')\n"
            "import openwhisk_tpu_torch.utils.tracing, "
            "openwhisk_tpu_torch.utils.eventlog, "
            "openwhisk_tpu_torch.utils.hostprof\n")
    roots = _closure(["openwhisk_tpu_torch.invoker.__main__",
                      "openwhisk_tpu_torch.messaging.__main__"], also)
    assert "openwhisk_tpu_torch" in roots
    assert not roots & {"torch", "jax", "jaxlib", "openwhisk_tpu"}


# -- the copies -----------------------------------------------------------------
def code_lines(src):
    """The source's code, line by line: comments cut, docstrings and blank
    lines dropped."""
    doc_lines = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if (isinstance(first, ast.Expr)
                    and isinstance(first.value, ast.Constant)
                    and isinstance(first.value.value, str)):
                doc_lines.update(range(first.lineno, first.end_lineno + 1))
    lines = src.splitlines()
    for tok in tokenize.generate_tokens(io.StringIO(src).readline):
        if tok.type == tokenize.COMMENT:
            row, col = tok.start
            lines[row - 1] = lines[row - 1][:col]
    return [ln.rstrip() for i, ln in enumerate(lines, 1)
            if i not in doc_lines and ln.strip()]


#: module -> its named cuts: (name, first text of the reference's span,
#: last text of the span or None for the first text alone, what the port
#: has there). Every other code line is the reference's.
CUTS = {
    "messaging/tcp.py": [
        ("logger name", 'getLogger("openwhisk_tpu.messaging.tcp")', None,
         'getLogger("openwhisk_tpu_torch.messaging.tcp")')],
    "messaging/__main__.py": [],
    "spi.py": [
        ("defaults name the port's modules", '    "AttachmentStoreProvider": '
         '"openwhisk_tpu.', '"openwhisk_tpu.invoker.server:'
         'DefaultInvokerServerProvider",\n', None),
        ("refuse the JAX package", '        raise SpiResolutionError(f"invalid'
         ' SPI path {path!r} (want \'module:Attr\')")\n', None,
         '        raise SpiResolutionError(f"invalid SPI path {path!r} (want '
         '\'module:Attr\')")\n'
         '    if mod == "openwhisk_tpu" or mod.startswith("openwhisk_tpu."):\n'
         '        raise SpiResolutionError(\n'
         '            f"SPI impl {path!r} lies in the JAX package openwhisk_tpu; "\n'
         '            "openwhisk_tpu_torch loads only its own modules (name the "\n'
         '            "openwhisk_tpu_torch counterpart, if it is ported)")\n')],
    "invoker/id_assigner.py": [],
    "invoker/server.py": [],
    "invoker/__main__.py": [],
    "models/sharding_policy.py": [],
    "controller/loadbalancer/sharding_balancer.py": [],
    "controller/loadbalancer/lean.py": [],
    "controller/loadbalancer/membership.py": [],
    "controller/loadbalancer/__init__.py": [],
    "controller/__main__.py": [
        ("import sys", "import asyncio\n", None,
         "import asyncio\nimport sys\n"),
        ("no JAX platform hook",
         "from ..utils.config import config_from_env, "
         "honor_jax_platforms_env\n", None,
         "from ..utils.config import config_from_env\n"),
        ("no JAX platform hook call",
         "def main() -> None:\n    honor_jax_platforms_env()\n", None,
         "def main() -> None:\n"),
        ("--device", '    parser.add_argument("--balancer", choices=("tpu", '
         '"sharding"), default="tpu")\n', None,
         '    parser.add_argument("--balancer", choices=("tpu", "sharding"), '
         'default="tpu")\n'
         '    parser.add_argument("--device", choices=("cuda", "cpu"), '
         'default=None,\n'
         '                        help="where the TPU balancer places: the '
         'CUDA card "\n'
         '                             "(default) or the plain torch path on '
         'the CPU")\n'),
        ("the role's help text", '"multi-process deployment role (', '): "',
         '"multi-process deployment role: "'),
        ("a placing role needs the card unless --device cpu",
         "    args = parser.parse_args()\n", None,
         "    args = parser.parse_args()\n"
         '    if args.balancer == "tpu" and args.role != "frontend":\n'
         "        from ..ops.placement import resolve_device\n"
         "        try:\n"
         '            resolve_device(None if args.device == "cuda" else '
         "args.device)\n"
         "        except RuntimeError as e:\n"
         '            print(f"error: {e}", file=sys.stderr)\n'
         "            raise SystemExit(1)\n"),
        ("the card unless --device cpu",
         "                                 rate_limit_per_minute="
         "args.balancer_rate_limit)\n", None,
         "                                 rate_limit_per_minute="
         "args.balancer_rate_limit,\n"
         "                                 device=args.device)\n"),
        ("the device in the boot line",
         '                  + (", role=balancer" if args.role == "balancer"\n'
         '                     else "") + ")", flush=True)\n', None,
         '                  + (", role=balancer" if args.role == "balancer"\n'
         '                     else "")\n'
         '                  + (f", device={lb.device}" if args.balancer == '
         '"tpu"\n'
         '                     else "") + ")", flush=True)\n')],
    "utils/partitions.py": [],
    "controller/loadbalancer/partitions.py": [],
    "controller/loadbalancer/funnel.py": [],
    "controller/loadbalancer/spillover.py": [],
    "edge/__init__.py": [],
    "edge/__main__.py": [],
    "edge/proxy.py": [],
    "controller/fleet.py": [],
    "controller/monitoring.py": [],
    "controller/core.py": [],
    "controller/api.py": [],
    "database/__init__.py": [],
    "database/remote_store.py": [],
    "database/couchdb_store.py": [],
    "database/cosmosdb_store.py": [],
    "database/s3_attachment_store.py": [],
    "database/file_activation_store.py": [],
    "containerpool/__init__.py": [],
    "containerpool/factory.py": [
        ("providers name the port's modules",
         '    "process": "openwhisk_tpu.', 'MesosContainerFactoryProvider",\n',
         None)],
    "containerpool/proxy.py": [
        ("the pause and the resume in flight",
         "        self._destroyed = False\n", None,
         "        self._suspending: Optional[asyncio.Task] = None\n"
         "        self._resuming: Optional[asyncio.Future] = None\n"
         "        self._destroyed = False\n"),
        ("one resume for the runs that meet one pause, after it",
         "            try:\n                await self.container.resume()\n",
         None,
         "            try:\n"
         "                if self._resuming is None:\n"
         "                    self._resuming = asyncio.ensure_future("
         "self._resume())\n"
         "                await asyncio.shield(self._resuming)\n"),
        ("the resume waits for the pause in flight",
         "    # -- shared run pipeline", None,
         "    async def _resume(self) -> None:\n"
         "        if self._suspending is not None and not "
         "self._suspending.done():\n"
         "            await asyncio.wait([self._suspending])\n"
         "        await self.container.resume()\n"
         "    # -- shared run pipeline"),
        ("a run no longer cancels the pause in flight",
         "                self.state = PAUSING\n", None,
         "                self.state = PAUSING\n"
         "                self._pause_task, self._resuming = None, None\n"
         "                self._suspending = asyncio.current_task()\n")],
    "containerpool/docker_factory.py": [],
    "containerpool/kubernetes_factory.py": [],
    "containerpool/yarn_factory.py": [],
    "containerpool/mesos_factory.py": [],
    "messaging/kafka.py": [
        ("the error names the port's TCP bus",
         '"(need aiokafka). Use the TCP bus (openwhisk_tpu.messaging.tcp) "',
         None, '"(need aiokafka). Use the TCP bus '
         '(openwhisk_tpu_torch.messaging.tcp) "')],
    "tools/wsk.py": [],
    "tools/wskadmin.py": [],
    "tools/deploy.py": [
        ("services name the port's modules",
         '        "argv": [python, "-m", "openwhisk_tpu.messaging",',
         '        argv = [python, "-m", "openwhisk_tpu.edge",', None),
        ("controllers.device becomes --device",
         '                "--balancer", inv["controllers"].get("balancer", '
         '"tpu")]\n', None,
         '                "--balancer", inv["controllers"].get("balancer", '
         '"tpu")]\n'
         '        device = inv["controllers"].get("device")\n'
         '        if device is not None:\n'
         '            if device not in ("cuda", "cpu"):\n'
         '                raise ValueError(f"controllers.device must be cuda '
         'or cpu, "\n'
         '                                 f"got {device!r}")\n'
         '            argv += ["--device", device]\n')],
    "controller/loadbalancer/quality.py": [
        ("the accumulator read on the host",
         "                                     QualityState, "
         "init_quality_state,\n"
         "                                     make_quality_step)\n", None,
         "                                     QualityState, host_state,\n"
         "                                     init_quality_state, "
         "make_quality_step)\n"),
        ("use_device allocates on the balancer's device",
         "    def use_device(self, n_pad: int, transposed: bool = False) "
         "-> None:\n", None,
         "    def use_device(self, n_pad: int, transposed: bool = False,\n"
         "                   device=None) -> None:\n"),
        ("the accumulator on that device",
         "        self._qstate = init_quality_state(max(1, n_pad), "
         "self.n_buckets)\n", None,
         "        self._qstate = init_quality_state(max(1, n_pad), "
         "self.n_buckets,\n"
         "                                          device=device)\n"),
        ("counts reads the tensors on the host",
         "        qs = self._qstate\n        if not self.enabled or qs is "
         "None:\n            return None\n", None,
         "        qs = host_state(self._qstate)\n        if not self.enabled "
         "or qs is None:\n            return None\n")],
}


def _apply(src, cuts):
    for name, start, end, new in cuts:
        assert src.count(start) >= 1, name
        i = src.index(start)
        if end is None:
            j = i + len(start)
        else:
            j = src.index(end, i + len(start)) + len(end)
        if new is None:  # a rename across the span
            new = src[i:j].replace('"openwhisk_tpu.', '"openwhisk_tpu_torch.')
        src = src[:i] + new + src[j:]
    return src


@pytest.mark.parametrize("rel", sorted(CUTS))
def test_copied_modules_are_copies_outside_their_named_cuts(rel):
    ref = (ROOT / "openwhisk_tpu" / rel).read_text()
    port = (ROOT / "openwhisk_tpu_torch" / rel).read_text()
    assert code_lines(port) == code_lines(_apply(ref, CUTS[rel]))
    doc = ast.get_docstring(ast.parse(port))
    if ast.get_docstring(ast.parse(ref)) is not None:
        assert f"A copy of `openwhisk_tpu/{rel}`" in doc


#: every module of the port, and the chip smoke script
PORT_SOURCES = sorted(
    str(p.relative_to(ROOT)) for p in
    (ROOT / "openwhisk_tpu_torch").rglob("*.py")) + ["chip_smoke.py"]
FORBIDDEN_ROOTS = {"jax", "jaxlib", "openwhisk_tpu", "tools", "loadgen"}


@pytest.mark.parametrize("rel", PORT_SOURCES)
def test_no_module_of_the_port_imports_jax_or_the_jax_package(rel):
    """Every import statement of the file, at module level or inside a
    function: none names jax, the JAX package or the repository's
    `tools/` (its load generator)."""
    tree = ast.parse((ROOT / rel).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.append(node.args[0].value)
    bad = [n for n in names if n.split(".")[0] in FORBIDDEN_ROOTS]
    assert not bad, bad
