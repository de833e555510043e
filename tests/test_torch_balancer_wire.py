"""The port's balancer, invoker and wire modules with the host planes on,
against the JAX package's.

- The parity scenario of test_torch_balancer_front (waves, a trickle,
  growth, an unhealthy invoker, acks after every wave), with its acks
  sent as one `send_batch` a round on the coalescing producer an invoker
  uses: the port's `TpuBalancer` and the JAX one place every activation
  alike and end with the same books, with every switch at its default,
  with `batchedAck` off and with coalescing off; their flight recorders
  file the same decisions with the same digests (clocks and the kernel's
  name left out) and `explain` the same rows.
- The in-process invoker's batch pickup (`_process_batch`) answers a
  columnar activation frame with the same acks as the JAX invoker's.
- The modules the port keeps as copies are copies: the same code line for
  line (comments and docstrings aside), and no module of the port loads
  jax or the JAX package.
"""
import ast
import asyncio
import io
import pathlib
import subprocess
import sys
import tokenize

import numpy as np
import pytest

from test_torch_balancer_front import (RATE, _jax_package, _port_package,
                                       _scenario, run)
from test_torch_messaging import JAX_PKG, PORT_PKG, build

ROOT = pathlib.Path(__file__).resolve().parent.parent

#: the switches of the planes this slice ports, each run off alone
SWITCHES = {
    "defaults": {},
    "batched_ack_off": {"CONFIG_whisk_loadBalancer_batchedAck_enabled":
                        "false"},
    "coalescing_off": {"CONFIG_whisk_bus_coalesce_enabled": "false"},
}
#: digest fields that depend on the clock or name the backend
VOLATILE_DIGEST = {"kernel", "oldest_age_ms"}


def _coalescing(pkg_name):
    mod = __import__(f"{pkg_name}.messaging.coalesce",
                     fromlist=["maybe_coalesce"])
    return lambda provider: mod.maybe_coalesce(provider.get_producer())


def _record_view(rec):
    digest = {k: v for k, v in rec["digest"].items()
              if k not in VOLATILE_DIGEST}
    digest.pop("repair_rounds", None)  # the JAX package notes it by kernel
    return digest, rec["decisions"]


@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_planes_keep_placement_parity(switch, monkeypatch):
    for k, v in SWITCHES[switch].items():
        monkeypatch.setenv(k, v)
    jax_pkg, port_pkg = _jax_package(), _port_package()
    for pkg in (jax_pkg, port_pkg):  # deployments opt in to max_conc > 1
        monkeypatch.setattr(pkg.E.ConcurrencyLimit, "MAX", 16)
    seed = 53
    port = run(_scenario(port_pkg, None, True, seed,
                         _coalescing("openwhisk_tpu_torch")), 90)
    ref = run(_scenario(jax_pkg, None, True, seed,
                        _coalescing("openwhisk_tpu")), 90)
    assert port["decisions"] == ref["decisions"]
    for k in ("n", "pad", "slots", "active"):
        assert port[k] == ref[k], k
    for k in ("free", "conc", "health"):
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    assert port["active"] == 0 and not port["conc"].any()
    assert [_record_view(r) for r in port["records"]] == \
        [_record_view(r) for r in ref["records"]]
    assert port["records"] and all(r["timings"] for r in port["records"])
    assert port["explain"] == ref["explain"]
    assert all(v is not None for v in port["explain"].values())


def test_rate_admission_keeps_parity_with_acks_in_frames(monkeypatch):
    jax_pkg, port_pkg = _jax_package(), _port_package()
    for pkg in (jax_pkg, port_pkg):
        monkeypatch.setattr(pkg.E.ConcurrencyLimit, "MAX", 16)
    port = run(_scenario(port_pkg, RATE, False, 59,
                         _coalescing("openwhisk_tpu_torch")), 90)
    ref = run(_scenario(jax_pkg, RATE, False, 59,
                        _coalescing("openwhisk_tpu")), 90)
    assert port["decisions"] == ref["decisions"]
    assert port["throttled"] == ref["throttled"] > 0
    for k in ("free", "conc", "health"):
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)


# -- the invoker's batch pickup ---------------------------------------------
async def _invoker_answers(pkg_name, frame_kind):
    """One package's InvokerReactive handed one columnar frame of seeded
    activations for actions it does not have: the acks it sends."""
    import importlib
    pkg = importlib.import_module(pkg_name)
    for sub in ("invoker.reactive", "database", "messaging.memory",
                "messaging.columnar", "messaging.connector", "core.entity"):
        importlib.import_module(f"{pkg_name}.{sub}")
    E, db = pkg.core.entity, pkg.database
    col, cn = pkg.messaging.columnar, pkg.messaging.connector
    side = JAX_PKG if pkg_name == "openwhisk_tpu" else PORT_PKG
    provider = pkg.messaging.memory.MemoryMessagingProvider()
    store = db.MemoryArtifactStore()
    inv = pkg.invoker.reactive.InvokerReactive(
        E.InvokerInstanceId(0, user_memory=E.MB(1024)), provider,
        db.EntityStore(store), db.ArtifactActivationStore(store),
        container_factory=None)
    msgs = [build(side, "activation", s) for s in (3, 5, 8, 13, 21)]
    for m in msgs:
        m.root_controller_index = E.ControllerInstanceId("0")
    payload, _ = cn.encode_batch(col.KIND_ACTIVATION, msgs)
    if frame_kind == "corrupt":
        payload = payload[:-9]

    class Feed:
        processed_n = extra = 0

        def processed(self):
            Feed.processed_n += 1

        def consume_extra(self, n):
            Feed.extra += n

    consumer = provider.get_consumer(
        "completed" + E.ControllerInstanceId("0").as_string, "test")
    await inv._process_batch(payload, Feed())
    await inv.producer.close()
    got = await consumer.peek(100, timeout=0.2)
    acks = []
    for *_x, raw in got:
        if col.is_batch_payload(raw):
            acks.extend(col.parse_batch(raw)[1])
        else:
            acks.append(pkg.messaging.message.parse_ack(raw))
    rows = []
    for a in acks:
        act = a.activation
        rows.append((a.activation_id.asString, a.is_system_error,
                     None if act is None else act.response.to_json(),
                     None if act is None else str(act.name)))
    return rows, Feed.processed_n, Feed.extra


@pytest.mark.parametrize("frame_kind", ["frame", "corrupt"])
def test_invoker_batch_pickup_answers_as_the_jax_invoker(frame_kind):
    port = run(_invoker_answers("openwhisk_tpu_torch", frame_kind))
    jax = run(_invoker_answers("openwhisk_tpu", frame_kind))
    assert port == jax
    rows, processed, extra = port
    if frame_kind == "frame":
        # five activations: the frame's extra capacity booked, each one
        # released, each answered with the missing-action error
        assert extra == 4 and processed == 5 and len(rows) == 5
        assert all(r[1] is True and "does not exist" in str(r[2])
                   for r in rows)
    else:
        assert rows == [] and processed == 1 and extra == 0


# -- copies and the import closure -------------------------------------------
#: modules the port keeps as copies of the JAX package's
COPIES = ("utils/hostprof.py", "messaging/columnar.py",
          "messaging/coalesce.py", "controller/loadbalancer/flight_recorder.py",
          "utils/tracestore.py", "utils/blackbox.py", "messaging/connector.py",
          "messaging/memory.py", "invoker/reactive.py")


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


@pytest.mark.parametrize("rel", COPIES)
def test_copied_modules_are_copies(rel):
    ref = (ROOT / "openwhisk_tpu" / rel).read_text()
    port = (ROOT / "openwhisk_tpu_torch" / rel).read_text()
    assert code_lines(port) == code_lines(ref)
    head = port.partition("\n\n")[0]
    assert f"A copy of `openwhisk_tpu/{rel}`." in head
    # the docstring's first paragraph is the only one that names the copy
    assert head.replace(f"\nA copy of `openwhisk_tpu/{rel}`.", "") == \
        ref.partition("\n\n")[0]


def test_new_modules_import_neither_jax_nor_the_jax_package():
    mods = ["openwhisk_tpu_torch." + r[:-3].replace("/", ".")
            for r in COPIES] + [
        "openwhisk_tpu_torch.controller.loadbalancer.base",
        "openwhisk_tpu_torch.controller.loadbalancer.tpu_balancer",
        "openwhisk_tpu_torch.controller.core",
        "openwhisk_tpu_torch.controller.api"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or"
        " k.startswith('jax.') or k == 'openwhisk_tpu' or"
        " k.startswith('openwhisk_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
