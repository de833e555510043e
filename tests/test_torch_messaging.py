"""The port's bus messages against the JAX package's, byte for byte.

Each message kind — activation, completion, result, combined and ping — is
built from the same seeded fields with each package's own classes; both
serialize to the same bytes, and each package parses the other's bytes
back into a message that serializes to those bytes again (tolerance: none,
the comparison is of bytes). The in-memory bus carries messages through a
`MessageFeed` in order, with backpressure.
"""
import asyncio
import subprocess
import sys
import types

import pytest

from openwhisk_tpu.core import entity as JE
from openwhisk_tpu.messaging import memory as JMM
from openwhisk_tpu.messaging import message as JM
from openwhisk_tpu.utils import transaction as JX
from openwhisk_tpu_torch.core import entity as TE
from openwhisk_tpu_torch.messaging import connector as TC
from openwhisk_tpu_torch.messaging import memory as TMM
from openwhisk_tpu_torch.messaging import message as TM
from openwhisk_tpu_torch.utils import transaction as TX

JAX_PKG = types.SimpleNamespace(E=JE, M=JM, X=JX)
PORT_PKG = types.SimpleNamespace(E=TE, M=TM, X=TX)
KINDS = ("activation", "completion", "result", "combined", "ping")
#: a fixed identity, as the JSON both packages read
IDENTITY = {
    "subject": "guest-user",
    "namespace": {"name": "guest",
                  "uuid": "23bc46b1-71f6-4ed5-8c54-816aa4f8c502"},
    "authkey": {"api_key": "23bc46b1-71f6-4ed5-8c54-816aa4f8c502:"
                           "123zO3xZCLrMN6v2BKK1dXYFpXlPkccOFqm12CdAsMgRU4VrN"
                           "ZqlyOIIfy7G4wFJ"},
    "rights": ["ACTIVATE", "DELETE", "PUT", "READ"],
    "limits": {},
}


def build(pkg, kind, seed):
    """One message of `kind` from seeded fields, with `pkg`'s classes."""
    E, M, X = pkg.E, pkg.M, pkg.X
    tid = X.TransactionId(f"tid_{seed}", start_wallclock=1.7e9 + seed / 7)
    aid = E.ActivationId(f"{seed:032x}")
    inv = E.InvokerInstanceId(seed % 5, unique_name=f"u{seed}",
                              user_memory=E.MB(1024 * (1 + seed % 3)))
    ident = E.Identity.from_json(IDENTITY)
    if kind == "ping":
        return M.PingMessage(inv, admin=None if seed % 2
                             else f"http://10.0.0.{seed}:8080")
    if kind == "activation":
        return M.ActivationMessage(
            tid, E.FullyQualifiedEntityName.parse(f"guest/pkg/act{seed}"),
            "1-abc", ident, aid, E.ControllerInstanceId(str(seed % 3)),
            bool(seed % 2), {"n": seed, "s": "x" * (seed % 4)},
            init_args={"k": seed} if seed % 3 else None,
            cause=E.ActivationId(f"{seed + 1:032x}") if seed % 2 else None,
            trace_context={"traceparent": f"00-{seed:032x}-01"}
            if seed % 4 == 0 else None)
    if kind == "completion":
        ack = M.CompletionMessage(tid, aid, bool(seed % 2), inv)
    else:
        resp = (E.ActivationResponse.success({"ok": seed}) if seed % 3
                else E.ActivationResponse.whisk_error("boom"))
        act = E.WhiskActivation(
            E.EntityPath("guest"), E.EntityName(f"act{seed}"),
            ident.subject, aid, 1.7e9 + seed, 1.7e9 + seed + 0.25, resp,
            logs=[f"line {i}" for i in range(seed % 3)], duration=seed)
        act.updated = 1.7e9 + 2 * seed
        ack = (M.ResultMessage(tid, act) if kind == "result"
               else M.CombinedCompletionAndResultMessage(tid, act, inv))
    if seed % 4 == 1:
        ack.trace_context = {"traceparent": f"00-{seed:032x}-02"}
    return ack


def parse(pkg, kind, raw, like):
    """`raw` parsed by `pkg`; a result's `updated` stamp (set at parse
    time, not carried on the wire) is restored from `like`."""
    M = pkg.M
    if kind == "ping":
        return M.PingMessage.parse(raw)
    if kind == "activation":
        return M.ActivationMessage.parse(raw)
    ack = M.parse_ack(raw)
    if ack.activation is not None:
        ack.activation.updated = like.activation.updated
    return ack


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", range(6))
def test_both_packages_write_the_same_bytes(kind, seed):
    port, ref = build(PORT_PKG, kind, seed), build(JAX_PKG, kind, seed)
    assert port.serialize() == ref.serialize()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_each_package_reads_the_others_bytes(kind, seed, direction):
    src, dst = ((PORT_PKG, JAX_PKG) if direction == "port_to_jax"
                else (JAX_PKG, PORT_PKG))
    msg = build(src, kind, seed)
    raw = msg.serialize()
    back = parse(dst, kind, raw, msg)
    assert back.serialize() == raw
    if kind not in ("activation", "ping"):
        assert back.is_slot_free == msg.is_slot_free
        assert back.kind == msg.kind


def test_corrupt_ack_kinds_raise_value_error():
    raw = build(PORT_PKG, "result", 1).serialize().replace(
        b'"kind":"result"', b'"kind":"other"')
    with pytest.raises(ValueError):
        TM.parse_ack(raw)
    raw = build(PORT_PKG, "combined", 1).serialize()
    raw = raw[:raw.index(b'"response":')] + b'"response":null}'
    with pytest.raises(ValueError):
        TM.parse_ack(raw)


def test_memory_bus_round_trip_through_a_feed():
    """60 messages to one topic reach a MessageFeed handler in order; the
    feed holds at most its capacity in the handler (backpressure) and
    resumes as the handler reports each one processed."""
    async def go():
        provider = TMM.MemoryMessagingProvider()
        provider.ensure_topic("invoker3")
        producer = provider.get_producer()
        sent = [build(PORT_PKG, "activation", s) for s in range(60)]
        # produced before the consumer exists: a queue-semantics group
        # adopts the backlog
        for m in sent[:20]:
            await producer.send("invoker3", m)
        consumer = provider.get_consumer("invoker3", "invoker3")
        got, in_handler, peak = [], [0], [0]
        box = {}

        async def handle(payload):
            in_handler[0] += 1
            peak[0] = max(peak[0], in_handler[0])
            got.append(TM.ActivationMessage.parse(payload))

            async def finish():
                await asyncio.sleep(0.001)
                in_handler[0] -= 1
                box["feed"].processed()
            asyncio.get_event_loop().create_task(finish())

        feed = box["feed"] = TC.MessageFeed("t", consumer, 8, handle,
                                            long_poll_timeout=0.05)
        feed.start()
        for m in sent[20:]:
            await producer.send("invoker3", m)
        for _ in range(200):
            if len(got) == len(sent):
                break
            await asyncio.sleep(0.01)
        await feed.stop()
        assert producer.sent_count == 60
        return sent, got, peak[0]

    sent, got, peak = asyncio.run(asyncio.wait_for(go(), 10))
    assert [m.serialize() for m in got] == [m.serialize() for m in sent]
    assert peak <= 8


def test_port_bus_carries_jax_written_bytes():
    """A JAX-package producer's payload, moved as bytes over the port's
    bus, parses in the port (and the JAX bus carries the port's)."""
    async def go():
        out = []
        for prod_pkg, bus, parse_pkg in ((JAX_PKG, TMM, PORT_PKG),
                                         (PORT_PKG, JMM, JAX_PKG)):
            provider = bus.MemoryMessagingProvider()
            consumer = provider.get_consumer("completed0", "g")
            msg = build(prod_pkg, "combined", 5)
            await provider.get_producer().send("completed0",
                                               msg.serialize())
            (_, _, _, raw), = await consumer.peek(4, timeout=1.0)
            out.append((msg, parse(parse_pkg, "combined", raw, msg)))
        return out

    for msg, back in asyncio.run(go()):
        assert back.serialize() == msg.serialize()


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of openwhisk_tpu_torch, and chip_smoke.py, imports in
    a fresh interpreter without jax or any openwhisk_tpu module landing in
    sys.modules."""
    code = (
        "import pkgutil, sys, importlib\n"
        "import openwhisk_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__,"
        " p.__name__ + '.')]\n"
        "for m in mods + ['chip_smoke']: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or"
        " k.startswith('jax.') or k == 'openwhisk_tpu' or"
        " k.startswith('openwhisk_tpu.'))\n"
        "assert len(mods) > 20, mods\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
