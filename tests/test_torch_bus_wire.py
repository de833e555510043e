"""The port's bus wire against the JAX package's: columnar batch frames and
the coalescing producer.

Frames: activation batches, ack batches (the eager record and the lazy
`ackL` frame, whose responses ride as opaque bytes after the first raw
newline) and the admission funnel's frames, built from the same seeded
messages with each package's classes, are the same bytes; each package
decodes the other's frame into messages with the same fields as the ones
that went in (tolerance: none, bytes and JSON fields compared exactly;
an activation record's `updated` stamp is not on the wire and is left
out). The producer: with the batch wire off every payload is the serial
path's bytes, with coalescing off `maybe_coalesce` hands back the raw
producer, order within a topic is arrival order, a failed flush fails
every waiter of its group, and a cancelled drainer cancels its waiters.
"""
import asyncio
import json

import numpy as np
import pytest

from openwhisk_tpu.messaging import coalesce as JCO
from openwhisk_tpu.messaging import columnar as JCOL
from openwhisk_tpu_torch.messaging import coalesce as TCO
from openwhisk_tpu_torch.messaging import columnar as TCOL
from openwhisk_tpu_torch.messaging import memory as TMM
from openwhisk_tpu_torch.utils import microbatch as TMB
from test_torch_messaging import JAX_PKG, PORT_PKG, build

JAX = (JAX_PKG, JCOL, JCO)
PORT = (PORT_PKG, TCOL, TCO)
FRAMES = ("activation", "ack", "ack_lazy", "funnel", "funnel_ack")
ACK_KINDS = ("completion", "result", "combined")


def _seeds(seed):
    rng = np.random.RandomState(seed)
    return [int(s) for s in rng.randint(0, 1000, int(rng.randint(2, 9)))]


def frame_message(side, kind, seed):
    """One batch record of `kind` from seeded messages, with `side`'s
    classes."""
    pkg, col, _ = side
    seeds = _seeds(seed)
    if kind in ("activation", "funnel"):
        msgs = [build(pkg, "activation", s) for s in seeds]
        if kind == "activation":
            return col.ActivationBatchMessage(msgs)
        return col.FunnelBatchMessage(msgs, origin=seed % 3, seq=seed,
                                      epoch=seed % 2)
    if kind in ("ack", "ack_lazy"):
        msgs = [build(pkg, ACK_KINDS[s % 3], s) for s in seeds]
        return col.AckBatchMessage(msgs, lazy_results=kind == "ack_lazy")
    codes = (col.FUNNEL_PLACED, col.FUNNEL_REFUSED, col.FUNNEL_COMPLETED,
             col.FUNNEL_FORCED)
    rows = [col.FunnelOutcome(
        codes[s % 4], f"{s:032x}", err=bool(s % 2),
        exc=(col.FUNNEL_EXC_THROTTLE, f"throttled {s}") if s % 5 == 0
        else None,
        resp={"ok": s} if s % 3 == 0 else None) for s in seeds]
    return col.FunnelAckMessage(seed % 3, seed % 2, rows)


def _activation_json(act):
    if act is None:
        return None
    j = act.to_json()
    j.pop("updated", None)
    return j


#: an ack's kind by its class; the lazy frame decodes to the base class
#: with the kind in `.kind`
KIND_OF_CLASS = {"CompletionMessage": "completion",
                 "ResultMessage": "result",
                 "CombinedCompletionAndResultMessage": "combined"}


def _ack_fields(ack, invoker_json=True):
    kind = KIND_OF_CLASS.get(type(ack).__name__) or ack.kind
    inv = ack.invoker
    return (kind, ack.activation_id.asString,
            ack.transid.to_json(),
            None if inv is None else
            (inv.to_json() if invoker_json else inv.instance),
            bool(ack.is_system_error), ack.trace_context,
            _activation_json(ack.activation))


def decoded_fields(kind, decoded, invoker_json=True):
    """The decoded frame as plain data, for comparison across packages."""
    if kind == "funnel":
        return (decoded.origin, decoded.seq, decoded.epoch,
                [m.serialize() for m in decoded.msgs])
    if kind == "funnel_ack":
        return (decoded.origin, decoded.epoch,
                [(r.code, r.aid, r.err, r.exc and list(r.exc), r.resp)
                 for r in decoded.rows])
    if kind == "activation":
        return [m.serialize() for m in decoded]
    return [_ack_fields(a, invoker_json) for a in decoded]


def sent_fields(kind, message):
    """What went into a frame, as decoded_fields renders it (an ack's
    invoker by its instance: the frame's invoker table keeps one record an
    instance)."""
    if kind == "funnel":
        return (message.origin, message.seq, message.epoch,
                [m.serialize() for m in message.msgs])
    if kind == "funnel_ack":
        return (message.origin, message.epoch,
                [(r.code, r.aid, r.err, r.exc and list(r.exc), r.resp)
                 for r in message.rows])
    if kind == "activation":
        return [m.serialize() for m in message.msgs]
    return [_ack_fields(a, False) for a in message.msgs]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind", FRAMES)
def test_both_packages_write_the_same_frame(kind, seed):
    jax_raw = frame_message(JAX, kind, seed).serialize()
    port_raw = frame_message(PORT, kind, seed).serialize()
    assert port_raw == jax_raw
    assert JCOL.is_batch_payload(port_raw) and TCOL.is_batch_payload(jax_raw)
    if kind == "ack_lazy":
        header, _, body = port_raw.partition(b"\n")
        assert json.loads(header)["whiskBatch"] == "ackL" and body


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind", FRAMES)
def test_each_package_reads_the_others_frame(kind, seed, direction):
    src, dst = (JAX, PORT) if direction == "jax_to_port" else (PORT, JAX)
    message = frame_message(src, kind, seed)
    raw = message.serialize()
    got_kind, decoded = dst[1].parse_batch(raw)
    own_kind, own = src[1].parse_batch(raw)
    assert got_kind == own_kind == \
        json.loads(raw.partition(b"\n")[0])["whiskBatch"]
    assert decoded_fields(kind, decoded) == decoded_fields(kind, own)
    assert decoded_fields(kind, decoded, False) == sent_fields(kind, message)


def test_plain_messages_never_sniff_as_frames():
    for kind in ("activation", "completion", "result", "combined", "ping"):
        for seed in range(3):
            raw = build(PORT_PKG, kind, seed).serialize()
            assert not TCOL.is_batch_payload(raw)
            assert not JCOL.is_batch_payload(raw)


class _Spy:
    """A producer that records what each flush shipped."""

    def __init__(self, fail=None):
        self.shipped, self.fail = [], fail

    async def send_many(self, items):
        if self.fail is not None:
            raise self.fail
        self.shipped.append(list(items))

    async def close(self):
        pass


def _drive(co_mod, batch_wire, sends):
    """`sends` [(topic, message)] all submitted in one sweep through a
    CoalescingProducer over a spy; returns the (topic, payload) items it
    shipped."""
    async def go():
        spy = _Spy()
        prod = co_mod.CoalescingProducer(spy, max_batch=64,
                                         batch_wire=batch_wire)
        await asyncio.gather(*[prod.send(t, m) for t, m in sends])
        await prod.close()
        return [(t, p) for batch in spy.shipped for t, p, _m in batch]

    return asyncio.run(asyncio.wait_for(go(), 10))


def _mixed_sends(side, seed):
    pkg = side[0]
    return [(f"invoker{s % 2}", build(pkg, "activation", s))
            for s in _seeds(seed) * 2]


@pytest.mark.parametrize("seed", range(3))
def test_batch_wire_off_ships_the_serial_bytes(seed):
    """batchWire off: one payload a message, each the serial path's
    bytes, in both packages alike."""
    for side in (JAX, PORT):
        sends = _mixed_sends(side, seed)
        items = _drive(side[2], False, sends)
        assert [(t, p) for t, p in items] == \
            [(t, m.serialize()) for t, m in sends]
    assert _drive(JCO, False, _mixed_sends(JAX, seed)) == \
        _drive(TCO, False, _mixed_sends(PORT, seed))


@pytest.mark.parametrize("batch_wire", [True, False])
@pytest.mark.parametrize("seed", range(2))
def test_order_within_a_topic_is_arrival_order(seed, batch_wire):
    """Two topics interleaved: each topic's messages come out in the order
    they were sent, as one frame a topic or one payload each, and the
    two packages ship the same bytes."""
    sends = _mixed_sends(PORT, seed)
    items = _drive(TCO, batch_wire, sends)
    for topic in ("invoker0", "invoker1"):
        got = []
        for t, p in items:
            if t != topic:
                continue
            if TCOL.is_batch_payload(p):
                got.extend(m.serialize() for m in TCOL.parse_batch(p)[1])
            else:
                got.append(p)
        assert got == [m.serialize() for t, m in sends if t == topic]
    assert items == _drive(JCO, batch_wire, _mixed_sends(JAX, seed))


def test_coalescing_off_hands_back_the_raw_producer(monkeypatch):
    raw = TMM.MemoryMessagingProvider().get_producer()
    assert isinstance(TCO.maybe_coalesce(raw), TCO.CoalescingProducer)
    assert TCO.maybe_coalesce(
        raw, TCO.BusCoalesceConfig(enabled=False)) is raw
    monkeypatch.setenv("CONFIG_whisk_bus_coalesce_enabled", "false")
    assert TCO.maybe_coalesce(raw) is raw
    monkeypatch.setenv("CONFIG_whisk_bus_coalesce_enabled", "true")
    monkeypatch.setenv("CONFIG_whisk_bus_coalesce_batchWire", "false")
    assert TCO.maybe_coalesce(raw).batch_wire is False


@pytest.mark.parametrize("batch_wire", [True, False])
def test_a_failed_flush_fails_every_waiter(batch_wire):
    async def go():
        prod = TCO.CoalescingProducer(_Spy(ConnectionError("bus down")),
                                      max_batch=8, batch_wire=batch_wire)
        sends = [prod.send("invoker0", m)
                 for _t, m in _mixed_sends(PORT, 1)]
        nowait = prod.send_nowait("invoker0",
                                  build(PORT_PKG, "activation", 77))
        out = await asyncio.gather(*sends, nowait, return_exceptions=True)
        with pytest.raises(ConnectionError):
            await prod.send_batch("invoker1", [build(
                PORT_PKG, "activation", s) for s in range(3)])
        return out

    out = asyncio.run(asyncio.wait_for(go(), 10))
    assert out and all(isinstance(r, ConnectionError) for r in out)


def test_a_cancelled_drainer_cancels_its_waiters():
    """The coalescer's drainer cancelled mid-flush (loop teardown):
    the batch in flight and the queue behind it are cancelled, never
    resolved as sent."""
    async def go():
        started = asyncio.Event()

        async def slow_flush(batch):
            started.set()
            await asyncio.sleep(30)

        co = TMB.MicroCoalescer(slow_flush, max_batch=1, window_s=0.0)
        waiters = [co.submit_nowait(i) for i in range(3)]
        await started.wait()
        co._drainer.cancel()
        done, _ = await asyncio.wait(waiters, timeout=2.0)
        return [w.cancelled() for w in waiters], len(done)

    cancelled, n_done = asyncio.run(asyncio.wait_for(go(), 10))
    assert n_done == 3 and all(cancelled)
