"""Coalescing producer: micro-batched bus produce behind the provider SPI.
A copy of `openwhisk_tpu/messaging/coalesce.py`.

The publish->dispatch->invoke->complete path used to pay one bus round trip
per activation: the balancer's readback fan-out wakes N publishers in one
event-loop sweep and each `await producer.send(...)` serialized on the
transport (one lock-guarded TCP frame + ack per message on the TCP bus; one
condition acquire + notify per message on the memory bus). Under open-loop
load those per-request costs compound into the tail (PAPERS.md: Dean &
Barroso — the cure is doing less serial work per request, amortized over
batches).

`CoalescingProducer` wraps any `MessageProducer` and turns concurrent sends
into micro-batches: a send enqueues (payload pre-serialized on the caller's
turn) and resolves when its batch's single `send_many` acknowledges. The
flush fires when the batch fills (`max_batch`) or when the oldest pending
message has waited `window_ms` (a Nagle-style bounded delay; `window_ms=0`
flushes at the end of the current event-loop sweep, which still coalesces a
whole readback wave). Flushes are serialized on one drainer task, so
per-producer ordering is exactly the serial producer's.

Backends with a native batch op ship one frame per micro-batch
(`TcpProducer.send_many` -> the broker's `pubN` op: one length-prefixed
frame, N payloads, one ack, broker-side dedupe per sub-message); backends
without one fall back to the base `send_many` (sequential sends — serial
semantics, no wire-protocol change).

Off switch: `CONFIG_whisk_bus_coalesce_enabled=false` makes
`maybe_coalesce()` return the raw producer — the serial path, bit-exact
with today's behavior.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..utils.config import load_config
from ..utils.microbatch import MicroCoalescer
from .connector import MessageProducer, encode_message

#: process-wide coalescing health counters, exported as gauges by the
#: balancers' supervision tick (export_coalesce_gauges) — one aggregate
#: across producers, like the tracing gauges
_STATS = {"batches": 0, "messages": 0, "max_batch": 0,
          "wire_batches": 0, "wire_batched_messages": 0}


@dataclass(frozen=True)
class BusCoalesceConfig:
    """`CONFIG_whisk_bus_coalesce_*` env overrides."""
    enabled: bool = True
    #: flush as soon as this many messages are pending
    max_batch: int = 64
    #: bounded accumulation delay: the oldest pending message waits at most
    #: this long before its frame ships. Default 0 = flush at the end of
    #: the current event-loop sweep, which already coalesces a whole
    #: readback/ack wave at ZERO added idle latency (measured: the produce
    #: stage p99 stays ~1 ms at the sustained rate). Set ~1 ms on expensive
    #: transports (remote TCP, Kafka) to also batch across waves.
    window_ms: float = 0.0
    #: columnar batch wire (messaging/columnar.py): same-topic
    #: activation/ack messages in one flush ship as ONE encoded batch
    #: record — one json.dumps per batch with per-batch identity/action
    #: dedup, instead of N independent encodes (and the encode moves to
    #: flush time, so a message serialized for a batch is encoded exactly
    #: once). False restores the serial wire format byte-exactly.
    batch_wire: bool = True
    #: lazy ack result column: ack batch frames carry each
    #: activation's response payload as an opaque bytes column after the
    #: JSON header, so the controller's completion loop never parses a
    #: result nobody reads (blocking invokes parse on the API turn;
    #: fire-and-forget acks skip the parse entirely). False restores the
    #: eager ack batch record byte-exactly.
    lazy_results: bool = True

    @classmethod
    def from_env(cls) -> "BusCoalesceConfig":
        return load_config(cls, env_path="bus.coalesce")


class CoalescingProducer(MessageProducer):
    """Micro-batching wrapper over any MessageProducer (see module doc).
    The coalescing loop itself is the shared MicroCoalescer
    (utils/microbatch.py) — the admission plane rides the same one."""

    def __init__(self, inner: MessageProducer, max_batch: int = 64,
                 window_ms: float = 0.0, batch_wire: bool = False,
                 lazy_results: bool = False):
        self.inner = inner
        self.batch_wire = batch_wire
        self.lazy_results = lazy_results
        self._co = MicroCoalescer(self._ship, max_batch,
                                  max(0.0, float(window_ms)) / 1e3,
                                  name="bus-coalesce-drain")

    @property
    def sent_count(self) -> int:
        return self.inner.sent_count

    @property
    def pending_count(self) -> int:
        return self._co.pending_count

    async def send(self, topic: str, msg) -> None:
        # Batch wire fast path: a batchable message (activation / ack) is
        # NOT encoded here — it rides to the flush as an object and is
        # encoded exactly once, inside its batch's single json.dumps.
        # Everything else serializes on the caller's turn as before (the
        # flush loop then ships bytes without touching message objects,
        # and a slow .serialize() is charged to the sender, not to every
        # batch-mate). encode_message / encode_batch both feed the host
        # observatory's per-hop serde accounting.
        if self.batch_wire and not isinstance(msg, (bytes, bytearray)):
            from .columnar import batchable_family
            family = batchable_family(msg)
            if family is not None:
                await self._co.submit((topic, family, msg))
                return
        payload = encode_message(msg)
        await self._co.submit((topic, payload, msg))

    def send_nowait(self, topic: str, msg) -> "asyncio.Future":
        """Public task-free submit (the batched publish SPI resolves its
        callers from this future's done-callback): enqueue now, flush
        with the coalescer's next drain."""
        return self._submit_nowait(topic, msg)

    def _submit_nowait(self, topic: str, msg) -> "asyncio.Future":
        """send() without the await: enqueue, return the flush future."""
        if self.batch_wire and not isinstance(msg, (bytes, bytearray)):
            from .columnar import batchable_family
            family = batchable_family(msg)
            if family is not None:
                return self._co.submit_nowait((topic, family, msg))
        return self._co.submit_nowait((topic, encode_message(msg), msg))

    async def send_batch(self, topic: str, msgs: list) -> None:
        """Submit a whole wave in one sweep and await the flush ONCE: the
        per-item futures resolve together (same per-item error
        propagation as N send() calls) with no task per message —
        `asyncio.gather` over coroutines would mint one Task each, which
        at thousands of acks/s was measurable loop churn. Failures
        gather with return_exceptions so sibling futures are all
        retrieved (no unretrieved-exception log spam), then the first
        real failure raises."""
        import asyncio
        futs = [self._submit_nowait(topic, m) for m in msgs]
        results = await asyncio.gather(*futs, return_exceptions=True)
        for r in results:
            if isinstance(r, BaseException):
                raise r

    async def _ship(self, batch) -> None:
        """One coalesced flush: the whole batch rides the provider's
        send_many (one pubN frame on the TCP bus). With the batch wire
        on, same-topic batchable messages collapse into ONE columnar
        record per (topic, family) — encoded here, exactly once per
        message — so the pubN frame carries one payload per topic
        instead of one per message. The coalescer resolves the waiter
        futures on return / failure."""
        _STATS["batches"] += 1
        _STATS["messages"] += len(batch)
        _STATS["max_batch"] = max(_STATS["max_batch"], len(batch))
        if not self.batch_wire:
            await self.inner.send_many([item for (item, _fut) in batch])
            return
        from .connector import encode_batch
        # group deferred-encode messages per (topic, family), preserving
        # per-topic arrival order WITHIN a family (the serial ordering
        # contract is per-topic; cross-topic order was never guaranteed —
        # send_many already interleaves topics). Pre-encoded items pass
        # through at their arrival position. Caveat, by design: a topic
        # carrying BOTH batchable and unbatchable payloads in one flush
        # may reorder across the kinds (the group anchors at its first
        # message) — no shipped topic mixes kinds (invoker topics carry
        # activations, completed* topics carry acks, health/events stay
        # per-frame), and consumers of each kind are order-independent
        # across the other.
        items: list = []
        groups: dict = {}
        for (topic, payload_or_family, msg), fut in batch:
            if isinstance(payload_or_family, str):
                key = (topic, payload_or_family)
                grp = groups.get(key)
                if grp is None:
                    grp = groups[key] = []
                    # placeholder keeps this group's position in the
                    # flush order (first appearance of the topic)
                    items.append(key)
                grp.append((msg, fut))
            else:
                items.append((topic, payload_or_family, msg))
        out: list = []
        for it in items:
            if isinstance(it, tuple) and len(it) == 2:
                topic, family = it
                group = groups[(topic, family)]
                msgs = [m for (m, _f) in group]
                if len(msgs) == 1:
                    # a lone message pays the plain wire format — the
                    # decode side needs no batch frame for N=1 and the
                    # serial consumers stay compatible
                    try:
                        out.append((topic, encode_message(msgs[0]),
                                    msgs[0]))
                    except Exception as e:  # noqa: BLE001
                        self._fail_group(group, e)
                    continue
                try:
                    payload, batch_msg = encode_batch(
                        family, msgs, lazy_results=self.lazy_results)
                except Exception:  # noqa: BLE001 — deferring the encode
                    # to flush time must NOT widen one bad message's
                    # blast radius to the whole flush (the serial path
                    # charged a serialize failure to its sender): retry
                    # each message alone so only the unserializable ones
                    # fail, and the rest still ship
                    for m, fut in group:
                        try:
                            out.append((topic, encode_message(m), m))
                        except Exception as e:  # noqa: BLE001
                            if not fut.done():
                                fut.set_exception(e)
                    continue
                _STATS["wire_batches"] += 1
                _STATS["wire_batched_messages"] += len(msgs)
                out.append((topic, payload, batch_msg))
            else:
                out.append(it)
        await self.inner.send_many(out)

    @staticmethod
    def _fail_group(group, exc) -> None:
        for _m, fut in group:
            if not fut.done():
                fut.set_exception(exc)

    async def flush(self) -> None:
        """Wait until everything enqueued so far has shipped (or failed)."""
        await self._co.drain_all()

    async def close(self) -> None:
        await self.flush()
        await self.inner.close()


def maybe_coalesce(producer: MessageProducer,
                   config: Optional[BusCoalesceConfig] = None
                   ) -> MessageProducer:
    """The wiring hook for producer owners (balancer, invoker, bench echo
    fleet): wrap in a CoalescingProducer when coalescing is on; hand back
    the raw producer — the bit-exact serial path — when it is off."""
    cfg = config if config is not None else BusCoalesceConfig.from_env()
    if not cfg.enabled or isinstance(producer, CoalescingProducer):
        return producer
    return CoalescingProducer(producer, cfg.max_batch, cfg.window_ms,
                              batch_wire=cfg.batch_wire,
                              lazy_results=cfg.lazy_results)


def export_coalesce_gauges(metrics) -> None:
    """Coalescing health gauges (ridden by the balancers' supervision tick,
    like export_tracing_gauges): flushed batch/message counts and the
    largest batch seen — messages/batches is the live amortization factor."""
    metrics.gauge("bus_coalesce_batches", _STATS["batches"])
    metrics.gauge("bus_coalesce_messages", _STATS["messages"])
    metrics.gauge("bus_coalesce_batch_max", _STATS["max_batch"])
    metrics.gauge("bus_wire_batches", _STATS["wire_batches"])
    metrics.gauge("bus_wire_batched_messages",
                  _STATS["wire_batched_messages"])
