"""Invoker stand-ins for the load generator: echo invokers on the bus.

A copy of the three functions of the repository's `bench.py` that
`tools/loadgen.py` drives (`_bench_action`, `_echo_invoker`,
`_echo_fleet`), with the imports renamed to the port; nothing else of
`bench.py` is copied. An echo invoker acks every activation at once over
the coalesced ack batch (a straggler's acks wait `feed.delay` seconds
first); an echo fleet is N of them plus a 1 Hz pinger.

Its named cut: the pinger spreads each second's pings over the second,
`PING_CHUNK` at a time. `bench.py`'s sends them all in one burst, and a
health topic on the in-memory bus keeps the last 4,096 messages, so a
fleet past 4,096 invokers never registered (the supervision saw only the
burst's tail); a fleet of at most `PING_CHUNK` pings exactly as
`bench.py`'s (`tests/test_torch_performance.py` ECHO_CUTS).
"""
from __future__ import annotations

import asyncio
import time

#: pings the pinger sends at once: far below what the in-memory bus's
#: health topic keeps (messaging/memory.py DEFAULT_MAX_MESSAGES, 4,096),
#: and few enough that the supervision drains a chunk between two of them
#: within the load generator's 50 ms fire-lag bound
PING_CHUNK = 256


def _bench_action(name, memory=256):
    from openwhisk_tpu_torch.core.entity import (ActionLimits, CodeExec, EntityName,
                                           EntityPath, ExecutableWhiskAction,
                                           MB, MemoryLimit, TimeLimit)
    from openwhisk_tpu_torch.core.entity.ids import DocRevision

    a = ExecutableWhiskAction(EntityPath("guest"), EntityName(name),
                              CodeExec(kind="python:3", code="x"),
                              limits=ActionLimits(TimeLimit(5000),
                                                  MemoryLimit(MB(memory))))
    a.rev = DocRevision("1-b")
    return a


async def _echo_invoker(provider, instance, delay=0.0, on_frame=None):
    """An invoker stand-in: consumes its topic, acks every activation
    immediately with a successful record (pure control-plane load). Rides
    the same batch wire as the real InvokerReactive: a columnar dispatch
    frame decodes ONCE, and the whole frame's acks are submitted in one
    sweep so they coalesce into one ack batch frame back.

    `delay` rides as a mutable attribute on the returned feed (the
    SimInvoker idiom of the anomaly tests, so the load generator's
    `apply_stragglers` drives test stubs and echo feeds through the same
    knob): a straggler's acks sleep `feed.delay` seconds before flushing.

    `on_frame(instance, msgs)` is a synchronous per-frame hook (the
    trace-assembly rider emits invoker-side spans from it, standing in
    for the real InvokerReactive's container span pair)."""
    from openwhisk_tpu_torch.core.entity import (ActivationResponse, EntityPath,
                                           WhiskActivation)
    from openwhisk_tpu_torch.messaging import (ActivationMessage,
                                         CombinedCompletionAndResultMessage,
                                         MessageFeed)
    from openwhisk_tpu_torch.messaging.columnar import is_batch_payload
    from openwhisk_tpu_torch.messaging.connector import (decode_batch,
                                                   decode_message)

    topic = instance.as_string
    provider.ensure_topic(topic)
    consumer = provider.get_consumer(topic, topic)
    # the stand-in rides the same ack coalescing as the real
    # InvokerReactive, so the e2e riders measure the shipped completion path
    from openwhisk_tpu_torch.messaging import maybe_coalesce
    producer = maybe_coalesce(provider.get_producer())
    box = {}

    async def handle(payload: bytes):
        if is_batch_payload(payload):
            _kind, msgs = decode_batch(payload)
        else:
            msgs = [decode_message(ActivationMessage.parse, payload,
                                   "activation")]
        if on_frame is not None:
            on_frame(instance, msgs)
        now = time.time()
        by_topic = {}
        for msg in msgs:
            act = WhiskActivation(
                EntityPath(str(msg.user.namespace.name)), msg.action.name,
                msg.user.subject, msg.activation_id, now, now,
                ActivationResponse.success({"ok": True}), duration=1)
            by_topic.setdefault(
                f"completed{msg.root_controller_index.as_string}",
                []).append(CombinedCompletionAndResultMessage(
                    msg.transid, act, instance))
        # straggler injection: read the live knob each frame (riders and
        # tests retune it mid-run, like the SimInvoker scenario)
        d = getattr(box["feed"], "delay", 0.0)
        if d:
            await asyncio.sleep(d)
        # send_batch: every ack submits in THIS sweep (one dispatch
        # frame's acks flush as one ack batch frame) with no task per
        # message — asyncio.gather over N send() coroutines minted a
        # Task each, measurable loop churn at thousands of acks/s
        for topic, acks in by_topic.items():
            await producer.send_batch(topic, acks)
        box["feed"].processed()

    feed = MessageFeed(topic, consumer, 256, handle)
    feed.delay = delay
    box["feed"] = feed
    feed.start()
    return feed


async def _echo_fleet(provider, n_invokers, stragglers=None, on_frame=None):
    """Start `n_invokers` echo invokers + a 1 Hz pinger (supervision marks a
    fleet Offline after 10 s of silence, which a cold first compile easily
    outlasts). Returns (feeds, stop) — await stop() to end the pinger.
    `stragglers`: a {index: delay_s} map (or the loadgen SPEC string) —
    those invokers' acks are delayed from the first frame."""
    from openwhisk_tpu_torch.core.entity import MB, InvokerInstanceId
    from openwhisk_tpu_torch.messaging import PingMessage
    from openwhisk_tpu_torch.tools.loadgen import parse_stragglers

    slow = parse_stragglers(stragglers)
    producer = provider.get_producer()
    provider.ensure_topic("health")
    feeds, instances = [], []
    for i in range(n_invokers):
        inst = InvokerInstanceId(i, user_memory=MB(8192))
        instances.append(inst)
        feeds.append(await _echo_invoker(provider, inst,
                                         delay=slow.get(i, 0.0),
                                         on_frame=on_frame))
        await producer.send("health", PingMessage(inst))
    stop_ping = asyncio.Event()
    chunks = [instances[k:k + PING_CHUNK]
              for k in range(0, len(instances), PING_CHUNK)]

    async def pinger():
        while not stop_ping.is_set():
            for chunk in chunks:
                for inst in chunk:
                    await producer.send("health", PingMessage(inst))
                try:
                    await asyncio.wait_for(stop_ping.wait(),
                                           1.0 / len(chunks))
                    return
                except asyncio.TimeoutError:
                    pass

    ping_task = asyncio.ensure_future(pinger())

    async def stop():
        stop_ping.set()
        await ping_task

    return feeds, stop
