"""The port's TCP bus (`openwhisk_tpu_torch/messaging/tcp.py`), its
messaging bootstrap (`provider_for_bus`) and its SPI loader.

The cases of the JAX package's `tests/test_distributed.py::TestTcpBus`,
the TCP cases of `tests/test_bus_coalesce.py` and
`tests/test_messaging.py`'s from-latest and `provider_for_bus` cases, run
over the port's modules; then the two packages on one wire: every
producer / broker / consumer combination of the JAX package and the port
carries the same bytes, and both encode the same frames byte for byte.
"""
import asyncio
import base64
import os
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from openwhisk_tpu.messaging import tcp as JT
from openwhisk_tpu_torch.messaging import tcp as TT
from openwhisk_tpu_torch.messaging.coalesce import CoalescingProducer
from openwhisk_tpu_torch.messaging.tcp import (TcpBusServer, TcpConsumer,
                                               TcpMessagingProvider,
                                               TcpProducer, _TcpConnection,
                                               _encode_pub, _encode_pubn)

ROOT = Path(__file__).resolve().parents[1]
PKGS = {"jax": JT, "port": TT}


def run(coro, timeout=30.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def _server(mod=TT):
    server = mod.TcpBusServer("127.0.0.1", 0)
    await server.start()
    return server, server._server.sockets[0].getsockname()[1]


def _payloads(batch):
    return [p for (*_x, p) in batch]


# -- ref tests/test_distributed.py::TestTcpBus --------------------------------
def test_pub_peek_roundtrip():
    async def go():
        server, port = await _server()
        try:
            provider = TcpMessagingProvider(port=port)
            prod = provider.get_producer()
            cons = provider.get_consumer("t1", "g1")
            await prod.send("t1", b"hello")
            await prod.send("t1", b"world")
            batch = await cons.peek(10, timeout=1.0)
            await prod.close()
            await cons.close()
            return _payloads(batch)
        finally:
            await server.stop()

    assert run(go()) == [b"hello", b"world"]


def test_groups_compete_and_fanout():
    async def go():
        server, port = await _server()
        try:
            provider = TcpMessagingProvider(port=port)
            prod = provider.get_producer()
            g1 = provider.get_consumer("t", "g1")
            # subscribe first so both groups see subsequent messages
            await g1.peek(1, timeout=0.05)
            g2 = provider.get_consumer("t", "g2")
            await g2.peek(1, timeout=0.05)
            for i in range(4):
                await prod.send("t", f"m{i}".encode())
            b1 = await g1.peek(10, timeout=0.5)
            b2 = await g2.peek(10, timeout=0.5)
            for c in (prod, g1, g2):
                await c.close()
            return len(b1), len(b2)
        finally:
            await server.stop()

    # distinct groups each get every message
    assert run(go()) == (4, 4)


def test_long_poll_blocks_until_message():
    async def go():
        server, port = await _server()
        try:
            provider = TcpMessagingProvider(port=port)
            prod = provider.get_producer()
            cons = provider.get_consumer("t", "g")
            await cons.peek(1, timeout=0.05)  # register the group

            async def later():
                await asyncio.sleep(0.2)
                await prod.send("t", b"late")

            task = asyncio.get_running_loop().create_task(later())
            t0 = time.monotonic()
            batch = await cons.peek(1, timeout=2.0)
            dt = time.monotonic() - t0
            await task
            await prod.close()
            await cons.close()
            return dt, len(batch)
        finally:
            await server.stop()

    dt, n = run(go())
    assert n == 1
    assert 0.1 < dt < 1.5  # a long poll, not a busy wait


# -- ref tests/test_bus_coalesce.py, the TCP cases ----------------------------
def test_pubn_round_trip_multi_topic():
    async def go():
        server, port = await _server()
        provider = TcpMessagingProvider("127.0.0.1", port)
        producer = provider.get_producer()
        items = [("t1", f"a{i}".encode(), None) for i in range(5)] + \
                [("t2", f"b{i}".encode(), None) for i in range(3)]
        await producer.send_many(items)
        c1 = provider.get_consumer("t1", "g")
        c2 = provider.get_consumer("t2", "g")
        b1 = await c1.peek(100, timeout=0.5)
        b2 = await c2.peek(100, timeout=0.5)
        for c in (c1, c2, producer):
            await c.close()
        await server.stop()
        return _payloads(b1), _payloads(b2), producer.sent_count

    t1, t2, sent = run(go())
    assert t1 == [f"a{i}".encode() for i in range(5)]
    assert t2 == [f"b{i}".encode() for i in range(3)]
    assert sent == 8


def test_pubn_full_frame_retry_dedupes_every_submessage():
    async def go():
        server, port = await _server()
        conn = _TcpConnection("127.0.0.1", port)
        frame = _encode_pubn([("t", "m1", b"x"), ("t", "m2", b"y")])
        r1 = await conn.request_frame(frame)
        r2 = await conn.request_frame(frame)  # the retry
        c = TcpMessagingProvider("127.0.0.1", port).get_consumer("t", "g")
        batch = await c.peek(100, timeout=0.5)
        await c.close()
        await conn.close()
        await server.stop()
        return r1, r2, _payloads(batch)

    r1, r2, msgs = run(go())
    assert [s.get("dup") for s in r1["results"]] == [None, None]
    assert [s.get("dup") for s in r2["results"]] == [True, True]
    assert msgs == [b"x", b"y"]


def test_pubn_partial_dedupe():
    async def go():
        server, port = await _server()
        conn = _TcpConnection("127.0.0.1", port)
        await conn.request({"op": "pub", "topic": "t", "mid": "seen-1",
                            "payload": "eA=="})  # b"x"
        resp = await conn.request_frame(_encode_pubn(
            [("t", "seen-1", b"x"), ("t", "fresh-1", b"z")]))
        c = TcpMessagingProvider("127.0.0.1", port).get_consumer("t", "g")
        batch = await c.peek(100, timeout=0.5)
        await c.close()
        await conn.close()
        await server.stop()
        return resp, _payloads(batch)

    resp, msgs = run(go())
    assert [s.get("dup") for s in resp["results"]] == [True, None]
    assert msgs == [b"x", b"z"]


def test_oversized_batch_splits_into_multiple_frames(monkeypatch):
    async def go():
        server, port = await _server()
        producer = TcpProducer("127.0.0.1", port)
        monkeypatch.setattr(TT, "MAX_PUBN_PAYLOAD_BYTES", 1024)
        frames = []
        orig = producer._conn.request_frame

        async def counting(frame):
            frames.append(len(frame))
            return await orig(frame)

        producer._conn.request_frame = counting
        items = [("t", bytes([65 + i]) * 300, None) for i in range(10)]
        await producer.send_many(items)
        c = TcpMessagingProvider("127.0.0.1", port).get_consumer("t", "g")
        batch = await c.peek(100, timeout=0.5)
        await c.close()
        await producer.close()
        await server.stop()
        return frames, _payloads(batch), producer.sent_count

    frames, msgs, sent = run(go())
    # 10 x 300 B over a 1 KiB cap -> 4 frames of <= 3 payloads
    assert len(frames) == 4
    assert msgs == [bytes([65 + i]) * 300 for i in range(10)]
    assert sent == 10


def test_prefix_counter_mids_unique():
    p1 = TcpProducer("127.0.0.1", 1)
    p2 = TcpProducer("127.0.0.1", 1)
    mids = [p1._next_mid() for _ in range(100)]
    assert len(set(mids)) == 100
    assert all(m.startswith(p1._mid_prefix + "-") for m in mids)
    assert p1._mid_prefix != p2._mid_prefix


def test_retry_of_one_pub_delivers_once():
    async def go():
        server, port = await _server()
        producer = TcpProducer("127.0.0.1", port)
        frame = _encode_pub("t", producer._next_mid(), b"once")
        await producer._conn.request_frame(frame)
        await producer._conn.request_frame(frame)  # retry, same mid
        await producer.send("t", b"next")          # fresh mid
        c = TcpMessagingProvider("127.0.0.1", port).get_consumer("t", "g")
        batch = await c.peek(100, timeout=0.5)
        await c.close()
        await producer.close()
        await server.stop()
        return _payloads(batch)

    assert run(go()) == [b"once", b"next"]


def test_pubn_over_tcp_via_the_coalescing_wrapper():
    async def go():
        server, port = await _server()
        provider = TcpMessagingProvider("127.0.0.1", port)
        producer = CoalescingProducer(provider.get_producer(),
                                      max_batch=64, window_ms=1.0)
        await asyncio.gather(*[producer.send("t", f"m{i}".encode())
                               for i in range(10)])
        c = provider.get_consumer("t", "g")
        batch = await c.peek(100, timeout=0.5)
        await c.close()
        await producer.close()
        await server.stop()
        return _payloads(batch)

    assert run(go()) == [f"m{i}".encode() for i in range(10)]


def test_dead_broker_peek_returns_after_its_timeout_with_retries():
    async def go():
        consumer = TcpConsumer("127.0.0.1", 1, "t", "g")
        t0 = time.monotonic()
        batch = await consumer.peek(10, timeout=0.5)
        return batch, time.monotonic() - t0, consumer.reconnects

    batch, took, reconnects = run(go())
    assert batch == []
    assert took < 2.0
    assert reconnects >= 3  # capped exponential backoff, not one long nap


def test_broker_returning_mid_window_is_caught():
    async def go():
        probe = TcpBusServer("127.0.0.1", 0)
        await probe.start()
        port = probe._server.sockets[0].getsockname()[1]
        await probe.stop()  # port known, broker down
        consumer = TcpConsumer("127.0.0.1", port, "t", "g")

        async def revive():
            await asyncio.sleep(0.3)
            server = TcpBusServer("127.0.0.1", port)
            await server.start()
            prod = TcpProducer("127.0.0.1", port)
            await prod.send("t", b"back")
            await prod.close()
            return server

        reviver = asyncio.ensure_future(revive())
        t0 = time.monotonic()
        batch = await consumer.peek(10, timeout=6.0)
        took = time.monotonic() - t0
        server = await reviver
        await consumer.close()
        await server.stop()
        return _payloads(batch), took, consumer.reconnects

    msgs, took, reconnects = run(go())
    assert msgs == [b"back"]
    assert took < 4.0
    assert reconnects >= 1


def test_ensure_topic_without_a_loop_configures_retention():
    async def go():
        server, port = await _server()
        provider = TcpMessagingProvider("127.0.0.1", port)
        # a worker thread has no running event loop: the blocking one-shot
        await asyncio.get_running_loop().run_in_executor(
            None, provider.ensure_topic, "caps", 1, 128 * 100)
        await asyncio.sleep(0.05)
        cap = server.bus.topic("caps").max_messages
        await server.stop()
        return cap

    assert run(go()) == 100


def test_ensure_topic_without_a_loop_or_broker_logs_and_survives(caplog):
    provider = TcpMessagingProvider("127.0.0.1", 1)

    def sync_call():
        with caplog.at_level("WARNING",
                             logger="openwhisk_tpu_torch.messaging.tcp"):
            provider.ensure_topic("t", retention_bytes=1024)

    t = threading.Thread(target=sync_call)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert any("ensure_topic" in r.message for r in caplog.records)


# -- ref tests/test_messaging.py ----------------------------------------------
def test_from_latest_over_tcp_bus():
    async def go():
        server, port = await _server()
        provider = TcpMessagingProvider("127.0.0.1", port)
        producer = provider.get_producer()
        for i in range(20):
            await producer.send("health", f"stale{i}".encode())
        fresh = provider.get_consumer("health", "health-c1", from_latest=True)
        # the first peek creates the latest-positioned group broker-side
        first = await fresh.peek(100, timeout=0.2)
        await producer.send("health", b"live")
        second = await fresh.peek(100, timeout=1.0)
        await fresh.close()
        await producer.close()
        await server.stop()
        return first, _payloads(second)

    assert run(go()) == ([], [b"live"])


def test_provider_for_bus_default_is_tcp():
    from openwhisk_tpu_torch.messaging import provider_for_bus
    p = provider_for_bus("127.0.0.1:4555")
    assert isinstance(p, TcpMessagingProvider)
    assert (p.host, p.port) == ("127.0.0.1", 4555)


def test_provider_for_bus_spi_binding_overrides(monkeypatch):
    from openwhisk_tpu_torch import spi
    from openwhisk_tpu_torch.messaging import (MemoryMessagingProvider,
                                               provider_for_bus)
    monkeypatch.setenv(
        "CONFIG_whisk_spi_MessagingProvider",
        "openwhisk_tpu_torch.messaging.memory:MemoryMessagingProvider")
    spi.reset()
    try:
        # the memory provider takes no bootstrap address: the signature
        # inspection leaves it out
        assert isinstance(provider_for_bus("broker:9092"),
                          MemoryMessagingProvider)
    finally:
        spi.reset()


# -- the SPI loader ------------------------------------------------------------
def test_spi_defaults_resolve_inside_the_port():
    from openwhisk_tpu_torch import spi
    spi.reset()
    for name in spi.SPI_NAMES:
        impl = spi.get(name)
        assert impl.__module__.startswith("openwhisk_tpu_torch."), name


def test_spi_refuses_a_path_into_the_jax_package():
    """In a fresh interpreter: naming a JAX-package module is refused with
    a message that names the port, and nothing of that package or of jax
    is imported."""
    code = (
        "import os, sys\n"
        "os.environ['CONFIG_whisk_spi_MessagingProvider'] = "
        "'openwhisk_tpu.messaging.memory:MemoryMessagingProvider'\n"
        "from openwhisk_tpu_torch import spi\n"
        "from openwhisk_tpu_torch.messaging import provider_for_bus\n"
        "try:\n"
        "    provider_for_bus('127.0.0.1:4222')\n"
        "except spi.SpiResolutionError as e:\n"
        "    print('refused:', e)\n"
        "try:\n"
        "    spi.bind('LoadBalancerProvider', 'openwhisk_tpu.controller."
        "loadbalancer.lean:LeanBalancerProvider')\n"
        "    spi.get('LoadBalancerProvider')\n"
        "except spi.SpiResolutionError as e:\n"
        "    print('refused:', e)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'openwhisk_tpu'))\n"
        "print('imported:', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert len([ln for ln in lines if ln.startswith("refused:")]) == 2
    assert all("openwhisk_tpu_torch" in ln for ln in lines
               if ln.startswith("refused:"))
    assert lines[-1] == "imported: []"


# -- the two packages on one wire ----------------------------------------------
@pytest.mark.parametrize("mid", ["m-1", None])
def test_frames_are_byte_identical_across_the_packages(mid):
    payloads = [b"", b"x", bytes(range(256)), "é".encode() * 40]
    for p in payloads:
        assert TT._encode_pub("t", mid, p) == JT._encode_pub("t", mid, p)
    msgs = [(f"t{i % 3}", f"{mid}-{i}", p) for i, p in enumerate(payloads)]
    assert TT._encode_pubn(msgs) == JT._encode_pubn(msgs)
    req = {"op": "peek", "topic": "t", "group": "g", "latest": False,
           "max": 128, "timeout": 0.5}
    assert TT._frame(req) == JT._frame(req)
    assert TT.MAX_PUBN_PAYLOAD_BYTES == JT.MAX_PUBN_PAYLOAD_BYTES
    assert TT.OFFLOAD_ENCODE_BYTES == JT.OFFLOAD_ENCODE_BYTES


async def _raw_exchange(port, frames):
    """Send raw frames on one connection; return each raw response."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    out = []
    for f in frames:
        writer.write(f)
        await writer.drain()
        header = await reader.readexactly(4)
        (n,) = struct.unpack(">I", header)
        out.append(header + await reader.readexactly(n))
    writer.close()
    await writer.wait_closed()
    return out


def test_brokers_answer_the_same_frames_with_the_same_bytes():
    """The same request frames (pub, a retried pub, pubN with a duplicate,
    ensure, peek, latest peek, an unknown op) get byte-identical responses
    from the JAX broker and the port's."""
    body = base64.b64encode(b"payload").decode()
    frames = [
        JT._encode_pub("a", "mid-1", b"one"),
        JT._encode_pub("a", "mid-1", b"one"),
        JT._encode_pubn([("a", "mid-1", b"one"), ("a", "mid-2", b"two"),
                         ("b", "mid-3", b"three")]),
        JT._frame({"op": "ensure", "topic": "c", "retention_bytes": 256}),
        JT._frame({"op": "pub", "topic": "c", "payload": body}),
        JT._frame({"op": "peek", "topic": "a", "group": "g", "max": 10,
                   "timeout": 0.1}),
        JT._frame({"op": "peek", "topic": "b", "group": "g2", "max": 10,
                   "timeout": 0.05, "latest": True}),
        JT._frame({"op": "peek", "topic": "c", "group": "g", "max": 10,
                   "timeout": 0.1}),
        JT._frame({"op": "nope"}),
    ]

    async def go(mod):
        server, port = await _server(mod)
        try:
            return await _raw_exchange(port, frames)
        finally:
            await server.stop()

    assert run(go(TT)) == run(go(JT))


@pytest.mark.parametrize("producer", ["jax", "port"])
@pytest.mark.parametrize("broker", ["jax", "port"])
@pytest.mark.parametrize("consumer", ["jax", "port"])
def test_either_package_carries_the_others_messages(broker, producer,
                                                    consumer, monkeypatch):
    """A producer of one package, through a broker of either, to a consumer
    of either: pub, coalesced pubN (split at the byte cap) and a retried
    frame arrive as the same bytes, once each, in order."""
    P, B, C = PKGS[producer], PKGS[broker], PKGS[consumer]
    blobs = [bytes([i]) * (100 + 37 * i) for i in range(12)]
    monkeypatch.setattr(P, "MAX_PUBN_PAYLOAD_BYTES", 1024)

    async def go():
        server, port = await _server(B)
        prod = P.TcpMessagingProvider("127.0.0.1", port).get_producer()
        cons = C.TcpMessagingProvider("127.0.0.1", port).get_consumer(
            "t", "g")
        await cons.peek(1, timeout=0.05)
        await prod.send("t", b"first")
        frames = []
        orig = prod._conn.request_frame

        async def counting(frame):
            frames.append(frame)
            return await orig(frame)

        prod._conn.request_frame = counting
        await prod.send_many([("t", b, None) for b in blobs])
        assert len(frames) > 1  # split at the byte cap
        frame = P._encode_pub("t", prod._next_mid(), b"retried")
        await prod._conn.request_frame(frame)
        await prod._conn.request_frame(frame)
        got = []
        for _ in range(20):
            got += _payloads(await cons.peek(100, timeout=0.2))
            if len(got) >= 14:
                break
        await prod.close()
        await cons.close()
        await server.stop()
        return got

    assert run(go()) == [b"first"] + blobs + [b"retried"]
