"""The front-end -> balancer admission funnel in the port, held against the
JAX package (the counterpart of `tests/test_funnel.py`).

Every case of the JAX suite runs on both packages (`[jax]` / `[port]`):
the `fun1` / `funA` frame round trips, the receiver's per-row dedupe of a
replayed frame, the stale-epoch refusal of whole frames, the funnel-depth
429 with the serial front door's exact text, the device throttle's and
the standby refusal's texts across the hop, a blocking completion, the
sender's retry of a lost frame, retry exhaustion, a forced timeout, and
the dedupe over the TCP bus. Then the cross-package cases:

  * each package's `FunnelBalancer` ships byte-identical `fun1` frames
    for the same rows, and each package's `FunnelReceiver` byte-identical
    `funA` outcome frames;
  * a JAX frontend funnels blocking and non-blocking invokes to the
    port's `TpuBalancer(device="cpu")` over one TCP bus, and the port's
    frontend to a JAX `TpuBalancer`: every blocking invoke comes back
    with its activation, every row places once.

(The JAX suite's `multiproc` case drives its load generator, which the
port does not have; the funnel's processes run in `test_torch_ha.py`.)
"""
import asyncio
import time

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from torch_ha_cases import (SIDES, balancer, fleet, make_action,  # noqa: E402
                           make_msg, ping_all, side, stop_all, until)

both = pytest.mark.parametrize("S", [side(s) for s in SIDES], ids=SIDES)

DEVICE_THROTTLE_TEXT = ("Too many requests in the last minute "
                        "(device rate admission).")
STANDBY_TEXT = ("standby controller: placement is fenced to the active "
                "leader")


def run(coro, timeout=30.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _activation(S, aid):
    E = S.E
    now = int(time.time() * 1000)
    return E.WhiskActivation(E.EntityPath("guest"), E.EntityName("fx"),
                             E.Subject("guest-user"), aid, now, now,
                             E.ActivationResponse.success({"ok": 1}),
                             duration=1)


class StubBalancer:
    """A balancer double of package S on the publish_many contract: each
    row resolves to a completion promise ('place'), raises the serial
    device throttle ('throttle') or the standby refusal ('standby');
    placements are recorded so double executions show."""

    fence_epoch = None
    waterfall = None

    def __init__(self, S, mode="place"):
        self.S = S
        self.mode = mode
        self.placed = []
        self.promises = {}

    def publish_many(self, pairs):
        B = self.S.Base
        loop = asyncio.get_event_loop()
        outs = []
        for _action, msg in pairs:
            out = loop.create_future()
            aid = msg.activation_id.asString
            if self.mode == "throttle":
                out.set_exception(
                    B.LoadBalancerThrottleException(DEVICE_THROTTLE_TEXT))
            elif self.mode == "standby":
                out.set_exception(B.LoadBalancerException(STANDBY_TEXT))
            else:
                self.placed.append(aid)
                promise = loop.create_future()
                self.promises[aid] = promise
                out.set_result(promise)
            outs.append(out)
        return outs


def _receiver(S, provider, bal, instance="0", **kw):
    async def resolver(name, rev):
        return make_action(S, "fx", memory=128)
    return S.Funnel.FunnelReceiver(provider, S.E.ControllerInstanceId(
        instance), bal, resolver=resolver, **kw)


def _frontend(S, provider, origin="7", target=0, **cfg):
    config = S.Funnel.FunnelConfig(**cfg) if cfg else S.Funnel.FunnelConfig()
    return S.Funnel.FunnelBalancer(provider, S.E.ControllerInstanceId(origin),
                                   target=target, config=config)


def _msgs(S, n, blocking=False):
    action = make_action(S, "fx", memory=128)
    ident = S.E.Identity.generate("guest")
    return action, [make_msg(S, action, ident, blocking) for _ in range(n)]


# -- the wire -------------------------------------------------------------------
@both
def test_funnel_frame_roundtrip(S):
    C = S.Col
    _action, msgs = _msgs(S, 3, blocking=True)
    raw = C.FunnelBatchMessage(msgs, origin=7, seq=42, epoch=5).serialize()
    assert C.is_batch_payload(raw)
    kind, decoded = C.parse_batch(raw)
    assert kind == C.KIND_FUNNEL
    assert (decoded.origin, decoded.seq, decoded.epoch) == (7, 42, 5)
    assert [m.activation_id.asString for m in decoded.msgs] == \
        [m.activation_id.asString for m in msgs]
    for orig, back in zip(msgs, decoded.msgs):
        assert str(back.action) == str(orig.action)
        assert back.blocking == orig.blocking
        assert back.user.subject == orig.user.subject


@both
def test_funnel_ack_roundtrip_all_codes(S):
    C = S.Col
    aid = S.E.ActivationId.generate()
    act = _activation(S, aid)
    rows = [C.FunnelOutcome("p", "a1"),
            C.FunnelOutcome("r", "a2", exc=("T", DEVICE_THROTTLE_TEXT)),
            C.FunnelOutcome("r", "a3", exc=("L", "no invokers")),
            C.FunnelOutcome("c", aid.asString, resp=act.to_json()),
            C.FunnelOutcome("c", "a5"),
            C.FunnelOutcome("f", "a6", err=True)]
    raw = C.FunnelAckMessage(7, 3, rows).serialize()
    kind, frame = C.parse_batch(raw)
    assert kind == C.KIND_FUNNEL_ACK
    assert (frame.origin, frame.epoch) == (7, 3)
    assert [r.code for r in frame.rows] == list("prrccf")
    assert frame.rows[1].exc == ("T", DEVICE_THROTTLE_TEXT)
    assert frame.rows[2].exc == ("L", "no invokers")
    back = S.E.WhiskActivation.from_json(frame.rows[3].resp)
    assert back.activation_id.asString == aid.asString
    assert frame.rows[4].resp is None and frame.rows[5].err is True


def _wire_rows(pkg):
    from test_torch_messaging import build
    return [build(pkg, "activation", k) for k in range(6)]


def test_funnel_balancers_ship_byte_identical_frames():
    """The same rows through each package's FunnelBalancer: the `fun1`
    frames on `ctrlfunnel0` are the same bytes."""
    from test_torch_messaging import JAX_PKG, PORT_PKG

    async def capture(S, pkg):
        provider = S.Mem.MemoryMessagingProvider()
        fe = _frontend(S, provider, depth=64, retry_seconds=30.0)
        await fe.start()
        msgs = _wire_rows(pkg)
        action = make_action(S, "fx", memory=128)
        fe.publish_many([(action, m) for m in msgs[:4]])
        fe.publish_many([(action, m) for m in msgs[4:]])
        await asyncio.sleep(0.1)
        consumer = provider.get_consumer(S.Funnel.funnel_topic(0), "cap")
        frames = [p for *_x, p in await consumer.peek(16, timeout=0.2)]
        await fe.close()
        return frames

    jax_frames = run(capture(side("jax"), JAX_PKG))
    port_frames = run(capture(side("port"), PORT_PKG))
    assert len(jax_frames) == 2 and port_frames == jax_frames


def test_funnel_receivers_answer_byte_identical_outcome_frames():
    """One `fun1` frame into each package's FunnelReceiver over a stub
    balancer that throttles: the `funA` frames back are the same bytes."""
    from test_torch_messaging import JAX_PKG, PORT_PKG

    async def capture(S, pkg):
        provider = S.Mem.MemoryMessagingProvider()
        recv = _receiver(S, provider, StubBalancer(S, "throttle"))
        recv.start()
        consumer = provider.get_consumer(S.Funnel.funnel_ack_topic(7), "cap")
        await consumer.peek(1, timeout=0.01)
        await provider.get_producer().send(
            S.Funnel.funnel_topic(0),
            S.Col.FunnelBatchMessage(_wire_rows(pkg), 7, 1, 0))
        frames = []
        for _ in range(50):
            frames += [p for *_x, p in await consumer.peek(16, timeout=0.05)]
            if frames:
                break
        await recv.stop()
        return frames

    jax_frames = run(capture(side("jax"), JAX_PKG))
    port_frames = run(capture(side("port"), PORT_PKG))
    assert jax_frames and port_frames == jax_frames


# -- the receiver -----------------------------------------------------------------
@both
def test_partial_dedupe_replay(S):
    async def go():
        provider = S.Mem.MemoryMessagingProvider()
        bal = StubBalancer(S)
        recv = _receiver(S, provider, bal)
        recv.start()
        producer = provider.get_producer()
        _action, msgs = _msgs(S, 3)
        a, b, c = msgs
        topic = S.Funnel.funnel_topic(0)
        await producer.send(topic, S.Col.FunnelBatchMessage([a, b], 7, 1, 0))
        await until(lambda: len(bal.placed) == 2)
        await producer.send(topic,
                            S.Col.FunnelBatchMessage([a, b, c], 7, 1, 0))
        await until(lambda: len(bal.placed) == 3)
        await asyncio.sleep(0.05)
        placed, dups = list(bal.placed), recv.dup_rows
        await recv.stop()
        return placed, dups, [m.activation_id.asString for m in msgs]

    placed, dups, aids = run(go())
    assert placed == aids and dups == 2


@both
def test_stale_epoch_refuses_whole_frame(S):
    async def go():
        provider = S.Mem.MemoryMessagingProvider()
        bal = StubBalancer(S)
        bal.fence_epoch = 3
        recv = _receiver(S, provider, bal)
        recv.start()
        acks = []
        consumer = provider.get_consumer(S.Funnel.funnel_ack_topic(7), "t")
        producer = provider.get_producer()

        async def drain():
            while True:
                for _t, _p, _o, payload in await consumer.peek(
                        16, timeout=0.05):
                    acks.extend(S.Col.parse_batch(payload)[1].rows)
                consumer.commit()
                await asyncio.sleep(0.01)

        drainer = asyncio.get_event_loop().create_task(drain())
        _action, msgs = _msgs(S, 4)
        topic = S.Funnel.funnel_topic(0)
        await producer.send(topic, S.Col.FunnelBatchMessage(msgs[:2], 7, 1, 2))
        await producer.send(topic,
                            S.Col.FunnelBatchMessage(msgs[2:3], 7, 2, 4))
        await until(lambda: len(acks) >= 3)
        await producer.send(topic, S.Col.FunnelBatchMessage(msgs[3:], 7, 3, 3))
        await until(lambda: len(bal.placed) == 1)
        await asyncio.sleep(0.05)
        drainer.cancel()
        out = (list(bal.placed), list(acks), recv.stale_frames)
        await recv.stop()
        return out

    placed, acks, stale = run(go())
    assert len(placed) == 1 and stale == 2
    refusals = [r for r in acks if r.code == "r"]
    assert len(refusals) == 3
    texts = {r.exc[1] for r in refusals}
    assert S.Funnel.stale_epoch_text(2, 3) in texts
    assert S.Funnel.stale_epoch_text(4, 3) in texts
    assert all(r.exc[0] == "L" for r in refusals)


# -- the front end ---------------------------------------------------------------
@both
def test_backpressure_429_exact_serial_text(S):
    async def go():
        provider = S.Mem.MemoryMessagingProvider()
        fe = _frontend(S, provider, depth=2)
        await fe.start()
        action, msgs = _msgs(S, 3)
        outs = fe.publish_many([(action, m) for m in msgs])
        assert outs[2].done()
        with pytest.raises(S.Base.LoadBalancerThrottleException) as ei:
            outs[2].result()
        await fe.close()
        return str(ei.value)

    assert run(go()) == S.Ent.CONCURRENT_LIMIT_MESSAGE


def _run_hop(S, mode, blocking=True, n=1):
    async def go():
        provider = S.Mem.MemoryMessagingProvider()
        bal = StubBalancer(S, mode)
        recv = _receiver(S, provider, bal)
        recv.start()
        fe = _frontend(S, provider)
        await fe.start()
        action, msgs = _msgs(S, n, blocking=blocking)
        outs = fe.publish_many([(action, m) for m in msgs])
        results = []
        for out, m in zip(outs, msgs):
            try:
                promise = await asyncio.wait_for(out, 8)
            except Exception as e:  # noqa: BLE001 — the assertion
                results.append(e)
                continue
            if mode == "place":
                aid = m.activation_id.asString
                await until(lambda a=aid: a in bal.promises)
                bal.promises[aid].set_result(_activation(S, m.activation_id))
            try:
                results.append(await asyncio.wait_for(promise, 8))
            except Exception as e:  # noqa: BLE001
                results.append(e)
        stats = (fe.rows_sent, fe.total_active_activations,
                 recv.rows_received)
        await fe.close()
        await recv.stop()
        return results, stats

    return run(go())


@both
def test_device_throttle_text_survives_hop(S):
    (exc,), _ = _run_hop(S, "throttle")
    assert isinstance(exc, S.Base.LoadBalancerThrottleException)
    assert str(exc) == DEVICE_THROTTLE_TEXT


@both
def test_standby_refusal_text_survives_hop(S):
    (exc,), _ = _run_hop(S, "standby")
    assert isinstance(exc, S.Base.LoadBalancerException)
    assert not isinstance(exc, S.Base.LoadBalancerThrottleException)
    assert str(exc) == STANDBY_TEXT


@both
def test_blocking_completion_roundtrip(S):
    results, (rows_sent, in_flight, rows_received) = _run_hop(
        S, "place", blocking=True, n=3)
    assert len(results) == 3
    for act in results:
        assert isinstance(act, S.E.WhiskActivation)
        assert act.response.result == {"ok": 1}
    assert rows_sent == 3 and rows_received == 3 and in_flight == 0


def _lossy(recv):
    dropped = []
    orig = recv._consume

    async def lossy(payload):
        if not dropped:
            dropped.append(payload)
            return
        await orig(payload)

    recv._consume = lossy
    return dropped


@both
def test_retry_reships_lost_frame_no_double_execution(S):
    async def go():
        provider = S.Mem.MemoryMessagingProvider()
        bal = StubBalancer(S)
        recv = _receiver(S, provider, bal)
        dropped = _lossy(recv)
        recv.start()
        fe = _frontend(S, provider, depth=64, retry_seconds=0.15,
                       max_retries=3)
        await fe.start()
        action, msgs = _msgs(S, 2, blocking=True)
        outs = fe.publish_many([(action, m) for m in msgs])
        promises = await asyncio.wait_for(asyncio.gather(*outs), 8)
        for m in msgs:
            bal.promises[m.activation_id.asString].set_result(
                _activation(S, m.activation_id))
        acts = await asyncio.wait_for(asyncio.gather(*promises), 8)
        out = (list(bal.placed), fe.frame_retries, len(dropped),
               [a.activation_id.asString for a in acts])
        await fe.close()
        await recv.stop()
        return out

    placed, retries, dropped, aids = run(go())
    assert dropped == 1 and retries >= 1
    assert sorted(placed) == sorted(aids)
    assert len(placed) == len(set(placed)) == 2


@both
def test_retry_exhaustion_fails_rows_503(S):
    async def go():
        provider = S.Mem.MemoryMessagingProvider()
        fe = _frontend(S, provider, depth=8, retry_seconds=0.05,
                       max_retries=1)
        await fe.start()
        action, msgs = _msgs(S, 1)
        (out,) = fe.publish_many([(action, msgs[0])])
        with pytest.raises(S.Base.LoadBalancerException) as ei:
            await asyncio.wait_for(out, 8)
        stats = (fe.rows_timed_out, fe.total_active_activations)
        await fe.close()
        return str(ei.value), stats

    text, (timed_out, in_flight) = run(go())
    assert "no outcome from balancer" in text
    assert timed_out == 1 and in_flight == 0


@both
def test_forced_timeout_surfaces_as_active_ack_timeout(S):
    async def go():
        provider = S.Mem.MemoryMessagingProvider()
        bal = StubBalancer(S)
        recv = _receiver(S, provider, bal)
        recv.start()
        fe = _frontend(S, provider)
        await fe.start()
        action, msgs = _msgs(S, 1, blocking=True)
        (out,) = fe.publish_many([(action, msgs[0])])
        promise = await asyncio.wait_for(out, 8)
        aid = msgs[0].activation_id.asString
        await until(lambda: aid in bal.promises)
        bal.promises[aid].set_exception(
            S.Base.ActiveAckTimeout(msgs[0].activation_id))
        with pytest.raises(S.Base.ActiveAckTimeout):
            await asyncio.wait_for(promise, 8)
        await fe.close()
        await recv.stop()
        return True

    assert run(go())


@both
def test_partial_dedupe_replay_over_tcp(S):
    async def go():
        T = side("port")
        server = T.Tcp.TcpBusServer("127.0.0.1", 0)
        await server.start()
        port = server._server.sockets[0].getsockname()[1]
        try:
            bal = StubBalancer(S)
            recv = _receiver(S, S.Tcp.TcpMessagingProvider("127.0.0.1", port),
                             bal)
            dropped = _lossy(recv)
            recv.start()
            fe = _frontend(S, S.Tcp.TcpMessagingProvider("127.0.0.1", port),
                           depth=64, retry_seconds=0.2, max_retries=4)
            await fe.start()
            action, msgs = _msgs(S, 3, blocking=True)
            outs = fe.publish_many([(action, m) for m in msgs])
            promises = await asyncio.wait_for(asyncio.gather(*outs), 15)
            for m in msgs:
                aid = m.activation_id.asString
                await until(lambda a=aid: a in bal.promises)
                bal.promises[aid].set_result(_activation(S, m.activation_id))
            acts = await asyncio.wait_for(asyncio.gather(*promises), 15)
            out = (list(bal.placed), fe.frame_retries, len(acts),
                   len(dropped))
            await fe.close()
            await recv.stop()
            return out
        finally:
            await server.stop()

    placed, retries, n_acts, dropped = run(go(), 60)
    assert dropped == 1 and retries >= 1
    assert len(placed) == len(set(placed)) == 3 and n_acts == 3


# -- across the packages -----------------------------------------------------------
@pytest.mark.parametrize("front,back", [("jax", "port"), ("port", "jax")],
                         ids=["jax_frontend_port_balancer",
                              "port_frontend_jax_balancer"])
def test_a_frontend_funnels_to_the_other_packages_balancer(front, back):
    """Over one TCP bus: the `front` package's FunnelBalancer ships 4
    blocking and 4 non-blocking invokes to the `back` package's
    FunnelReceiver over its TpuBalancer and simulated invokers; every
    blocking invoke returns its activation, every row runs once."""
    F, B = side(front), side(back)

    async def go():
        T = side("port")
        server = T.Tcp.TcpBusServer("127.0.0.1", 0)
        await server.start()
        port = server._server.sockets[0].getsockname()[1]
        pb = B.Tcp.TcpMessagingProvider("127.0.0.1", port)
        pf = F.Tcp.TcpMessagingProvider("127.0.0.1", port)
        bal = balancer(B, pb)
        await bal.start()
        invokers, producer = await fleet(B, pb, 2)
        recv = fe = None
        try:
            await ping_all(invokers, producer, [bal])
            recv = _receiver(B, pb, bal)
            recv.start()
            fe = _frontend(F, pf, depth=64, retry_seconds=5.0)
            await fe.start()
            action = make_action(F, "fx", memory=128)
            ident = F.E.Identity.generate("guest")
            msgs = [make_msg(F, action, ident, blocking=k < 4)
                    for k in range(8)]
            outs = fe.publish_many([(action, m) for m in msgs])
            promises = await asyncio.wait_for(asyncio.gather(*outs), 20)
            acts = await asyncio.wait_for(asyncio.gather(*promises[:4]), 20)
            await until(lambda: sum(len(i.handled) for i in invokers) >= 8,
                        timeout=10.0)
            handled = [m.activation_id.asString for i in invokers
                       for m in i.handled]
            return ([type(a).__module__.split(".")[0] for a in acts],
                    [a.activation_id.asString for a in acts],
                    [m.activation_id.asString for m in msgs], handled)
        finally:
            if fe is not None:
                await fe.close()
            if recv is not None:
                await recv.stop()
            await stop_all([bal], invokers)
            await server.stop()

    roots, act_aids, aids, handled = run(go(), 90)
    assert roots == [F.root] * 4
    assert act_aids == aids[:4]
    assert sorted(handled) == sorted(aids), "every row runs exactly once"
