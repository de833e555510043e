"""The shared admission funnel's hop, held to the JAX package by counts.

The fault (ROADMAP Queue 3 item 12): the port's balancer held its event
loop for milliseconds a step folding releases as torch ops: about fifteen
small ops a row below 32 rows (`ops/placement.py` `release_batch`), and
at 32 rows and more some forty ops and a host read of the heterogeneous
residue (`release_batch_vector`). The JAX package folds releases inside
the step's one XLA program. In the funnel process the loop also carries
the bus broker and the outcome frames, each one broker round trip on one
connection, so the frames queued behind the steps (1.7-10 s on an H100)
and rows failed after the funnel's retries. The repair: one launch of the
release kernel (`csrc/release_fold.cu`) a fold at every bucket, and two
named cuts of `funnel.py`: one outcome frame in flight an origin at the
receiver, one frame in flight at each front end.

Each package's `FunnelReceiver` and `TpuBalancer` take the same fixed
sequence of `fun1` frames in process (the same seed, activation ids,
actions and 16 simulated invokers), one wave at a time: a frame, its
placements and their outcomes sent, one batch of acks, its completion
outcomes, then the next frame. No clock decides anything that is
asserted: the acks wait for every placement outcome (an invoker can
handle a row before the bus's flush resolves its placement, and on a
loaded core an earlier ack interleaved the two kinds of outcome rows by
the loop's timing). Asserted:

  * the same decisions (invoker a row) and the same outcome rows, in
    order, to each origin, in both packages; no more steps in the port
    than in the reference, with the same rows a step;
  * the host syncs a step the balancer makes on its loop: none in either
    package (the reference's step is one XLA dispatch);
  * the launches a step as the card sees them (the port's balancer built
    with the card's kernel pair, whose wrappers run their plain versions
    on CPU tensors): every torch op on the loop that is not a view, and
    one for each kernel wrapper's call. The release fold is one of them
    at every bucket, so a step's launches do not grow with its rows;
  * the receiver's cut: one outcome frame in flight an origin, the rows
    it earns meanwhile in the next frame, where the reference ships a
    frame a flush;
  * the front end's cut, over a producer that holds each send: the waves
    admitted behind a frame in flight leave as one frame when it lands,
    where the reference ships a frame a wave; and behind a frame that
    never lands every row still fails on the reference's retry clock,
    counted from its admission.
"""
import asyncio
import statistics
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from torch._ops import OpOverload  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch_ha_cases import (balancer, fleet, make_action,  # noqa: E402
                            make_msg, ping_all, side, stop_all, until)

#: (origin, rows) a frame: buckets 8, 8, 16, 64, 64, 8, 256 and 32 on the
#: request axis, the scan below 32 rows and the repair from 32 on
WAVES = ((100, 1), (101, 3), (100, 12), (101, 40), (100, 64), (101, 5),
         (100, 130), (101, 32))
N_INVOKERS = 16
#: kernel wrappers of the card's pair, each one launch on the card
WRAPPERS = ("schedule_batch_cuda", "schedule_batch_repair_cuda",
            "release_batch_cuda")
#: the aten ops that read a device value back on the host
SYNC_OPS = ("_local_scalar_dense", "nonzero", "is_nonzero", "equal",
            "masked_select", "unique", "_unique2")
#: the most launches a step of the port may make on the card: its packing
#: views and casts, the health fold, the two kernels and the output pack
MAX_LAUNCHES_A_STEP = 40


def run(coro, timeout=120.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


class LoopCounts(TorchDispatchMode):
    """Counts the torch ops of the balancer's steps on the event loop:
    launches (ops that are not views, plus one a kernel wrapper's call,
    whose own ops are the card's one launch) and host syncs."""

    def __init__(self):
        super().__init__()
        self.launches = 0
        self.syncs = 0
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused and isinstance(func, OpOverload):
            name = func._schema.name.split("::")[-1]
            if name in SYNC_OPS:
                self.syncs += 1
            if not func.is_view:
                self.launches += 1
        return func(*args, **(kwargs or {}))


def _count_steps(S, monkeypatch, log):
    """Record each step of S's balancer: its rows, and for the port its
    launches and host syncs (for the JAX package its host reads of device
    arrays) on the loop."""
    orig = S.TB.TpuBalancer._dispatch_batch
    loop_thread = threading.current_thread()
    jax_reads = [0]
    in_step = [False]
    if S.name == "jax":
        from jax._src import array as JA
        value = JA.ArrayImpl._value

        def read(self):
            if in_step[0] and threading.current_thread() is loop_thread:
                jax_reads[0] += 1
            return value.fget(self)

        monkeypatch.setattr(JA.ArrayImpl, "_value", property(read))

    def step(self):
        rows = min(len(self._pending), self.max_batch)
        in_step[0] = True
        try:
            if S.name == "port":
                mode = log.setdefault("mode", LoopCounts())
                before = (mode.launches, mode.syncs)
                with mode:
                    orig(self)
                log["steps"].append((rows, mode.launches - before[0],
                                     mode.syncs - before[1]))
            else:
                before = jax_reads[0]
                orig(self)
                log["steps"].append((rows, None, jax_reads[0] - before))
        finally:
            in_step[0] = False

    monkeypatch.setattr(S.TB.TpuBalancer, "_dispatch_batch", step)


def _card_pair(S, monkeypatch, log):
    """The port's balancer with the card's kernel pair: each kernel
    wrapper's call counts one launch, and its plain version (the wrapper's
    path for CPU tensors) runs uncounted."""
    monkeypatch.setattr(S.TB, "device_pair",
                        lambda device, kind: S.TB._cuda_pair(kind))
    for name in WRAPPERS:
        fn = getattr(S.TB, name, None)
        if fn is None:
            continue

        def launch(*a, _fn=fn, _name=name, **k):
            mode = log.get("mode")
            if mode is None:
                return _fn(*a, **k)
            mode.launches += 1
            log["wrapper_calls"][_name] = log["wrapper_calls"].get(_name,
                                                                   0) + 1
            mode.paused += 1
            try:
                return _fn(*a, **k)
            finally:
                mode.paused -= 1

        monkeypatch.setattr(S.TB, name, launch)


def _actions(S):
    return [S.E.ExecutableWhiskAction(
        S.E.EntityPath("guest"), S.E.EntityName(f"ol{i}"),
        S.E.CodeExec(kind="python:3", code="x"),
        limits=S.E.ActionLimits(
            S.E.TimeLimit(5000), S.E.MemoryLimit(S.E.MB(128 * (1 + i % 2))),
            concurrency=S.E.ConcurrencyLimit(4 if i % 4 == 3 else 1)))
        for i in range(8)]


def _frames(S, actions):
    """The fixed frames: deterministic activation ids, rows over the 8
    actions by a seeded draw."""
    rng = np.random.RandomState(16)
    ident = S.E.Identity.generate("guest")
    frames, k = [], 0
    for seq, (origin, rows) in enumerate(WAVES):
        msgs = []
        for _ in range(rows):
            a = actions[int(rng.randint(0, len(actions)))]
            k += 1
            msgs.append(S.Msg.ActivationMessage(
                S.Tx.TransactionId(), a.fully_qualified_name, a.rev.rev,
                ident, S.E.ActivationId(f"{k:032x}"),
                S.E.ControllerInstanceId("0"), True, {}))
        frames.append((origin, S.Col.FunnelBatchMessage(
            msgs, origin=origin, seq=seq, epoch=0).serialize(), msgs))
    return frames


def _drive(S, monkeypatch):
    """The fixed frames through S's receiver and balancer, one wave at a
    time; returns what the test compares."""
    monkeypatch.setattr(S.E.ConcurrencyLimit, "MAX", 16)
    log = {"steps": [], "wrapper_calls": {}}
    _count_steps(S, monkeypatch, log)
    if S.name == "port":
        _card_pair(S, monkeypatch, log)
    actions = _actions(S)
    for a in actions:
        a.rev = S.Ids.DocRevision("1-b")
    by_name = {str(a.fully_qualified_name): a for a in actions}

    async def go():
        provider = S.Mem.MemoryMessagingProvider()
        bal = balancer(S, provider)
        await bal.start()
        invokers, producer = await fleet(S, provider, N_INVOKERS,
                                         memory_mb=4096, ack=False)
        await ping_all(invokers, producer, [bal])

        async def resolver(name, rev):
            return by_name[name]

        recv = S.Funnel.FunnelReceiver(
            provider, S.E.ControllerInstanceId("0"), bal, resolver=resolver)
        sent = []
        send = recv.sender.send_frame

        def send_frame(topic, message, *a, **k):
            sent.append((topic, [(r.aid, r.code) for r in message.rows]))
            return send(topic, message, *a, **k)

        recv.sender.send_frame = send_frame
        decisions = {}
        try:
            handled = 0
            for origin, payload, msgs in _frames(S, actions):
                await ping_all(invokers, producer, [bal])
                await recv._consume(payload)
                handled += len(msgs)
                assert await until(lambda: sum(
                    len(i.handled) for i in invokers) == handled), \
                    "placements did not reach the invokers"
                want = {m.activation_id.asString for m in msgs}

                def sent_with(code):
                    done = {aid for _t, rows in sent for aid, c in rows
                            if c == code}
                    return want <= done and not recv._ack_buf

                # the acks wait for every placement outcome (docstring)
                assert await until(lambda: sent_with(S.Col.FUNNEL_PLACED)), \
                    "placement outcomes were not sent"
                acks, now = [], time.time()
                for inv in invokers:
                    for m in inv.handled:
                        aid = m.activation_id.asString
                        if aid in decisions:
                            continue
                        decisions[aid] = inv.instance.instance
                        act = S.E.WhiskActivation(
                            S.E.EntityPath("guest"), m.action.name,
                            m.user.subject, m.activation_id, now, now,
                            S.E.ActivationResponse.success({"ok": True}),
                            duration=1)
                        acks.append(S.Msg.CombinedCompletionAndResultMessage(
                            m.transid, act, inv.instance))
                acks.sort(key=lambda a: a.activation_id.asString)
                bal.process_acknowledgements(acks)
                assert await until(
                    lambda: sent_with(S.Col.FUNNEL_COMPLETED)), \
                    "outcomes were not sent"
                assert await until(lambda: not (
                    bal._pending or bal._inflight_steps or bal._readbacks
                    or bal._releases)), "the balancer did not drain"
                await asyncio.sleep(0.05)
            return decisions, sent
        finally:
            await stop_all([bal], invokers)

    decisions, sent = run(go())
    per_origin = {}
    for topic, rows in sent:
        per_origin.setdefault(topic, []).extend(rows)
    return dict(decisions=decisions, frames=len(sent), outcomes=per_origin,
                steps=log["steps"], wrappers=log["wrapper_calls"])


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for name in ("jax", "port"):
            out[name] = _drive(side(name), mp)
            mp.undo()
    finally:
        mp.undo()
    return out


def test_same_frames_give_the_same_decisions_and_outcome_rows(runs):
    ref, port = runs["jax"], runs["port"]
    rows = sum(r for _o, r in WAVES)
    assert len(ref["decisions"]) == len(port["decisions"]) == rows
    assert port["decisions"] == ref["decisions"]
    assert port["outcomes"] == ref["outcomes"]
    col = side("port").Col
    for out in (ref, port):
        for rows_to_origin in out["outcomes"].values():
            codes = [c for _a, c in rows_to_origin]
            assert codes.count(col.FUNNEL_PLACED) == \
                codes.count(col.FUNNEL_COMPLETED) == len(codes) // 2
    assert port["frames"] <= ref["frames"]


def test_no_more_steps_than_the_reference_and_the_same_rows_a_step(runs):
    ref, port = runs["jax"], runs["port"]
    assert len(port["steps"]) <= len(ref["steps"])
    assert [s[0] for s in port["steps"]] == [s[0] for s in ref["steps"]]
    assert [s[0] for s in port["steps"]] == [r for _o, r in WAVES]


def test_no_host_sync_in_a_step_in_either_package(runs):
    assert [s[2] for s in runs["jax"]["steps"]] == [0] * len(WAVES)
    assert [s[2] for s in runs["port"]["steps"]] == [0] * len(WAVES)


def test_a_steps_launches_do_not_grow_with_its_rows(runs):
    port = runs["port"]
    launches = {rows: n for rows, n, _s in port["steps"]}
    assert max(launches.values()) <= MAX_LAUNCHES_A_STEP, launches
    # the scan (below 32 rows) and the repair (from 32 on) differ by the
    # rounds output alone; within each family the count is one number
    scan = {n for rows, n in launches.items() if rows < 32}
    repair = {n for rows, n in launches.items() if rows >= 32}
    assert len(scan) == len(repair) == 1, launches
    # one release kernel and one schedule kernel a step
    steps = len(port["steps"])
    assert port["wrappers"].get("release_batch_cuda", 0) >= steps
    assert (port["wrappers"].get("schedule_batch_cuda", 0)
            + port["wrappers"].get("schedule_batch_repair_cuda", 0)) == steps


@pytest.mark.parametrize("name", ["jax", "port"])
def test_the_receiver_keeps_one_outcome_frame_in_flight_an_origin(name):
    """Outcomes earned over five loop turns while the broker holds the
    first frame: the port ships that frame and then one frame with the
    other four rows; the reference ships five frames."""
    S = side(name)

    async def go():
        provider = S.Mem.MemoryMessagingProvider()
        recv = S.Funnel.FunnelReceiver(provider,
                                       S.E.ControllerInstanceId("0"), None)
        gate = asyncio.Event()
        sent = []

        class HeldProducer:
            async def send(self, topic, message):
                sent.append([r.aid for r in message.rows])
                await gate.wait()

        recv.sender._producer = HeldProducer()
        aids = [f"{k + 1:032x}" for k in range(5)]
        for aid in aids:
            recv._record(7, S.Col.FunnelOutcome(S.Col.FUNNEL_PLACED, aid))
            for _ in range(3):
                await asyncio.sleep(0)
        in_flight = list(sent)
        gate.set()
        await until(lambda: sum(len(f) for f in sent) == len(aids))
        return in_flight, sent, aids

    in_flight, sent, aids = run(go(), timeout=10.0)
    assert [a for f in sent for a in f] == aids
    if name == "port":
        assert in_flight == [aids[:1]]
        assert sent == [aids[:1], aids[1:]]
    else:
        assert sent == [[a] for a in aids]


class HeldProducer:
    """A broker that takes each frame's send and holds it until `gate`
    opens; `sent` lists each send's activation ids."""

    def __init__(self):
        self.gate = asyncio.Event()
        self.sent = []

    async def send(self, topic, message):
        self.sent.append(message.activation_ids)
        await self.gate.wait()


def _front_end(S, retry_seconds):
    """S's funnel front end over a held producer, and a wave maker."""
    fe = S.Funnel.FunnelBalancer(
        S.Mem.MemoryMessagingProvider(), S.E.ControllerInstanceId("1"), 0,
        config=S.Funnel.FunnelConfig(retry_seconds=retry_seconds))
    fe.sender._producer = HeldProducer()
    action = make_action(S)
    ident = S.E.Identity.generate("guest")
    k = [0]

    def wave(rows):
        msgs = []
        for _ in range(rows):
            k[0] += 1
            msgs.append(make_msg(S, action, ident,
                                 aid=S.E.ActivationId(f"{k[0]:032x}")))
        return [m.activation_id.asString for m in msgs], \
            fe.publish_many([(action, m) for m in msgs])

    return fe, wave


@pytest.mark.parametrize("name", ["jax", "port"])
def test_the_front_ends_waves_behind_a_frame_in_flight_leave_as_one(name):
    """Waves admitted on later loop turns while the broker holds the first
    wave's frame: the port ships that frame and then one frame with the
    other waves' rows once it lands; the reference ships a frame a wave.
    No retry fires (the retry window is far off)."""
    S = side(name)

    async def go():
        fe, wave = _front_end(S, retry_seconds=60.0)
        waves = []
        for rows in (2, 1, 3, 2):
            waves.append(wave(rows)[0])
            for _ in range(3):
                await asyncio.sleep(0)
        in_flight = list(fe.sender.producer.sent)
        fe.sender.producer.gate.set()
        await until(lambda: sum(map(len, fe.sender.producer.sent)) == 8)
        for _ in range(3):
            await asyncio.sleep(0)
        out = (in_flight, list(fe.sender.producer.sent), waves,
               fe.frames_sent, fe.rows_sent, fe.frame_retries)
        await fe.close()
        return out

    in_flight, sent, waves, frames, rows, retries = run(go(), timeout=10.0)
    assert rows == 8 and retries == 0
    if name == "port":
        assert in_flight == waves[:1]
        assert sent == [waves[0], waves[1] + waves[2] + waves[3]]
        assert frames == 2
    else:
        assert sent == waves
        assert frames == 4


@pytest.mark.parametrize("name", ["jax", "port"])
def test_the_front_ends_rows_behind_a_stuck_frame_fail_on_the_retry_clock(
        name):
    """The broker takes the first wave's frame and never answers. Every
    row, those of the waves admitted behind it too, fails as the
    reference's do: on its frame's retry clock, started at its admission,
    after `max_retries` + 1 windows of `retry_seconds`, with a 503. In
    the port the later waves' frame waited for the stuck one; its timer
    sent it first, so it went out one time fewer."""
    S = side(name)
    retry = 0.05

    async def go():
        fe, wave = _front_end(S, retry_seconds=retry)
        aids, outs = [], []
        for rows in (2, 1, 3):
            a, o = wave(rows)
            aids += a
            outs += o
            await asyncio.sleep(0)
        done = await asyncio.gather(*outs, return_exceptions=True)
        out = (aids, done, list(fe.sender.producer.sent), fe.rows_timed_out,
               fe.frame_retries, fe.total_active_activations)
        await fe.close()
        return out

    aids, done, sent, timed_out, retries, active = run(go(), timeout=10.0)
    sends = 1 + S.Funnel.FunnelConfig().max_retries
    assert all(isinstance(e, S.Base.LoadBalancerException) for e in done)
    assert all(f"after {sends} sends" in str(e) for e in done), done
    assert timed_out == len(aids) and active == 0
    if name == "port":
        assert sent[0] == aids[:2]
        assert sent.count(aids[:2]) == sends
        assert sent.count(aids[2:]) == sends - 1
        assert len(sent) == 2 * sends - 1
        assert retries == 2 * (sends - 1)
    else:
        # every row was sent `sends` times
        assert sorted(a for f in sent for a in f) == sorted(aids * sends)
        assert retries == 3 * (sends - 1)


@pytest.mark.slow
@pytest.mark.multiproc
def test_the_ports_shared_funnel_p50_at_250_per_s_is_within_3x_the_reference():
    """Three pairs of shared-funnel runs at 250/s (2 workers, 16 invokers,
    `tests/torch_funnel_hop.py`): every row completes in both packages,
    and the port's median p50 is at most 3x the reference's."""
    import torch_funnel_hop as hop
    p50 = {"jax": [], "port": []}
    for _ in range(3):
        for name in ("jax", "port"):
            out = hop.measure(name, 250.0)
            assert out["completed"] == 624, out
            p50[name].append(out["p50_ms"])
    assert statistics.median(p50["port"]) <= \
        3 * statistics.median(p50["jax"]), p50
