"""Both packages side by side for the controller-tier tests (partitions,
HA, spillover, the funnel and the edge): `side("jax")` and `side("port")`
name each package's modules under the same attributes, and the helpers
below build the same balancers, actions, messages and simulated invokers
from either, so one test body runs on both packages (`[jax]` / `[port]`)
and a cross-package case can mix them.

The JAX `TpuBalancer` runs its XLA programs (`kernel="xla"`, no prewarm,
no calibration) and the port's its plain torch path (`device="cpu"`).
"""
import asyncio
import importlib
import time
import types

SIDES = ("jax", "port")

_MODULES = dict(
    E="core.entity", Ids="core.entity.ids", Msg="messaging.message",
    Mem="messaging.memory", Col="messaging.columnar",
    Conn="messaging.connector", Tcp="messaging.tcp",
    Tx="utils.transaction", Parts="utils.partitions",
    Membership="controller.loadbalancer.membership",
    Base="controller.loadbalancer.base", J="controller.loadbalancer.journal",
    CK="controller.loadbalancer.checkpoint",
    Spill="controller.loadbalancer.spillover",
    Funnel="controller.loadbalancer.funnel", Api="controller.api",
    TB="controller.loadbalancer.tpu_balancer", Edge="edge.proxy",
    Ent="controller.entitlement", Anomaly="controller.loadbalancer.anomaly")

_CACHE = {}


def side(name):
    """The package's modules: `name` is "jax" (openwhisk_tpu) or "port"
    (openwhisk_tpu_torch)."""
    if name not in _CACHE:
        root = "openwhisk_tpu" if name == "jax" else "openwhisk_tpu_torch"
        _CACHE[name] = types.SimpleNamespace(
            name=name, root=root,
            **{k: importlib.import_module(f"{root}.{v}")
               for k, v in _MODULES.items()})
    return _CACHE[name]


def balancer(S, provider, instance="0", **kw):
    """The package's TpuBalancer with every invoker managed."""
    kw.setdefault("managed_fraction", 1.0)
    kw.setdefault("blackbox_fraction", 0.0)
    ctrl = S.E.ControllerInstanceId(instance)
    if S.name == "jax":
        return S.TB.TpuBalancer(provider, ctrl, kernel="xla", prewarm=False,
                                calibrate_kernel="off", **kw)
    return S.TB.TpuBalancer(provider, ctrl, device="cpu", **kw)


def make_action(S, name="act", memory=256):
    E = S.E
    a = E.ExecutableWhiskAction(
        E.EntityPath("guest"), E.EntityName(name),
        E.CodeExec(kind="python:3", code="x"),
        limits=E.ActionLimits(E.TimeLimit(5000),
                              E.MemoryLimit(E.MB(memory))))
    a.rev = S.Ids.DocRevision("1-b")
    return a


def make_msg(S, action, ident, blocking=False, aid=None, controller="0"):
    E = S.E
    return S.Msg.ActivationMessage(
        S.Tx.TransactionId(), action.fully_qualified_name, action.rev.rev,
        ident, aid if aid is not None else E.ActivationId.generate(),
        E.ControllerInstanceId(controller), blocking, {})


def ns_for_partition(ring, pid, tag="ns"):
    """A namespace name hashing to `pid` (deterministic hash: scan)."""
    i = 0
    while True:
        ns = f"{tag}{i}"
        if ring.partition_of(ns) == pid:
            return ns
        i += 1


async def until(cond, timeout=8.0, step=0.02):
    for _ in range(int(timeout / step)):
        if cond():
            return True
        await asyncio.sleep(step)
    return cond()


class SimInvoker:
    """A fake invoker of package S: consumes its topic (plain messages and
    columnar batch frames), records each activation and acks it after
    `delay` seconds (`ack=False`: never)."""

    def __init__(self, S, provider, instance, delay=0.0, ack=True):
        self.S = S
        self.provider = provider
        self.instance = instance
        self.delay = delay
        self.ack = ack
        self.handled = []
        self._feed = None
        self._tasks = set()

    async def start(self):
        S = self.S
        topic = self.instance.as_string
        self.provider.ensure_topic(topic)
        consumer = self.provider.get_consumer(topic, topic)
        producer = self.provider.get_producer()
        box = {}

        async def finish(msg):
            if self.delay:
                await asyncio.sleep(self.delay)
            E = S.E
            now = time.time()
            act = E.WhiskActivation(
                E.EntityPath(str(msg.user.namespace.name)), msg.action.name,
                msg.user.subject, msg.activation_id, now, now,
                E.ActivationResponse.success({"ok": True}), duration=1)
            await producer.send(
                f"completed{msg.root_controller_index.as_string}",
                S.Msg.CombinedCompletionAndResultMessage(msg.transid, act,
                                                         self.instance))

        async def handle(payload):
            if S.Col.is_batch_payload(payload):
                _kind, msgs = S.Col.parse_batch(payload)
                box["feed"].consume_extra(len(msgs) - 1)
            else:
                msgs = [S.Msg.ActivationMessage.parse(payload)]
            for msg in msgs:
                self.handled.append(msg)
                if self.ack:
                    task = asyncio.get_event_loop().create_task(finish(msg))
                    self._tasks.add(task)
                    task.add_done_callback(self._tasks.discard)
                box["feed"].processed()

        self._feed = box["feed"] = S.Conn.MessageFeed(
            topic, consumer, 64, handle, long_poll_timeout=0.05)
        self._feed.start()

    async def ping(self, producer):
        await producer.send("health", self.S.Msg.PingMessage(self.instance))

    async def stop(self):
        if self._feed:
            await self._feed.stop()


async def fleet(S, provider, n, memory_mb=2048, **kw):
    invokers = []
    producer = provider.get_producer()
    for i in range(n):
        inv = SimInvoker(S, provider, S.E.InvokerInstanceId(
            i, user_memory=S.E.MB(memory_mb)), **kw)
        await inv.start()
        invokers.append(inv)
    return invokers, producer


async def ping_all(invokers, producer, bals, timeout=8.0):
    """Ping every invoker once; wait until each balancer in `bals` holds
    them all registered and healthy."""
    n = len(invokers)

    def registered():
        return all(len(b._registry) >= n and all(b._healthy[:n])
                   for b in bals)

    # re-ping until registered: a consumer that subscribes over the TCP
    # bus after a ping was published never sees it
    for _ in range(max(1, int(timeout / 0.5))):
        for inv in invokers:
            await inv.ping(producer)
        if await until(registered, timeout=0.5, step=0.005):
            return
    assert registered(), "pings were not handled"


async def drained(bal, timeout=8.0):
    """Until the balancer has nothing queued, in flight or pending."""
    ok = await until(lambda: not (bal._pending or bal._inflight_steps
                                  or bal._readbacks), timeout=timeout,
                     step=0.01)
    assert ok, "the balancer did not drain"


async def stop_all(bals=(), invokers=()):
    for b in bals:
        await b.close()
    for inv in invokers:
        await inv.stop()


def books(bal):
    """Host copies of the balancer's device books (free, conc, health),
    from JAX arrays or torch tensors."""
    import numpy as np
    out = []
    for t in (bal.state.free_mb, bal.state.conc_free, bal.state.health):
        out.append(t.cpu().numpy().copy() if hasattr(t, "cpu")
                   else np.asarray(t).copy())
    return out


class FakeJournal:
    """A journal over a list of records (`records(after_seq)` as
    PlacementJournal's)."""

    def __init__(self, recs):
        self._recs = recs

    def records(self, after_seq=0):
        return iter([r for r in self._recs
                     if int(r.get("seq", 0)) > after_seq or "seq" not in r
                     or int(r.get("seq", 0)) == 0])
