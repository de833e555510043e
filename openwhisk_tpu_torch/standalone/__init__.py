"""Standalone server: controller + the TPU (or lean) balancer + in-process
invoker.

The port's counterpart of `openwhisk_tpu/standalone/__init__.py` (rebuild
of core/standalone/.../StandaloneOpenWhisk.scala): a single process serving
the full API on one port with an in-memory (or sqlite) store, the
in-memory bus, the port's `TpuBalancer` placing on the card, and an
in-process InvokerReactive running subprocess action sandboxes. Boots with
a `guest` identity whose credentials are printed (and stable for dev use).

The TPU balancer runs on the CUDA card unless the caller asks for the CPU
(`device="cpu"`, the plain torch path); without a card the default raises.
Its books can be checkpointed and journaled (`snapshot_path`,
`journal_dir`): restored at boot, dumped at a clean shutdown. The port's
default balancer is `tpu`, the path on the card; the JAX package's
standalone defaults to `lean` (in-process dispatch, no device), which the
port offers as `balancer="lean"`.
"""
from __future__ import annotations

import asyncio
from typing import Optional

from ..containerpool import ContainerPoolConfig
from ..containerpool.logstore import ContainerLogStore
from ..containerpool.process_factory import ProcessContainerFactory
from ..controller.core import Controller
from ..controller.loadbalancer.lean import LeanBalancer
from ..controller.loadbalancer.tpu_balancer import TpuBalancer
from ..core.entity import (BasicAuthenticationAuthKey, ControllerInstanceId,
                           EntityName, ExecManifest, Identity, InvokerInstanceId,
                           MB, Namespace, Secret, Subject, UUID, WhiskAuthRecord)
from ..database import ArtifactActivationStore, EntityStore
from ..invoker.reactive import InvokerReactive
from ..messaging.memory import MemoryMessagingProvider
from ..utils.logging import Logging

# stable dev credentials (standalone/dev only, like the reference's guest key)
GUEST_UUID = "2c9f4ad1-4a5e-4d7e-9b11-2c9f4ad10e66"
GUEST_KEY = "tpu-native-openwhisk-standalone-guest-key-0123456789abcdef012345"

#: balancers the port's standalone can assemble
BALANCERS = ("tpu", "lean")


def guest_identity() -> Identity:
    return Identity(Subject("guest-subject"),
                    Namespace(EntityName("guest"), UUID(GUEST_UUID)),
                    BasicAuthenticationAuthKey(UUID(GUEST_UUID), Secret(GUEST_KEY)))


def make_balancer(provider, instance: ControllerInstanceId, logger: Logging,
                  device=None, **balancer_kw) -> TpuBalancer:
    """The standalone's balancer: every invoker in the managed partition,
    placement on `device` (None means the card)."""
    return TpuBalancer(provider, instance, logger=logger,
                       metrics=logger.metrics, managed_fraction=1.0,
                       blackbox_fraction=0.0, device=device, **balancer_kw)


async def make_standalone(port: int = 3233, artifact_store=None,
                          user_memory_mb: int = 2048, logger=None,
                          prewarm: bool = False, manifest: Optional[dict] = None,
                          balancer: str = "tpu", ui: bool = True,
                          device=None, invoker: bool = True,
                          messaging_provider=None,
                          snapshot_path: Optional[str] = None,
                          snapshot_interval: float = 10.0,
                          journal_dir: Optional[str] = None,
                          **controller_kw) -> Controller:
    """Assemble and start a standalone server; returns the running Controller.

    balancer: "tpu", the port's device placement balancer fed by the
    in-process invoker's health pings, or "lean" (in-process dispatch, no
    supervision — the reference's LeanBalancer mode; `device`, `invoker`
    and the snapshot/journal arguments do not apply to it). device: None
    or "cuda" for the card, "cpu" for the plain torch path. invoker=False
    leaves the invoker out, for callers that attach invokers of their own
    to the bus, which they may pass as `messaging_provider` (default: a
    fresh in-memory bus).
    Extra keyword arguments pass through to Controller (e.g.
    invocations_per_minute for perf runs that must not trip the default
    throttles).

    snapshot_path/journal_dir: checkpoint/journal the balancer's books —
    restored at boot (snapshot + deterministic journal tail replay) and
    dumped one final time on a clean shutdown, wired through
    Controller.owned_resources so SIGTERM cannot skip the final dump."""
    if balancer not in BALANCERS:
        raise ValueError(f"unknown balancer {balancer!r}; "
                         f"choose from {BALANCERS}")
    logger = logger or Logging(level="warn")
    ExecManifest.initialize(manifest)
    provider = messaging_provider or MemoryMessagingProvider()
    instance = ControllerInstanceId("0")

    async def invoker_factory(invoker_id, messaging_provider):
        store = controller.artifact_store
        inv = InvokerReactive(
            invoker_id, messaging_provider,
            EntityStore(store),
            ArtifactActivationStore(store),
            ProcessContainerFactory(logger=logger),
            pool_config=ContainerPoolConfig(user_memory=MB(user_memory_mb),
                                            pause_grace=1.0),
            logstore=ContainerLogStore(), logger=logger)
        await inv.start(start_prewarm=prewarm)
        return inv

    journal = None
    snapshotter = None
    if balancer == "lean":
        # metrics=logger.metrics: the controller serves this emitter at
        # /metrics — sharing it puts the lean balancer's counters AND its
        # telemetry histogram families on the scrape page
        lb = LeanBalancer(provider, instance, invoker_factory, logger=logger,
                          metrics=logger.metrics,
                          user_memory=MB(user_memory_mb))
    else:
        lb = make_balancer(provider, instance, logger, device=device)
    if balancer == "tpu" and (snapshot_path or journal_dir):
        from ..controller.loadbalancer.checkpoint import (
            BalancerSnapshotter, load_snapshot)
        if journal_dir:
            from ..controller.loadbalancer.journal import journal_from_config
            journal = journal_from_config(journal_dir, logger=logger)
            if journal is not None:
                lb.attach_journal(journal)
        load_snapshot(lb, snapshot_path or "", logger, journal=journal)
        if snapshot_path:
            snapshotter = BalancerSnapshotter(
                lb, snapshot_path, snapshot_interval, logger,
                journal=journal).start()
    if ui and "extra_routes" not in controller_kw:
        # playground dev UI beside /api/v1 (ref standalone PlaygroundLauncher)
        from .playground import playground_routes
        controller_kw["extra_routes"] = playground_routes(GUEST_UUID, GUEST_KEY)
    controller = Controller(instance, provider, artifact_store=artifact_store,
                            logger=logger, load_balancer=lb, **controller_kw)
    if snapshotter is not None:
        # Controller.stop() drains owned_resources BEFORE closing the
        # balancer: the final dump always sees live books, and the SIGTERM
        # path (utils.tasks.wait_for_shutdown -> controller.stop) cannot
        # skip it
        controller.owned_resources.append(snapshotter)
    if journal is not None:
        class _JournalCloser:
            async def stop(self_inner) -> None:
                await asyncio.to_thread(journal.close)

        controller.owned_resources.append(_JournalCloser())
    # seed the guest identity
    ident = guest_identity()
    await controller.auth_store.put(
        WhiskAuthRecord(ident.subject, [ident.namespace], [ident.authkey]))
    await controller.start(port=port)
    if balancer == "tpu" and invoker:
        # the balancer talks to invokers over the bus + health pings: boot
        # the in-process invoker beside it and wait for its first ping
        inv = await invoker_factory(
            InvokerInstanceId(0, unique_name="standalone",
                              user_memory=MB(user_memory_mb)), provider)
        controller.owned_resources.append(inv)
        for _ in range(100):
            if any(lb._healthy):
                break
            await asyncio.sleep(0.05)
    return controller
