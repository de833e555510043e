"""LoadBalancer SPI + shared bookkeeping.

The counterpart of `openwhisk_tpu/controller/loadbalancer/base.py`
(rebuild of core/controller/.../loadBalancer/LoadBalancer.scala:46-112 and
CommonLoadBalancer.scala), with the parts the TPU balancer's front needs:

  - `publish(action, msg)` returns a future that resolves to the *completion*
    of the activation (the inner future of the reference's
    Future[Future[Either[ActivationId, WhiskActivation]]]).
  - per-activation `ActivationEntry` in `activation_slots` with a
    completion-ack timeout of max(action timeout, 1 min) * timeout_factor
    + timeout_addon (CommonLoadBalancer.scala:103-105); firing the timeout
    force-releases the slot so leaked capacity self-heals.
  - the completion-ack feed (`completed<controller>` topic) disambiguates
    4 ways (:260-346): regular completion, forced-timeout completion, late
    ack after forced completion (only counts toward invoker health), and
    healthcheck acks from system test actions.

  - the system health test action that the supervision sends to an
    unhealthy invoker (ref InvokerSupervision.scala:239-252), and the
    front-door `PublishCoalescer` that hands one event-loop sweep of
    publishes to `publish_many` as one batch.
  - the dispatch producer behind the coalescing wrapper
    (`maybe_coalesce`), columnar ack batch frames through the batched
    completion pass (`BatchedAckConfig`), and the host planes the JAX
    package turns on by default: the placement flight recorder, the
    tail-sampled trace store and the incident recorder's arming (off by
    default), beside the process-wide latency waterfall.

  - the device planes the JAX package turns on by default: completion
    telemetry and SLO burn rates (`TelemetryPlane`), the kernel profiler
    (`KernelProfiler`) and anomaly scoring with its alert engine
    (`AnomalyPlane`), constructed, attached and rendered as there.

  - the HA and partition plane: active/standby leadership
    (`set_leadership`, `fence_epoch`, `ha_standby`, the journal's
    demotion `abandon`), active/active partitions (`set_partition_mode`,
    `set_partition_leadership`, `_partition_refusal` with the spillover
    credential, `partitions_json`) and the fence stamps of
    `prepare_dispatch`.

  - the placement quality plane (`QualityPlane`, off by default): the TPU
    balancer scores its micro-batches on the device, the CPU balancers
    count attribution through `record_placement`; its families render
    on /metrics while it is on.

Events are counted in `counters`, rendered on the metric emitter's page
as `openwhisk_loadbalancer_<event>` counters.
"""
from __future__ import annotations

import asyncio
import time
from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Optional, Union

from ...core.entity import (ActivationId, ExecutableWhiskAction, Identity,
                            InvokerInstanceId, WhiskAction, WhiskActivation)
from ...messaging.connector import MessageFeed, decode_batch, decode_message
from ...messaging.columnar import is_batch_payload
from ...messaging.message import (AcknowledgementMessage, ActivationMessage,
                                  parse_ack)
from ...utils.config import load_config
from ...utils.logging import MetricEmitter
from ...utils.blackbox import GLOBAL_INCIDENTS
from ...utils.eventlog import GLOBAL_EVENT_LOG
from ...utils.tracestore import GLOBAL_TRACE_STORE
from ...utils.tracing import trace_id_of
from ...utils.transaction import TransactionId
from ...utils.waterfall import (GLOBAL_WATERFALL, STAGE_COMPLETION_ACK,
                                ActivationWaterfall)
from ...ops.profiler import KernelProfiler
from ...ops.telemetry import (OUTCOME_ERROR, OUTCOME_SUCCESS, OUTCOME_TIMEOUT)
from .anomaly import AnomalyPlane
from .flight_recorder import BatchRecord, FlightRecorder
from .quality import QualityPlane
from .telemetry import TelemetryPlane

# invoker states (ref InvokerState in InvokerSupervision.scala)
HEALTHY = "up"
UNHEALTHY = "unhealthy"
UNRESPONSIVE = "unresponsive"
OFFLINE = "down"


@dataclass
class InvokerHealth:
    id: InvokerInstanceId
    status: str = HEALTHY
    #: advisory anomaly-plane hint (the name of a firing invoker-scoped
    #: alert) — observability only, never part of usable/status decisions
    hint: Optional[str] = None

    @property
    def usable(self) -> bool:
        return self.status in (HEALTHY,)

    def to_json(self):
        out = {"invoker": self.id.as_string, "status": self.status,
               "userMemory": self.id.user_memory.to_json()}
        if self.hint is not None:
            out["unhealthyHint"] = self.hint
        return out


@dataclass(frozen=True)
class BatchedAckConfig:
    """`CONFIG_whisk_loadBalancer_batchedAck_*` env overrides: the
    batch-shaped completion pipeline's off switch. Off = every ack in a
    batch wire frame replays through the serial per-ack path —
    bit-exact with processing N independent frames."""
    enabled: bool = True

    @classmethod
    def from_env(cls) -> "BatchedAckConfig":
        return load_config(cls, env_path="load_balancer.batched_ack")


class LoadBalancerException(Exception):
    pass


class LoadBalancerThrottleException(LoadBalancerException):
    """The balancer's device rate admission rejected the activation (maps
    to 429 at the API surface, like an entitlement throttle)."""


class ActiveAckTimeout(LoadBalancerException):
    def __init__(self, activation_id: ActivationId):
        super().__init__(f"no completion or active ack received yet for {activation_id}")
        self.activation_id = activation_id


@dataclass
class ActivationEntry:
    id: ActivationId
    namespace_id: str
    invoker: Optional[InvokerInstanceId]
    memory_mb: int
    max_concurrent: int
    action_key: str
    is_blackbox: bool
    is_blocking: bool
    #: monotonic stamp at setup — the trace store's e2e latency base
    t_start: float = 0.0
    #: the waterfall plane's stage vector ([t0_ns, trace_id, s_0..s_N]);
    #: None when the plane is off or the activation entered through a path
    #: that never opened a context
    stages: Optional[list] = None
    #: forced-timeout timer (a TimerHandle; .cancel() like a Task)
    timeout_task: Optional[asyncio.TimerHandle] = None
    promise: Optional[asyncio.Future] = None
    forced: bool = False
    #: TPU balancer only: the device concurrency slot this activation's
    #: acquire returned, so its release lands on exactly that slot even if
    #: the action's key->slot mapping migrates while it is in flight
    conc_slot: Optional[int] = None


class LoadBalancer:
    """SPI surface (ref LoadBalancer.scala:46-78)."""

    async def publish(self, action: ExecutableWhiskAction, msg: ActivationMessage
                      ) -> asyncio.Future:
        """Schedule the activation; returns a future resolving to
        WhiskActivation (completion) or raising ActiveAckTimeout."""
        raise NotImplementedError

    def publish_many(self, pairs: List[tuple]) -> List[asyncio.Future]:
        """The batch-shaped publish SPI: schedule a whole admission batch
        of `(action, msg)` pairs in one call. Returns one future per pair,
        each resolving to what `publish` would have returned (the
        completion promise) or raising what `publish` would have raised.
        This default keeps serial semantics — one `publish` task per pair;
        the TpuBalancer overrides it."""
        return [asyncio.ensure_future(self.publish(action, msg))
                for action, msg in pairs]

    def active_activations_for(self, namespace_id: str) -> int:
        raise NotImplementedError

    @property
    def total_active_activations(self) -> int:
        raise NotImplementedError

    @property
    def cluster_size(self) -> int:
        return 1

    def update_cluster(self, cluster_size: int) -> None:
        """Re-shard capacity on controller join/leave (ref updateCluster,
        ShardingContainerPoolBalancer.scala:561-584)."""

    async def invoker_health(self) -> List[InvokerHealth]:
        raise NotImplementedError

    def occupancy(self) -> dict:
        """Per-invoker memory in use against capacity from the balancer's
        books. Balancers without capacity books answer an empty fleet."""
        from .flight_recorder import occupancy_json
        return occupancy_json(None, [])

    async def close(self) -> None:
        pass


class CommonLoadBalancer(LoadBalancer):
    TIMEOUT_FACTOR = 2
    TIMEOUT_ADDON = 60.0
    STD_TIMEOUT = 60.0

    def __init__(self, messaging_provider, controller_instance, logger=None,
                 metrics: Optional[MetricEmitter] = None,
                 flight_recorder: Optional[FlightRecorder] = None,
                 telemetry: Optional[TelemetryPlane] = None,
                 profiler: Optional[KernelProfiler] = None,
                 anomaly: Optional[AnomalyPlane] = None,
                 waterfall: Optional[ActivationWaterfall] = None,
                 quality: Optional[QualityPlane] = None):
        self.provider = messaging_provider
        self.controller = controller_instance
        self.logger = logger
        self.metrics = metrics or MetricEmitter()
        # the dispatch fan-out producer rides the coalescing wrapper
        # (messaging/coalesce.py): one readback wave's N invoker sends ship
        # as micro-batches (one frame + one ack on the TCP bus) instead of
        # N serialized round trips. CONFIG_whisk_bus_coalesce_enabled=false
        # restores the raw serial producer bit-exactly.
        from ...messaging.coalesce import maybe_coalesce
        self.producer = maybe_coalesce(messaging_provider.get_producer())
        # HA failover plane (membership.py leadership): while `ha_standby`
        # the balancer refuses placement; once active, `fence_epoch` stamps
        # every produced ActivationMessage so invokers can discard a dead
        # epoch's late (zombie) batches. Both default to the non-HA
        # behavior: no stamp, always active.
        self.fence_epoch: Optional[int] = None
        self.ha_standby = False
        # Active/active partitions (loadbalancer/partitions.py): with a
        # ring attached, placement is fenced PER PARTITION — this
        # controller refuses namespaces whose partition it does not own
        # (503, the edge walks to the owner) and stamps (fence_part,
        # per-partition epoch) on every dispatch. ring=None (the default
        # and the CONFIG_whisk_ha_activeActive=false path) keeps every
        # branch below dormant — bit-exact with the single-active path.
        self.partition_ring = None
        self.partition_epochs: Dict[int, int] = {}
        self.owned_partitions: set = set()
        #: pid -> "replaying" | "ready" (the /admin/ready replay-state)
        self.partition_replay: Dict[int, str] = {}
        #: partitions gained but not yet dispatched into — the fleet
        #: timeline's `first_placement` marker. Empty-set check on the hot
        #: path; empty whenever the event log is off.
        self._fp_pending: set = set()
        #: batch-shaped completion pipeline: a batch wire ack
        #: frame is processed in ONE pass (entries, telemetry, waterfall
        #: folds) instead of N per-ack callback hops. False replays each
        #: decoded ack through the serial path — bit-exact.
        self.batched_ack = BatchedAckConfig.from_env().enabled
        self.activation_slots: Dict[str, ActivationEntry] = {}
        self.activations_per_namespace: Dict[str, int] = {}
        self._total = 0
        self._ack_feed: Optional[MessageFeed] = None
        #: ids of system test activations, so their acks disambiguate as
        #: healthchecks
        self._health_probe_ids: set = set()
        #: event counts (the JAX package's `loadbalancer_*` counters)
        self.counters: Counter = Counter()
        self.metrics.register_renderer(self._counters_exposition)
        # the shared introspection plane: every balancer — TPU or CPU —
        # reports placement decisions through this recorder, so the
        # /admin/placement/* endpoints are backend-agnostic
        self.flight_recorder = (flight_recorder if flight_recorder is not None
                                else FlightRecorder.from_config())
        # the shared telemetry plane (same hook pattern): completion
        # latencies/outcomes accumulate per invoker x namespace — on device
        # for the TPU balancer, in the NumPy twin for CPU balancers — and
        # render as Prometheus histogram families on this emitter's page
        self.telemetry = (telemetry if telemetry is not None
                          else TelemetryPlane.from_config())
        self._telemetry_renderer = self._telemetry_exposition
        self.metrics.register_renderer(self._telemetry_renderer)
        # the kernel profiling plane (same hook pattern): compile tracking,
        # per-phase device timing, HBM watermarks and the capture window —
        # device entry points for the TPU balancer, a `kernel: "cpu"`
        # profile for the NumPy twins, one `/admin/profile/*` surface
        self.profiler = (profiler if profiler is not None
                         else KernelProfiler.from_config())
        self.profiler.logger = logger
        self.profiler.metrics = self.metrics
        self._profiler_renderer = self.profiler.prometheus_text
        self.metrics.register_renderer(self._profiler_renderer)
        # the anomaly & alerting plane (same hook pattern): per-invoker
        # straggler/spike scores from the telemetry deltas — on device for
        # the TPU balancer, the NumPy twin for CPU balancers — plus the
        # Prometheus-style alert FSM, evaluated on the supervision tick
        # (lean rides maybe_tick off the completion stream)
        self.anomaly = (anomaly if anomaly is not None
                        else AnomalyPlane.from_config(logger=logger))
        self.anomaly.attach(telemetry=self.telemetry,
                            profiler=self.profiler,
                            invoker_names=self._telemetry_invoker_names)
        self._anomaly_renderer = self.anomaly.prometheus_text
        self.metrics.register_renderer(self._anomaly_renderer)
        # the latency-waterfall plane, process-wide: its stages span layers
        # that never see a balancer (API handler, entitlement, invoker,
        # container pool, record batcher); this hook stamps the completion
        # edge, folds each activation's vector and renders the families
        self.waterfall = (waterfall if waterfall is not None
                          else GLOBAL_WATERFALL)
        self.metrics.register_renderer(self._waterfall_exposition)
        # the placement-quality plane (same hook pattern, default OFF):
        # per-batch regret/imbalance scoring on the device for the TPU
        # balancer, attribution counters off record_placement for the CPU
        # balancers, plus the shadow counterfactual diff
        self.quality = (quality if quality is not None
                        else QualityPlane.from_config())
        self.quality.attach(anomaly=self.anomaly,
                            invoker_names=self._telemetry_invoker_names)
        self.metrics.register_renderer(self._quality_exposition)
        # the tail-sampled trace observatory (same hook pattern,
        # PROCESS-WIDE like the waterfall: spans report from layers that
        # never see a balancer — this hook attaches the reporter tee,
        # wires the completion verdict's live threshold + placement join,
        # and owns the trace_kept/dropped exposition). Disabled config
        # means NOTHING here runs: no tee, no renderer, no attribute but
        # the store reference itself.
        self.trace_store = GLOBAL_TRACE_STORE
        self._trace_renderer = None
        if self.trace_store.enabled:
            self.trace_store.attach()
            wf_threshold = getattr(self.waterfall, "tail_threshold_ms", None)
            if wf_threshold is not None:
                self.trace_store.threshold_source = wf_threshold
            self.trace_store.default_threshold_ms = \
                float(self.telemetry.slo.e2e_p99_ms)
            self.trace_store.placement_lookup = self._trace_placement_lookup
            self._trace_renderer = self.trace_store.prometheus_text
            self.metrics.register_renderer(self._trace_renderer)
        # the incident forensics observatory (process-global
        # like the host observatory, default OFF): alert-triggered
        # black-box bundles joining every plane above. install() is a
        # refused no-op when disabled or already owned — first balancer
        # in a shared test process wins, and only the owner detaches.
        self.incidents = GLOBAL_INCIDENTS
        self._incidents_renderer = None
        if self.incidents.install(balancer=self, owner=self):
            self._incidents_renderer = self.incidents.prometheus_text
            self.metrics.register_renderer(self._incidents_renderer)

    def _counters_exposition(self) -> str:
        return "\n".join(
            f"# TYPE openwhisk_loadbalancer_{name} counter\n"
            f"openwhisk_loadbalancer_{name} {value}"
            for name, value in sorted(self.counters.items()))

    def _waterfall_exposition(self, openmetrics: bool = False) -> str:
        return self.waterfall.prometheus_text(openmetrics=openmetrics)

    def _quality_exposition(self, openmetrics: bool = False) -> str:
        return self.quality.prometheus_text(
            self._telemetry_invoker_names(), openmetrics=openmetrics)

    # -- telemetry plane (shared hook, like the flight recorder) -----------
    def _telemetry_observe(self, entry: ActivationEntry,
                           invoker: Optional[InvokerInstanceId],
                           forced: bool, is_system_error: bool) -> None:
        """Feed one completion into the latency/outcome accumulator. The
        e2e latency is setup->completion-ack; entries restored without a
        stamp (pre-upgrade snapshots) are skipped rather than polluting the
        +Inf bucket."""
        tp = self.telemetry
        if not tp.enabled or entry.t_start <= 0.0:
            return
        inv = invoker or entry.invoker
        if inv is None:
            return
        outcome = (OUTCOME_ERROR if is_system_error
                   else OUTCOME_TIMEOUT if forced else OUTCOME_SUCCESS)
        tp.observe(inv.instance, entry.namespace_id,
                   (time.monotonic() - entry.t_start) * 1e3, outcome)
        # balancers without a supervision scheduler (lean) refresh the burn
        # gauges off the completion stream; tick() is internally 1 Hz-capped
        tp.maybe_tick(self.metrics)
        # the anomaly plane rides the same cadence (no-op within 1 s of a
        # supervision-tick evaluation, so TPU/sharding never double-tick)
        self.anomaly.maybe_tick(self.metrics)

    def _telemetry_invoker_names(self) -> List[str]:
        """Invoker labels for the exposition/SLO surfaces, index-aligned
        with the accumulator's invoker axis."""
        registry = getattr(self, "_registry", None)
        return [inv.as_string for inv in registry] if registry else []

    def _telemetry_exposition(self, openmetrics: bool = False) -> str:
        return self.telemetry.prometheus_text(
            self._telemetry_invoker_names(), openmetrics=openmetrics)

    # -- kernel profiling plane (shared hook, like the flight recorder) ----
    def kernel_profile(self) -> dict:
        """The `GET /admin/profile/kernel` payload. CPU balancers report a
        `kernel: "cpu"` profile (schedule-phase timings, empty compile
        log); the TPU balancer overrides the kernel label with what it
        actually resolved."""
        return self.profiler.profile_json(kernel="cpu")

    # -- health test actions (ref InvokerPool.prepare + healthAction) ------
    HEALTH_ACTION_NAMESPACE = "whisk.system"

    async def prepare_health_test_action(self, entity_store) -> None:
        """Write the system no-op test action
        (`whisk.system/invokerHealthTestAction<controller>`, ref
        InvokerSupervision.scala:239-252) and switch the supervision FSM to
        probing unhealthy invokers with real test activations instead of
        optimistic window re-opens. Healthcheck acks come back untracked and
        feed on_invocation_finished via the 4-way disambiguation."""
        from ...core.entity import (CodeExec, EntityName, EntityPath,
                                    FullyQualifiedEntityName)
        name = f"invokerHealthTestAction{self.controller.name}"
        action = WhiskAction(
            namespace=EntityPath(self.HEALTH_ACTION_NAMESPACE),
            name=EntityName(name),
            exec=CodeExec(kind="python:3",
                          code="def main(args):\n    return {}\n"))
        from ...database import DocumentConflict
        try:
            await entity_store.put(action)
        except DocumentConflict:
            # present from a previous boot: re-put at the stored revision so
            # a changed definition takes effect (ref InvokerPool.prepare)
            existing = await entity_store.get_action(
                f"{self.HEALTH_ACTION_NAMESPACE}/{name}")
            action.rev = existing.rev
            await entity_store.put(action)
        self._health_action_fqn = FullyQualifiedEntityName(
            EntityPath(self.HEALTH_ACTION_NAMESPACE), EntityName(name))
        self._system_identity = Identity.generate(self.HEALTH_ACTION_NAMESPACE)
        supervision = getattr(self, "supervision", None)
        if supervision is not None:
            supervision.send_test_action = self._send_health_test_action

    async def _send_health_test_action(self, invoker: InvokerInstanceId
                                       ) -> None:
        aid = ActivationId.generate()
        msg = ActivationMessage(
            transid=TransactionId(system=True),
            action=self._health_action_fqn, revision=None,
            user=self._system_identity, activation_id=aid,
            root_controller_index=self.controller, blocking=False, content={})
        # remember probe ids so their acks disambiguate as healthchecks
        self._health_probe_ids.add(aid.asString)
        while len(self._health_probe_ids) > 1024:
            self._health_probe_ids.pop()
        await self.send_activation_to_invoker(msg, invoker)
        self.counters["health_test_actions"] += 1

    # -- counters (ref :60-99) --------------------------------------------
    def active_activations_for(self, namespace_id: str) -> int:
        return self.activations_per_namespace.get(namespace_id, 0)

    @property
    def total_active_activations(self) -> int:
        return self._total

    def _incr(self, entry: ActivationEntry) -> None:
        self._total += 1
        self.activations_per_namespace[entry.namespace_id] = \
            self.activations_per_namespace.get(entry.namespace_id, 0) + 1

    def _decr(self, entry: ActivationEntry) -> None:
        self._total -= 1
        n = self.activations_per_namespace.get(entry.namespace_id, 1) - 1
        if n <= 0:
            self.activations_per_namespace.pop(entry.namespace_id, None)
        else:
            self.activations_per_namespace[entry.namespace_id] = n

    # -- activation setup (ref :116-169) -----------------------------------
    def setup_activation(self, msg: ActivationMessage,
                         action: Union[WhiskAction, ExecutableWhiskAction],
                         invoker: Optional[InvokerInstanceId]) -> asyncio.Future:
        timeout = (max(action.limits.timeout.seconds, self.STD_TIMEOUT)
                   * self.TIMEOUT_FACTOR + self.TIMEOUT_ADDON)
        loop = asyncio.get_event_loop()
        promise: asyncio.Future = loop.create_future()
        # some promises are never awaited (non-blocking invokes) — retrieve
        # the exception so a forced timeout doesn't log "Future exception
        # was never retrieved"
        promise.add_done_callback(
            lambda f: f.exception() if not f.cancelled() else None)
        entry = ActivationEntry(
            id=msg.activation_id,
            namespace_id=msg.user.namespace.uuid.asString,
            invoker=invoker,
            memory_mb=action.limits.memory.megabytes,
            max_concurrent=action.limits.concurrency.max_concurrent,
            action_key=f"{action.fully_qualified_name}@{action.rev.rev or ''}",
            is_blackbox=action.exec_metadata().is_blackbox,
            is_blocking=msg.blocking,
            t_start=time.monotonic(),
            stages=self.waterfall.ctx_of(msg.activation_id.asString),
            promise=promise,
        )
        # call_later, not a task per activation: a TimerHandle is one heap
        # entry with O(1) lazy cancellation
        entry.timeout_task = loop.call_later(timeout, self._timeout_fire,
                                             entry)
        self.activation_slots[msg.activation_id.asString] = entry
        self._incr(entry)
        return promise

    def _timeout_fire(self, entry: ActivationEntry) -> None:
        self.process_completion(entry.id, forced=True, is_system_error=False,
                                invoker=entry.invoker)

    # -- HA leadership (membership.py fires this on claim/demote) ----------
    def set_leadership(self, epoch: int, active: bool) -> None:
        """Adopt a leadership transition: the fencing epoch stamps every
        later dispatch; a standby refuses placement until promoted."""
        if epoch:
            self.fence_epoch = int(epoch)
        if not active:
            # demotion: drop the journal's buffered tail NOW — a
            # superseded active must not flush stale frames into the log
            # the new epoch's active owns (journal.abandon docstring)
            journal = getattr(self, "journal", None)
            if journal is not None and hasattr(journal, "abandon"):
                journal.abandon()
        self.ha_standby = not active
        GLOBAL_EVENT_LOG.record("leadership",
                                instance=self.controller.instance,
                                epoch=int(epoch), active=bool(active))
        self.metrics.gauge("controller_leadership_epoch", int(epoch))
        if self.logger:
            self.logger.info(
                TransactionId.LOADBALANCER,
                f"leadership epoch {epoch}: this controller is now "
                f"{'ACTIVE' if active else 'standby'}", "LoadBalancer")

    # -- active/active partitions (partitions.py) --------------------------
    def set_partition_mode(self, ring) -> None:
        """Attach the namespace partition ring: placement becomes
        per-partition fenced (class doc). Call before start()."""
        self.partition_ring = ring

    def partition_of_msg(self, msg: ActivationMessage) -> int:
        return self.partition_ring.partition_of(
            str(msg.user.namespace.name))

    def set_partition_leadership(self, pid: int, epoch: int,
                                 active: bool) -> None:
        """Adopt one partition's ownership transition (membership.py's
        per-partition claim/demote). Epochs only move forward."""
        self.partition_epochs[pid] = max(
            self.partition_epochs.get(pid, 0), int(epoch))
        if active:
            self.owned_partitions.add(pid)
            self.partition_replay.setdefault(pid, "ready")
            if GLOBAL_EVENT_LOG.enabled:
                # arm the timeline's first-placement marker for this
                # partition: prepare_dispatch stamps it on the first
                # post-claim dispatch
                self._fp_pending.add(pid)
        else:
            self.owned_partitions.discard(pid)
            self.partition_replay.pop(pid, None)
            self._fp_pending.discard(pid)
        GLOBAL_EVENT_LOG.record("part_ownership",
                                instance=self.controller.instance,
                                part=pid, epoch=int(epoch),
                                active=bool(active))
        self.metrics.gauge("loadbalancer_owned_partitions",
                           len(self.owned_partitions))
        if self.logger:
            self.logger.info(
                TransactionId.LOADBALANCER,
                f"partition {pid} epoch {epoch}: this controller is now "
                f"{'ACTIVE' if active else 'standby'} for it",
                "LoadBalancer")

    def _partition_refusal(self, msg: ActivationMessage,
                           pid: Optional[int] = None
                           ) -> Optional["LoadBalancerException"]:
        """None when this controller may place `msg`; the 503-shaped
        refusal otherwise. A message already fence-stamped by the current
        owner of its partition passes even here — that stamp is the
        spillover credential (spillover.py): the owner explicitly
        forwarded its overflow, fenced, so replay stays exact. `pid` may
        be passed pre-computed to spare the hot path a second hash."""
        if self.partition_ring is None:
            return None
        if pid is None:
            pid = self.partition_of_msg(msg)
        if pid in self.owned_partitions:
            return None
        if (msg.fence_part == pid and msg.fence_epoch is not None
                and msg.fence_epoch >= self.partition_epochs.get(pid, 0)):
            # current-epoch spillover from the owner: a fenced handoff
            # row is always trace-worthy — note it before the verdict.
            # Rare path (spilled-in rows only), one dict op.
            if self.trace_store.active:
                self.trace_store.mark(trace_id_of(msg.trace_context),
                                      "fenced")
            return None
        return LoadBalancerException(
            f"partition {pid} is owned by another controller")

    def partitions_json(self) -> List[dict]:
        """Per-partition role/epoch/replay-state (the /admin/ready body)."""
        if self.partition_ring is None:
            return []
        return [{"partition": pid,
                 "epoch": self.partition_epochs.get(pid, 0),
                 "role": ("active" if pid in self.owned_partitions
                          else "standby"),
                 "replay": self.partition_replay.get(pid, "n/a")}
                for pid in range(self.partition_ring.n_partitions)]

    # -- dispatch (ref :175-198) -------------------------------------------
    def prepare_dispatch(self, msg: ActivationMessage,
                         invoker: InvokerInstanceId) -> str:
        """The synchronous half of a dispatch, shared by the serial send
        and the batched publish path's task-free send: fence stamping and
        the published counter live HERE so the two paths cannot drift.
        Returns the invoker topic."""
        if self.partition_ring is not None:
            # active/active: stamp (partition, per-partition epoch). A
            # spilled message arrives already stamped by its origin —
            # keep the higher of the two epochs (ours can lag the
            # origin's by one claim announcement)
            pid = self.partition_of_msg(msg)
            ep = self.partition_epochs.get(pid)
            if ep is not None and (msg.fence_part != pid
                                   or msg.fence_epoch is None
                                   or ep >= msg.fence_epoch):
                msg.fence_epoch = ep
                msg.fence_part = pid
            if self._fp_pending and pid in self._fp_pending:
                self._fp_pending.discard(pid)
                GLOBAL_EVENT_LOG.record("first_placement",
                                        instance=self.controller.instance,
                                        part=pid, epoch=ep or 0)
        elif self.fence_epoch is not None:
            # epoch fencing: invokers discard messages from a superseded
            # epoch, so a zombie active's late batches never double-run
            msg.fence_epoch = self.fence_epoch
        self.counters["activations_published"] += 1
        return invoker.as_string  # "invoker<N>"

    async def send_activation_to_invoker(self, msg: ActivationMessage,
                                         invoker: InvokerInstanceId) -> None:
        await self.producer.send(self.prepare_dispatch(msg, invoker), msg)

    # -- completion-ack feed (ref :205-346) --------------------------------
    def start_ack_feed(self) -> None:
        topic = f"completed{self.controller.as_string}"
        self.provider.ensure_topic(topic)
        consumer = self.provider.get_consumer(
            topic, f"completions-{self.controller.as_string}", max_peek=128)
        feed_box = {}

        async def handle(payload: bytes):
            try:
                if is_batch_payload(payload):
                    self.process_acknowledgement_frame(payload)
                else:
                    self.process_acknowledgement(payload)
            finally:
                feed_box["feed"].processed()

        self._ack_feed = MessageFeed("activeack", consumer, 128, handle,
                                     logger=self.logger)
        feed_box["feed"] = self._ack_feed
        self._ack_feed.start()

    def process_acknowledgement(self, raw: bytes) -> None:
        try:
            # decode_message: the ack parse is the completion fan-in's
            # per-activation JSON cost — the host observatory counts its
            # bytes + wall time under {hop="completion_ack",deserialize}
            ack: AcknowledgementMessage = decode_message(
                parse_ack, raw, "completion_ack")
        except (ValueError, KeyError) as e:
            if self.logger:
                self.logger.error(TransactionId.LOADBALANCER,
                                  f"corrupt completion ack: {e!r}")
            return
        self._process_ack(ack)

    def _process_ack(self, ack: AcknowledgementMessage) -> None:
        """One decoded ack through the serial completion path."""
        if ack.activation is not None:
            self.process_result(ack.activation_id, ack.activation)
        if ack.is_slot_free:
            self.process_completion(ack.activation_id,
                                    forced=False,
                                    is_system_error=ack.is_system_error,
                                    invoker=ack.invoker)

    def process_acknowledgement_frame(self, raw: bytes) -> None:
        """A columnar ack batch frame off the completion feed: ONE decode
        for the whole frame, then the batched one-pass completion path
        (or, with `batched_ack` off, a serial replay of each ack —
        bit-exact with N independent frames)."""
        try:
            _kind, acks = decode_batch(raw)
        except (ValueError, KeyError, IndexError, TypeError,
                AssertionError) as e:
            if self.logger:
                self.logger.error(TransactionId.LOADBALANCER,
                                  f"corrupt completion ack batch: {e!r}")
            return
        if self.batched_ack:
            self.process_acknowledgements(acks)
        else:
            for ack in acks:
                try:
                    self._process_ack(ack)
                except Exception as e:  # noqa: BLE001 — per-ack isolation:
                    # serial frames isolated failures per feed hand-off;
                    # one ack's failure must not strand its frame-mates
                    if self.logger:
                        self.logger.error(TransactionId.LOADBALANCER,
                                          f"ack processing failed: {e!r}")

    def process_acknowledgements(self, acks: List[AcknowledgementMessage]
                                 ) -> None:
        """The batch-shaped completion pipeline: N decoded acks in ONE
        pass — each ack's result resolves first, then its slot release
        updates the entry books directly, the completion_ack stamps share
        one clock, the waterfall folds under one lock (finish_many), the
        regular-ack counter moves once with the batch count, and the
        telemetry / anomaly burn-gauge tick runs once per batch instead of
        per ack. Decision-for-decision identical to `process_completion`;
        acks off the wire are never `forced` (only the timeout timer
        forces). One ack's failure does not strand the rest."""
        wf = self.waterfall
        now_ns = time.monotonic_ns() if wf.enabled else 0
        now_mono = time.monotonic()
        tp = self.telemetry
        finish_aids: List[str] = []
        # (aid, trace_id, e2e_ms, is_error) per released slot, consumed by
        # the trace store's completion verdict after the waterfall fold
        # hands back the computed rows. None = plane off: the
        # whole leg is one attribute check.
        trace_done: Optional[List[tuple]] = \
            [] if self.trace_store.enabled else None
        regular = 0
        for ack in acks:
            try:
                regular += self._process_ack_batched(
                    ack, now_ns, now_mono, tp, wf, finish_aids, trace_done)
            except Exception as e:  # noqa: BLE001 — per-ack isolation
                if self.logger:
                    self.logger.error(TransactionId.LOADBALANCER,
                                      f"batched ack failed: {e!r}")
        self.counters["completion_ack_regular"] += regular
        if finish_aids:
            if trace_done is not None:
                rows: List[dict] = []
                wf.finish_many(finish_aids, rows_out=rows)
                rowmap = {r["activation_id"]: r for r in rows}
            else:
                wf.finish_many(finish_aids)
        elif trace_done is not None:
            rowmap = {}
        if trace_done:
            store = self.trace_store
            for aid_s, tid, e2e_ms, err in trace_done:
                store.complete(aid_s, tid, e2e_ms, error=err,
                               row=rowmap.get(aid_s))
        if tp.enabled:
            tp.maybe_tick(self.metrics)
            self.anomaly.maybe_tick(self.metrics)

    def _process_ack_batched(self, ack: AcknowledgementMessage, now_ns: int,
                             now_mono: float, tp: TelemetryPlane,
                             wf: ActivationWaterfall,
                             finish_aids: List[str],
                             trace_done: Optional[List[tuple]] = None
                             ) -> int:
        """One ack's share of the batched pass; returns 1 when it released
        a tracked (regular) slot, 0 otherwise."""
        if ack.activation is not None:
            self.process_result(ack.activation_id, ack.activation)
        if not ack.is_slot_free:
            return 0
        aid = ack.activation_id
        entry = self.activation_slots.pop(aid.asString, None)
        if entry is None:
            # untracked ack: healthcheck or late-after-forced — the
            # 4-way disambiguation, same counters as the serial path
            if aid.asString in self._health_probe_ids:
                self._health_probe_ids.discard(aid.asString)
                self.counters["completion_ack_healthcheck"] += 1
            else:
                self.counters["completion_ack_regularAfterForced"] += 1
            self.on_invocation_finished(
                ack.invoker, is_system_error=ack.is_system_error,
                forced=False)
            return 0
        if entry.timeout_task:
            entry.timeout_task.cancel()
        self._decr(entry)
        if entry.invoker is not None:
            self.release_invoker(entry.invoker, entry)
        inv = ack.invoker or entry.invoker
        # telemetry observe per completion, burn-gauge tick ONCE at the
        # end of the pass (the serial path ticks per ack; tick() is
        # 1 Hz-capped so the observable cadence is unchanged)
        if tp.enabled and entry.t_start > 0.0 and inv is not None:
            outcome = (OUTCOME_ERROR if ack.is_system_error
                       else OUTCOME_SUCCESS)
            tp.observe(inv.instance, entry.namespace_id,
                       (now_mono - entry.t_start) * 1e3, outcome)
        if wf.enabled:
            self._stamp_completion(entry, aid.asString, now_ns)
            finish_aids.append(aid.asString)
        if trace_done is not None:
            # the verdict inputs are all already in hand — trace id off
            # the ack (the invoker's active-ack rider), e2e off the
            # telemetry observation's clock read: no new clock, no I/O
            tc = getattr(ack, "trace_context", None)
            trace_done.append((
                aid.asString,
                trace_id_of(tc) if tc else None,
                ((now_mono - entry.t_start) * 1e3
                 if entry.t_start > 0.0 else None),
                bool(ack.is_system_error)))
        self.on_invocation_finished(inv,
                                    is_system_error=ack.is_system_error,
                                    forced=False)
        return 1

    def process_result(self, aid: ActivationId, activation: WhiskActivation) -> None:
        """Complete the blocking client's promise (ref :235-243)."""
        entry = self.activation_slots.get(aid.asString)
        if entry is not None and entry.promise is not None and not entry.promise.done():
            entry.promise.set_result(activation)

    def process_completion(self, aid: ActivationId, forced: bool,
                           is_system_error: bool,
                           invoker: Optional[InvokerInstanceId]) -> None:
        """Slot release with 4-way disambiguation (ref :260-346)."""
        entry = self.activation_slots.pop(aid.asString, None)
        if entry is not None:
            if entry.timeout_task and not forced:
                entry.timeout_task.cancel()
            entry.forced = forced
            self._decr(entry)
            if entry.invoker is not None:
                self.release_invoker(entry.invoker, entry)
            if forced:
                self.counters["completion_ack_forced"] += 1
                if entry.promise is not None and not entry.promise.done():
                    entry.promise.set_exception(ActiveAckTimeout(aid))
            else:
                self.counters["completion_ack_regular"] += 1
            self._telemetry_observe(entry, invoker, forced, is_system_error)
            # waterfall: the completion ack is the last causally-ordered
            # stage — stamp it and fold the activation's stage vector
            # (forced timeouts fold too: their partial vectors are the
            # tail evidence)
            row = None
            if self.waterfall.enabled:
                self._stamp_completion(entry, aid.asString)
                row = self.waterfall.finish(aid.asString)
            if self.trace_store.enabled:
                # serial-path verdict: forced completions are
                # the controller-side timeout — exactly the traces tail
                # sampling exists to keep
                e2e_ms = ((time.monotonic() - entry.t_start) * 1e3
                          if entry.t_start > 0.0 else None)
                self.trace_store.complete(
                    aid.asString,
                    row.get("trace_id") if row else None,
                    e2e_ms, error=is_system_error, timeout=forced, row=row)
            self.on_invocation_finished(invoker or entry.invoker,
                                        is_system_error=is_system_error,
                                        forced=forced)
        elif aid.asString in self._health_probe_ids:
            # untracked ack: a test-action probe we sent
            self._health_probe_ids.discard(aid.asString)
            self.counters["completion_ack_healthcheck"] += 1
            self.on_invocation_finished(invoker, is_system_error=is_system_error,
                                        forced=forced)
        elif not forced:
            # a late ack after a forced completion
            self.counters["completion_ack_regularAfterForced"] += 1
            self.on_invocation_finished(invoker, is_system_error=is_system_error,
                                        forced=False)
        else:
            self.counters["completion_ack_forcedAfterRegular"] += 1

    def _stamp_completion(self, entry: ActivationEntry, aid: str,
                          now_ns: Optional[int] = None) -> None:
        if entry.stages is not None:
            self.waterfall.stamp_ctx(entry.stages, STAGE_COMPLETION_ACK,
                                     now_ns)
        else:
            self.waterfall.stamp(aid, STAGE_COMPLETION_ACK, now_ns)

    # -- flight recorder (single-decision hook for CPU balancers) ----------
    def record_placement(self, msg: ActivationMessage,
                         action: Union[WhiskAction, ExecutableWhiskAction],
                         chosen: int, invoker: Optional[InvokerInstanceId],
                         forced: bool = False, throttled: bool = False,
                         digest: Optional[dict] = None) -> None:
        """Record one placement decision as a one-row batch record (the TPU
        balancer records whole micro-batches itself). CPU balancers carry a
        `kernel: "cpu"` digest; callers may add backend detail."""
        # quality plane attribution (CPU balancers; the TPU balancer
        # scores whole micro-batches on the device instead) — independent
        # of the flight recorder's own off-switch
        self.quality.observe_decision(chosen >= 0, bool(forced),
                                      bool(throttled))
        fr = self.flight_recorder
        if not fr.enabled:
            return
        d = {"kernel": "cpu", "queue_depth": 0, "oldest_age_ms": 0.0}
        tid = trace_id_of(getattr(msg, "trace_context", None))
        if tid is not None:
            # the row carries its trace: exemplar plumbing links the phase
            # histogram's bucket lines back to this trace on OpenMetrics
            # scrapes
            d["trace_id"] = tid
        if digest:
            d.update(digest)
        rec = BatchRecord(digest=d, decisions=[(
            msg.activation_id.asString, str(action.fully_qualified_name),
            chosen, invoker.as_string if invoker is not None else None,
            bool(forced), bool(throttled),
            action.limits.memory.megabytes)])
        fr.record(rec)
        self.metrics.gauge("loadbalancer_healthy_invokers",
                           d.get("healthy_invokers", 0))
        self.metrics.gauge("loadbalancer_flight_recorder_dropped", fr.dropped)

    def _trace_placement_lookup(self, activation_id: str) -> Optional[dict]:
        """The trace store's keep-time join: the flight
        recorder's placement batch for a KEPT activation — the same shape
        the latency-waterfall slowest-row join ships, plus the quality
        digest. Called only on the keep path, never per completion."""
        found = self.flight_recorder.explain(activation_id)
        if found is None:
            return None
        batch = found["batch"]
        return {
            "seq": batch["seq"],
            "kernel": batch["digest"].get("kernel"),
            "queue_depth": batch["digest"].get("queue_depth"),
            "trace_id": batch["digest"].get("trace_id"),
            "timings": batch.get("timings", {}),
            "quality": batch["digest"].get("quality"),
            "decision": found.get("decision"),
        }

    # -- subclass hooks ----------------------------------------------------
    def release_invoker(self, invoker: InvokerInstanceId, entry: ActivationEntry) -> None:
        """Return the capacity slot taken for this activation."""

    def on_invocation_finished(self, invoker: Optional[InvokerInstanceId],
                               is_system_error: bool, forced: bool) -> None:
        """Feed the invoker-health supervision (ref InvocationFinishedMessage)."""

    async def close(self) -> None:
        if self._ack_feed:
            await self._ack_feed.stop()
        # flush any coalescing window still holding queued sends, then
        # release the producer's transport
        await self.producer.close()
        for entry in list(self.activation_slots.values()):
            if entry.timeout_task:
                entry.timeout_task.cancel()
        self.activation_slots.clear()
        # a shared (process-wide) emitter outlives the balancer: stop
        # contributing families once closed
        self.metrics.unregister_renderer(self._counters_exposition)
        self.metrics.unregister_renderer(self._telemetry_renderer)
        self.metrics.unregister_renderer(self._profiler_renderer)
        self.metrics.unregister_renderer(self._anomaly_renderer)
        self.metrics.unregister_renderer(self._waterfall_exposition)
        self.metrics.unregister_renderer(self._quality_exposition)
        if self._trace_renderer is not None:
            self.metrics.unregister_renderer(self._trace_renderer)
        if self._incidents_renderer is not None:
            self.metrics.unregister_renderer(self._incidents_renderer)
        self.incidents.uninstall(owner=self)


def _bridge_publish_future(row: asyncio.Future, waiter: asyncio.Future) -> None:
    """Wire one publish_many row future to its caller-facing waiter with
    done-callbacks only — no task per activation. Result/exception copy
    forward; a caller that goes away (waiter cancelled) cancels the row,
    which the balancer's readback fan-out reads as an abandoned publisher
    and returns the reserved capacity."""

    def forward(f: asyncio.Future) -> None:
        # retrieve the row's exception unconditionally: a row failing
        # after its waiter was cancelled has nobody else to read it, and
        # an unretrieved exception is loop-noise at GC time
        exc = None if f.cancelled() else f.exception()
        if waiter.done():
            # waiter cancelled before the row resolved: the outcome is
            # orphaned — a successful placement self-heals through the
            # activation entry's forced timeout
            return
        if f.cancelled():
            waiter.cancel()
        elif exc is not None:
            waiter.set_exception(exc)
        else:
            waiter.set_result(f.result())

    def backward(w: asyncio.Future) -> None:
        if w.cancelled() and not row.done():
            row.cancel()

    row.add_done_callback(forward)
    waiter.add_done_callback(backward)


class PublishCoalescer:
    """Front-door publish batcher: concurrent `publish` calls in one
    event-loop sweep reach the balancer as ONE `publish_many` batch.

    The per-activation asyncio floor the host observatory measured lived
    exactly here: every admitted activation minted a publish coroutine, a
    flush-timer arm, a clock read and an arrival-EWMA blend of its own.
    This coalescer queues `(action, msg)` on the caller's turn and drains
    the queue with `loop.call_soon` — end-of-sweep, the bus coalescer's
    zero-idle-latency rule, with NO drainer task — handing the whole
    sweep's arrivals to `publish_many` in one call. Waiters resolve to
    the completion promise (or the serial path's exact exceptions)
    through done-callback bridges, so the publish hot path adds zero
    tasks per activation.

    Built only when the balancer advertises `batch_publish`
    (CONFIG_whisk_loadBalancer_batchPublish; `maybe_batch_publish`
    returns None otherwise and callers keep the serial `publish` path
    bit-exactly)."""

    def __init__(self, balancer, max_batch: Optional[int] = None):
        self._bal = balancer
        self.max_batch = max_batch or getattr(balancer, "max_batch", 256)
        self._q: List[tuple] = []
        self._armed = False
        self.flushes = 0
        self.submitted = 0

    def submit(self, action, msg) -> asyncio.Future:
        """Queue one publish; returns a future resolving to the
        completion promise (what `await balancer.publish(...)` returns)."""
        loop = asyncio.get_event_loop()
        waiter: asyncio.Future = loop.create_future()
        self._q.append((action, msg, waiter))
        self.submitted += 1
        if len(self._q) >= self.max_batch:
            self._flush()
        elif not self._armed:
            self._armed = True
            loop.call_soon(self._flush)
        return waiter

    async def publish(self, action, msg) -> asyncio.Future:
        """Drop-in for `balancer.publish`: same awaited value, same
        exceptions, batched under the hood."""
        return await self.submit(action, msg)

    def _flush(self) -> None:
        self._armed = False
        q, self._q = self._q, []
        if not q:
            return
        self.flushes += 1
        try:
            rows = self._bal.publish_many([(a, m) for a, m, _w in q])
        except Exception as e:  # noqa: BLE001 — a synchronously-raising
            # publish_many must fail its waiters, not the event loop's
            # call_soon handler
            for _a, _m, w in q:
                if not w.done():
                    # fresh instance per waiter where the constructor
                    # allows it: N waiters re-raising one shared object
                    # interleave their __traceback__ frames
                    try:
                        exc = type(e)(*e.args)
                    except Exception:  # noqa: BLE001 — exotic ctor
                        exc = e
                    w.set_exception(exc)
            return
        for (_a, _m, waiter), row in zip(q, rows):
            _bridge_publish_future(row, waiter)


def maybe_batch_publish(balancer) -> Optional[PublishCoalescer]:
    """The wiring hook (the `maybe_coalesce` pattern): a PublishCoalescer
    when the balancer runs the batched publish SPI, None — the serial
    per-call path, bit-exact — otherwise."""
    if getattr(balancer, "batch_publish", False):
        return PublishCoalescer(balancer)
    return None
