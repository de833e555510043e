"""Controller assembly: wires stores, balancer, entitlement, APIs.

A copy of `openwhisk_tpu/controller/core.py` (rebuild of
core/controller/.../controller/Controller.scala:74-166): it boots the HTTP
service, resolves the SPIs (load balancer, entitlement, authentication,
stores), ensures bus topics, exposes /invokers and /metrics. Rule status
lives on the trigger document exactly as in the reference (Rules.scala).

`start` installs the host observatory on the controller's loop (and the
opt-in GC tuning). With the fleet observatory on (the default;
`CONFIG_whisk_fleetObservatory_enabled`) it sets this process's identity
block, turns the event log on, announces the controller's admin address
in its membership heartbeats and starts `FleetEvents` (the `ctrlevents`
publisher and consumer); an armed incident recorder keeps the event log on
with the fleet off. A clustering balancer (one that overrides
`update_cluster`, as the TPU and sharding balancers do) joins the
controller membership protocol at `start` and leaves it at `stop`, with
the HA failover, partition ring, partition callback and spillover load
hint an assembler set before `start`; a spillover or funnel receiver it
attached starts and stops with the controller.
"""
from __future__ import annotations

from typing import Optional

from aiohttp import web

from .. import spi
from ..containerpool.logstore import ContainerLogStore
from ..core.entity import (ACTIVE, ControllerInstanceId, INACTIVE, ReducedRule)
from ..database import (ArtifactActivationStore, AuthStore, EntityStore,
                        MemoryArtifactStore, NoDocumentException,
                        RemoteCacheInvalidation)
from ..utils.logging import Logging, MetricEmitter
from .api import ControllerApi
from .cors import CorsSettings
from .loadbalancer.base import LoadBalancer
from .authentication import BasicAuthenticationProvider
from .entitlement import LocalEntitlementProvider
from .invoke import ActionInvoker
from .routemgmt import ApiRouteManager
from .sequences import SequenceInvoker
from .triggers_service import TriggerService
from .web_actions import WebActionsApi


class Controller:
    def __init__(self, instance: ControllerInstanceId, messaging_provider,
                 artifact_store=None, logger: Optional[Logging] = None,
                 load_balancer=None, entitlement=None,
                 action_sequence_limit: int = 50,
                 invocations_per_minute: int = 60,
                 concurrent_invocations: int = 30,
                 fires_per_minute: int = 60,
                 log_store=None, extra_routes=None):
        self.instance = instance
        self.provider = messaging_provider
        self.logger = logger or Logging()
        self.metrics = self.logger.metrics
        store = artifact_store if artifact_store is not None else MemoryArtifactStore()
        self.artifact_store = store
        self.cache_invalidation = RemoteCacheInvalidation(
            messaging_provider, instance.as_string, logger=self.logger)
        self.entity_store = EntityStore(
            store, on_invalidate=lambda key: self.cache_invalidation
            .notify_other_instances("whisks", key))
        self.cache_invalidation.register("whisks", self.entity_store.cache)
        self.auth_store = AuthStore(store)
        self.activation_store = ArtifactActivationStore(store)
        self.authenticator = BasicAuthenticationProvider(self.auth_store)
        self.load_balancer = load_balancer
        self.entitlement = entitlement or LocalEntitlementProvider(
            load_balancer, invocations_per_minute, concurrent_invocations,
            fires_per_minute, metrics=self.metrics,
            event_producer=messaging_provider.get_producer())
        self.action_sequence_limit = action_sequence_limit
        self.invoker = ActionInvoker(self.entity_store, self.activation_store,
                                     load_balancer, instance, self.logger)
        self.sequencer = SequenceInvoker(self.entity_store, self.activation_store,
                                         self.invoker, instance,
                                         action_sequence_limit)
        from .conductors import ConductorInvoker
        self.conductor = ConductorInvoker(self.entity_store, self.activation_store,
                                          self.invoker, action_sequence_limit)
        self.trigger_service = TriggerService(self.entity_store,
                                              self.activation_store,
                                              self.invoker, self.sequencer,
                                              self.conductor)
        # sequences route conductor components through the composition loop
        self.sequencer.conductor = self.conductor
        self.cors = CorsSettings.from_env()
        self.web_actions = WebActionsApi(self)
        self.log_store = log_store if log_store is not None \
            else ContainerLogStore()
        self.route_manager = ApiRouteManager(store)
        self.api = ControllerApi(self)
        self._runner: Optional[web.AppRunner] = None
        self.membership = None
        # (method, path, handler) triples mounted beside /api/v1 at start —
        # the seam the standalone playground UI plugs into. These are
        # operator-mounted dev/ops pages, served without platform auth (the
        # playground page authenticates its own API calls)
        self.extra_routes = list(extra_routes or [])
        self.public_extra_paths = {path for _, path, _ in self.extra_routes}
        # resources an assembler (e.g. standalone) co-locates with this
        # controller; each must expose an async stop()
        self.owned_resources: list = []
        # HA failover (loadbalancer/membership.py leadership): assemblers
        # set these BEFORE start() to run the epoch-fenced active/standby
        # protocol on the membership heartbeats. on_leadership(epoch,
        # active) may be async (promotion restores snapshot+journal).
        self.ha_failover = False
        self.on_leadership = None
        # Active/active partitioned controllers (loadbalancer/partitions
        # .py): assemblers set the ring + the partition-transition
        # callback BEFORE start(). on_partitions(gained, lost) may be
        # async (a gain absorbs the previous owner's journal tail).
        # spillover_receiver (loadbalancer/spillover.py) is started/
        # stopped with the controller when attached.
        self.ha_partition_ring = None
        self.on_partitions = None
        self.spillover_receiver = None
        # admission funnel (loadbalancer/funnel.py): the
        # balancer-role assembler attaches a FunnelReceiver BEFORE
        # start(); started/stopped with the controller like spillover.
        # None (the default and the --role all path) keeps today's
        # single-process behavior bit-exact.
        self.funnel_receiver = None
        # fleet observatory: resolved once at assembly; start()
        # wires the admin-address announcement, the identity block and the
        # ctrlevents publisher only when enabled, so disabled stays a TRUE
        # no-op (byte-exact heartbeats, no topic, endpoints 404)
        from ..utils.eventlog import fleet_config
        self.fleet_config = fleet_config()
        self.fleet_events = None

    # -- rule status handling (status lives on the trigger doc) ------------
    async def rule_status(self, rule) -> str:
        try:
            trigger = await self.entity_store.get_trigger(str(rule.trigger))
            reduced = trigger.rules.get(rule.docid)
            return reduced.status if reduced else INACTIVE
        except NoDocumentException:
            return INACTIVE

    async def set_rule_status(self, rule_doc_id: str, status: str) -> None:
        rule = await self.entity_store.get_rule(rule_doc_id)
        trigger = await self.entity_store.get_trigger(str(rule.trigger))
        trigger.add_rule(rule_doc_id, ReducedRule(rule.action, status))
        await self.entity_store.put(trigger)

    async def delete_rule(self, rule_doc_id: str) -> dict:
        rule = await self.entity_store.get_rule(rule_doc_id)
        try:
            trigger = await self.entity_store.get_trigger(str(rule.trigger))
            trigger.remove_rule(rule_doc_id)
            await self.entity_store.put(trigger)
        except NoDocumentException:
            pass
        await self.entity_store.delete(rule)
        return rule.to_json()

    # -- lifecycle ---------------------------------------------------------
    async def start(self, host: str = "127.0.0.1", port: int = 3233) -> None:
        # fleet observatory identity: who this process is in every
        # snapshot the federation merges (partitions resolve live from
        # the balancer so the block tracks ownership changes)
        from ..utils.eventlog import GLOBAL_EVENT_LOG, set_identity
        fleet_on = self.fleet_config.enabled
        # an armed incident recorder (utils/blackbox.py) forces the event
        # log on — its structural-distress triggers arrive through it —
        # so a fleet-off deployment must not disarm it here
        from ..utils.blackbox import GLOBAL_INCIDENTS
        incidents_armed = GLOBAL_INCIDENTS.stats()["installed"]
        GLOBAL_EVENT_LOG.enabled = fleet_on or incidents_armed
        if fleet_on:
            lb_ = self.load_balancer

            def owned_parts():
                if getattr(lb_, "partition_ring", None) is not None:
                    return [p["partition"] for p in lb_.partitions_json()
                            if p["role"] == "active"]
                return []

            set_identity(instance=self.instance.instance, role="controller",
                         partitions_fn=owned_parts)
        admin_url = f"http://{host}:{port}" if fleet_on else None
        # host hot-loop observatory (utils/hostprof.py): event-loop lag,
        # GC pauses, task churn/serde accounting and the sampling profiler
        # arm on THIS controller's loop; the renderer joins this
        # controller's /metrics page. install() is a refused no-op when
        # CONFIG_whisk_hostProfiling_enabled=false or another controller
        # in this process already owns the observatory.
        from ..utils.hostprof import GLOBAL_HOST_OBSERVATORY, tune_gc
        self._host_observatory_owner = GLOBAL_HOST_OBSERVATORY.install(
            metrics=self.metrics)
        # opt-in GC tuning (CONFIG_whisk_host_gc_enabled): freeze the
        # boot-time permanent heap out of the collector and raise the
        # thresholds — full gen-2 scans were measured at 100-250 ms event
        # loop stalls under load (utils/hostprof.py GcTuningConfig)
        tuned = tune_gc()
        if tuned is not None:
            self.logger.info("controller",
                             f"gc tuned: froze {tuned['frozen']} objects, "
                             f"thresholds {tuned['thresholds']}",
                             "Controller")
        self.cache_invalidation.start()
        if hasattr(self.load_balancer, "start"):
            await self.load_balancer.start()
        if hasattr(self.load_balancer, "prepare_health_test_action"):
            # system test action for probing unhealthy invokers
            # (ref InvokerPool.prepare, InvokerSupervision.scala:239-252)
            await self.load_balancer.prepare_health_test_action(self.entity_store)
        lb_cls = type(self.load_balancer) if self.load_balancer else None
        if lb_cls is not None and \
                lb_cls.update_cluster is not LoadBalancer.update_cluster:
            # clustering balancer: join the membership protocol so joins /
            # crashes of peer controllers re-shard capacity at runtime
            # (replaces Akka Cluster events,
            # ShardingContainerPoolBalancer.scala:217-250)
            from .loadbalancer.membership import ControllerMembership
            lb = self.load_balancer

            def load_hint() -> float:
                # the spillover plane's least-loaded ranking: in-flight
                # activations + what is queued for the device
                return (lb.total_active_activations
                        + len(getattr(lb, "_pending", ())))

            self.membership = ControllerMembership(
                self.provider, self.instance, self.load_balancer,
                logger=self.logger, ha=self.ha_failover,
                on_leadership=self.on_leadership,
                ring=self.ha_partition_ring,
                on_partitions=self.on_partitions,
                load_hint=(load_hint if self.ha_partition_ring is not None
                           else None),
                admin_url=admin_url)
            self.membership.start()
        if fleet_on:
            # structural events -> ctrlevents topic, peers' frames folded
            # for the merged /admin/fleet/timeline
            from .fleet import FleetEvents
            self.fleet_events = FleetEvents(
                self.provider, self.instance.instance,
                config=self.fleet_config, logger=self.logger)
            self.fleet_events.start()
        if self.spillover_receiver is not None:
            self.spillover_receiver.start()
        if self.funnel_receiver is not None:
            self.funnel_receiver.start()
        app = self.api.make_app()
        for method, path, handler in self.extra_routes:
            app.router.add_route(method, path, handler)
        self._runner = web.AppRunner(app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, host, port)
        await site.start()
        self.logger.info("controller", f"controller listening on {host}:{port}",
                         "Controller")

    async def stop(self) -> None:
        if getattr(self, "_host_observatory_owner", False):
            from ..utils.hostprof import GLOBAL_HOST_OBSERVATORY
            GLOBAL_HOST_OBSERVATORY.uninstall()
            self._host_observatory_owner = False
        if self._runner:
            await self._runner.cleanup()
        if self.membership is not None:
            await self.membership.stop()  # sends the graceful leave
        if self.fleet_events is not None:
            await self.fleet_events.stop()
            self.fleet_events = None
        if self.spillover_receiver is not None:
            await self.spillover_receiver.stop()
        if self.funnel_receiver is not None:
            await self.funnel_receiver.stop()
        for resource in self.owned_resources:
            await resource.stop()
        if hasattr(self.entitlement, "close"):
            # sharded front end: stop the admission worker loops
            await self.entitlement.close()
        if self.load_balancer is not None:
            await self.load_balancer.close()
        await self.cache_invalidation.stop()
        await self.artifact_store.close()
