"""CLI: run a controller process against a bus + shared store.
A copy of `openwhisk_tpu/controller/__main__.py`.

Rebuild of core/controller/.../Controller.scala main for distributed mode:
REST API + a real balancer (the TPU balancer on the CUDA card, or the CPU
sharding balancer) fed by invoker health pings over the bus.

  python -m openwhisk_tpu_torch.controller --bus 127.0.0.1:4222 \
      --db /path/whisks.db --port 3233 --balancer tpu \
      --instance 0 --cluster-size 1

Every role of the reference runs: `--role all` (the default), `--role
balancer` (the device-owning process that also ingests funnel frames) and
`--role frontend --funnel-to N [--funnel-depth D]` (an edge-facing worker
that places nothing), with `--ha` for active/standby failover
(`CONFIG_whisk_ha_failover_enabled`) or active/active partitions
(`CONFIG_whisk_ha_activeActive`). A placing role's TPU balancer runs on
the card unless `--device cpu` asks for the plain torch path; without a
card it exits non-zero with the reason and never carries on on the CPU.
A frontend owns no device and needs no card.
"""
from __future__ import annotations

import argparse
import asyncio
import sys

from ..core.entity import ControllerInstanceId, ExecManifest, WhiskAuthRecord
from ..database import open_store
from ..messaging import provider_for_bus
from ..utils.config import config_from_env
from ..utils.logging import Logging
from .core import Controller
from ..utils.tasks import wait_for_shutdown


def main() -> None:
    parser = argparse.ArgumentParser(description="OpenWhisk-TPU controller")
    parser.add_argument("--bus", default="127.0.0.1:4222")
    parser.add_argument("--db", required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=3233)
    parser.add_argument("--instance", default="0")
    parser.add_argument("--cluster-size", type=int, default=1)
    parser.add_argument("--balancer", choices=("tpu", "sharding"), default="tpu")
    parser.add_argument("--device", choices=("cuda", "cpu"), default=None,
                        help="where the TPU balancer places: the CUDA card "
                             "(default) or the plain torch path on the CPU")
    parser.add_argument("--seed-guest", action="store_true",
                        help="create the standalone guest identity")
    parser.add_argument("--balancer-snapshot", default=None,
                        help="path for periodic balancer-state snapshots; "
                             "restored at boot to skip the warm-up window "
                             "(SURVEY §5.4 checkpoint/resume)")
    parser.add_argument("--balancer-snapshot-interval", type=float,
                        default=10.0)
    parser.add_argument("--balancer-journal", default=None,
                        help="directory for the write-ahead placement "
                             "journal: every committed device-state "
                             "mutation is logged so restore = snapshot + "
                             "deterministic tail replay (bounded amnesia; "
                             "see docs/tpu-balancer.md 'HA, journaling & "
                             "failover')")
    parser.add_argument("--ha", action="store_true",
                        help="epoch-fenced active/standby failover for the "
                             "stateful balancer: boot as standby, claim "
                             "placement leadership over the bus when the "
                             "active dies, restore snapshot+journal and "
                             "resume placement (point every controller at "
                             "the same --balancer-snapshot/-journal "
                             "storage)")
    parser.add_argument("--balancer-rate-limit", type=int, default=None,
                        help="per-namespace activations/minute enforced by "
                             "the DEVICE token bucket fused into the TPU "
                             "placement step (bus-boundary backstop behind "
                             "the front door's entitlement throttle)")
    parser.add_argument("--role", choices=("all", "frontend", "balancer"),
                        default="all",
                        help="multi-process deployment role: "
                             "'all' (default) = today's single-process "
                             "path, bit-exact; 'balancer' = the device-"
                             "owning process, additionally ingesting "
                             "admission frames from its ctrlfunnel<N> "
                             "topic; 'frontend' = an edge-facing worker "
                             "whose load balancer forwards whole "
                             "admission waves over the bus to --funnel-to")
    parser.add_argument("--funnel-to", type=int, default=0,
                        help="(--role frontend) instance number of the "
                             "device-owning balancer process to funnel "
                             "admission batches to")
    parser.add_argument("--funnel-depth", type=int, default=None,
                        help="(--role frontend) max rows in flight before "
                             "the front door answers 429 (default "
                             "CONFIG_whisk_funnel_depth or 2048)")
    args = parser.parse_args()
    if args.balancer == "tpu" and args.role != "frontend":
        # a placing role: the card unless --device cpu, checked before
        # booting anything (a frontend owns no device)
        from ..ops.placement import resolve_device
        try:
            resolve_device(None if args.device == "cuda" else args.device)
        except RuntimeError as e:
            print(f"error: {e}", file=sys.stderr)
            raise SystemExit(1)

    async def run():
        logger = Logging(level="info")
        from ..utils.tracing import maybe_enable_zipkin
        zipkin = maybe_enable_zipkin(f"controller{args.instance}")
        controller = snapshotter = journal = None
        try:
            ExecManifest.initialize()
            provider = provider_for_bus(args.bus)
            store = open_store(args.db)
            instance = ControllerInstanceId(args.instance)
            if args.role == "frontend":
                # edge-facing worker process: the HTTP API,
                # entitlement/rate admission and activation-id mint run
                # here; placement is a wire hop — whole admission waves
                # forward as one columnar frame to the device-owning
                # balancer. No journal/snapshot/HA machinery: that
                # state lives with the device.
                from .loadbalancer.funnel import (FunnelBalancer,
                                                  FunnelConfig)
                fcfg = FunnelConfig.from_env()
                if args.funnel_depth is not None:
                    fcfg = FunnelConfig(depth=args.funnel_depth,
                                        retry_seconds=fcfg.retry_seconds,
                                        max_retries=fcfg.max_retries)
                lb = FunnelBalancer(provider, instance,
                                    target=args.funnel_to, config=fcfg,
                                    logger=logger, metrics=logger.metrics)
                lim = config_from_env().get("limits", {})
                controller = Controller(
                    instance, provider, artifact_store=store,
                    logger=logger, load_balancer=lb,
                    invocations_per_minute=int(
                        lim.get("invocations_per_minute", 60)),
                    concurrent_invocations=int(
                        lim.get("concurrent_invocations", 30)),
                    fires_per_minute=int(lim.get("fires_per_minute", 60)))
                if args.seed_guest:
                    from ..standalone import guest_identity
                    ident = guest_identity()
                    await controller.auth_store.put(
                        WhiskAuthRecord(ident.subject, [ident.namespace],
                                        [ident.authkey]))
                await controller.start(host=args.host, port=args.port)
                print(f"controller{args.instance} up on :{args.port} "
                      f"(role=frontend, funnel->balancer{args.funnel_to}, "
                      f"bus={args.bus})", flush=True)
                await wait_for_shutdown()
                return
            if args.balancer == "tpu":
                from .loadbalancer.tpu_balancer import TpuBalancer
                lb = TpuBalancer(provider, instance, logger=logger,
                                 metrics=logger.metrics,
                                 cluster_size=args.cluster_size,
                                 rate_limit_per_minute=args.balancer_rate_limit,
                                 device=args.device)
            else:
                from .loadbalancer.sharding_balancer import ShardingBalancer
                lb = ShardingBalancer(provider, instance, logger=logger,
                                      metrics=logger.metrics,
                                      cluster_size=args.cluster_size)
            # Active/active partitioned controllers
            # (CONFIG_whisk_ha_activeActive + --ha): N simultaneously-
            # active journaled controllers, each owning a ring partition
            # set. Each instance writes its OWN journal/snapshot under
            # the shared storage root (single-writer per journal holds;
            # peers read each other's tails only at partition absorb).
            aa_ring = aa_cfg = None
            if args.ha:
                from .loadbalancer.partitions import (active_active_config,
                                                      ring_from_config)
                aa_cfg = active_active_config()
                aa_ring = ring_from_config(aa_cfg)
            journal_dir = args.balancer_journal
            snap_path = args.balancer_snapshot
            if aa_ring is not None:
                import os
                if journal_dir:
                    journal_dir = os.path.join(journal_dir,
                                               f"ctrl{args.instance}")
                if snap_path:
                    snap_path = f"{snap_path}.ctrl{args.instance}"
            if journal_dir and hasattr(lb, "attach_journal"):
                from .loadbalancer.journal import journal_from_config
                journal = journal_from_config(journal_dir, logger=logger)
                if journal is not None:
                    lb.attach_journal(journal)
            ha_on = False
            if args.ha and aa_ring is None:
                from .loadbalancer.journal import ha_failover_enabled
                ha_on = ha_failover_enabled()
                if not ha_on:
                    logger.warn(None, "--ha requested but "
                                      "CONFIG_whisk_ha_failover_enabled is "
                                      "false; running without failover")
            if snap_path or journal is not None:
                from .loadbalancer.checkpoint import (BalancerSnapshotter,
                                                      load_snapshot)
                if not ha_on:
                    # non-HA boot (and active/active: per-instance
                    # storage, so our own books restore immediately):
                    # restore right away (global HA defers the restore
                    # to the promotion that claims leadership)
                    load_snapshot(lb, snap_path or "", logger,
                                  cluster_size=args.cluster_size,
                                  journal=journal)
                if snap_path:
                    snapshotter = BalancerSnapshotter(
                        lb, snap_path,
                        args.balancer_snapshot_interval, logger,
                        journal=journal).start()
            if aa_ring is not None:
                lb.set_partition_mode(aa_ring)
                lb.spillover_depth = aa_cfg.spillover_depth

                async def on_partitions(gained, lost) -> None:
                    import json as _json
                    import os
                    for pid, epoch, *_rest in lost:
                        lb.set_partition_leadership(pid, epoch, False)
                    by_prev: dict = {}
                    for pid, epoch, prev in gained:
                        by_prev.setdefault(prev, []).append((pid, epoch))
                    for prev, items in by_prev.items():
                        pids = [p for p, _ in items]
                        if prev is not None and args.balancer_journal \
                                and hasattr(lb, "absorb_partitions"):
                            # absorb the previous owner's tail for
                            # exactly these partitions before placing
                            # into them. Absorb is journal replay —
                            # TPU-balancer only (the attach_journal gate
                            # above); other balancers hand off fence-
                            # only, and every absorb failure likewise
                            # degrades to fence-only. DELIBERATELY
                            # synchronous on the loop: blocking it is
                            # what gives replay exclusive access to the
                            # live books (no dispatch interleaves).
                            # The tradeoff: a missing previous snapshot
                            # replays the full foreign history, and a
                            # replay outlasting member_timeout_s can
                            # flap ownership (peers re-claim) — the
                            # per-partition fence keeps even that
                            # double-ownership window execution-safe
                            from .loadbalancer.journal import \
                                PlacementJournal
                            prev_dir = os.path.join(args.balancer_journal,
                                                    f"ctrl{prev}")
                            snap_doc = None
                            if args.balancer_snapshot:
                                try:
                                    with open(f"{args.balancer_snapshot}"
                                              f".ctrl{prev}") as f:
                                        snap_doc = _json.load(f)
                                except (OSError, ValueError):
                                    snap_doc = None
                            lb.absorb_partitions(
                                pids, PlacementJournal(prev_dir,
                                                       logger=logger),
                                snap_doc=snap_doc, logger=logger)
                        for pid, epoch in items:
                            lb.set_partition_leadership(pid, epoch, True)
            if ha_on:
                from .loadbalancer.checkpoint import load_snapshot

                async def on_leadership(epoch: int, active: bool) -> None:
                    if active:
                        # promotion: adopt the dead active's books before
                        # the first placement of the new epoch. Topology =
                        # the LIVE membership view (the dead active is
                        # leaving it), not the deploy-time seed
                        mem = getattr(controller, "membership", None)
                        size = (mem.cluster_size if mem is not None
                                else args.cluster_size)
                        load_snapshot(lb, args.balancer_snapshot or "",
                                      logger, cluster_size=size,
                                      journal=journal)
                    lb.set_leadership(epoch, active)

                # boot as standby: the membership protocol elects the
                # active (the lowest live instance claims epoch 1 after a
                # grace window; a later joiner finds the active already
                # asserting its epoch and stays standby)
                lb.set_leadership(0, False)
            # namespace default limits via the CONFIG_whisk_limits_* env
            # channel (ref: LIMITS_ACTIONS_INVOKES_* in
            # ansible/roles/controller/deploy.yml)
            lim = config_from_env().get("limits", {})
            controller = Controller(
                instance, provider, artifact_store=store, logger=logger,
                load_balancer=lb,
                invocations_per_minute=int(lim.get("invocations_per_minute", 60)),
                concurrent_invocations=int(lim.get("concurrent_invocations", 30)),
                fires_per_minute=int(lim.get("fires_per_minute", 60)))
            if ha_on:
                controller.ha_failover = True
                controller.on_leadership = on_leadership
            if aa_ring is not None:
                controller.ha_partition_ring = aa_ring
                controller.on_partitions = on_partitions
                if aa_cfg.spillover:
                    from .loadbalancer.spillover import SpilloverReceiver
                    controller.spillover_receiver = SpilloverReceiver(
                        provider, instance, lb, controller.entity_store,
                        logger=logger, metrics=logger.metrics)
            if args.role == "balancer":
                # device-owning process: additionally ingest
                # admission frames front-end workers funnel to our
                # ctrlfunnel<N> topic; started/stopped with the
                # controller (core.py lifecycle, like spillover)
                from .loadbalancer.funnel import FunnelReceiver
                controller.funnel_receiver = FunnelReceiver(
                    provider, instance, lb, controller.entity_store,
                    logger=logger, metrics=logger.metrics)
            if args.seed_guest:
                from ..standalone import guest_identity
                ident = guest_identity()
                await controller.auth_store.put(
                    WhiskAuthRecord(ident.subject, [ident.namespace],
                                    [ident.authkey]))
            await controller.start(host=args.host, port=args.port)
            if aa_ring is not None and aa_cfg.spillover:
                # the sender needs the live membership for its least-
                # loaded ranking, which exists only after start()
                from .loadbalancer.spillover import SpilloverSender
                lb.spillover_sink = SpilloverSender(
                    provider, controller.membership,
                    metrics=logger.metrics, logger=logger)
            print(f"controller{args.instance} up on :{args.port} "
                  f"(balancer={args.balancer}, bus={args.bus}"
                  + (f", partitions={aa_ring.n_partitions}"
                     if aa_ring is not None else "")
                  + (", role=balancer" if args.role == "balancer"
                     else "")
                  + (f", device={lb.device}" if args.balancer == "tpu"
                     else "") + ")", flush=True)
            await wait_for_shutdown()
        finally:
            if snapshotter is not None:
                # final dump (SIGTERM path): a clean restart then replays
                # no journal at all instead of up to one interval's worth
                await snapshotter.stop(final_dump=True)
            if controller is not None:
                await controller.stop()
            if journal is not None:
                await asyncio.to_thread(journal.close)
            if zipkin is not None:
                await zipkin.close()

    asyncio.run(run())


if __name__ == "__main__":
    main()
