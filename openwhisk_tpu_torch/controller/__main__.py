"""CLI: run a controller process against a bus + shared store.
A copy of `openwhisk_tpu/controller/__main__.py` at `--role all`.

Rebuild of core/controller/.../Controller.scala main for distributed mode:
REST API + a real balancer (the TPU balancer on the CUDA card, or the CPU
sharding balancer) fed by invoker health pings over the bus.

  python -m openwhisk_tpu_torch.controller --bus 127.0.0.1:4222 \
      --db /path/whisks.db --port 3233 --balancer tpu \
      --instance 0 --cluster-size 1

The TPU balancer places on the card unless `--device cpu` asks for the
plain torch path; without a card the default exits non-zero with the
reason and never carries on on the CPU. HA failover (`--ha`) and the
funnel roles (`--role frontend|balancer`, `--funnel-to`,
`--funnel-depth`) are refused by name: they are not ported yet.
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

#: the reference's options that this controller refuses (multi-controller
#: HA and the admission funnel are not ported yet)
NOT_PORTED = "not ported (ROADMAP Queue 1 item 7)"


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
                        help=f"epoch-fenced active/standby failover: "
                             f"{NOT_PORTED}")
    parser.add_argument("--balancer-rate-limit", type=int, default=None,
                        help="per-namespace activations/minute enforced by "
                             "the DEVICE token bucket fused into the TPU "
                             "placement step (bus-boundary backstop behind "
                             "the front door's entitlement throttle)")
    parser.add_argument("--role", choices=("all", "frontend", "balancer"),
                        default="all",
                        help=f"multi-process deployment role: 'all' "
                             f"(default) runs here; 'frontend' and "
                             f"'balancer' are {NOT_PORTED}")
    parser.add_argument("--funnel-to", type=int, default=None,
                        help=f"(--role frontend) {NOT_PORTED}")
    parser.add_argument("--funnel-depth", type=int, default=None,
                        help=f"(--role frontend) {NOT_PORTED}")
    args = parser.parse_args()
    if args.ha:
        parser.error(f"--ha is {NOT_PORTED}")
    if args.role != "all":
        parser.error(f"--role {args.role} is {NOT_PORTED}")
    for flag in ("funnel_to", "funnel_depth"):
        if getattr(args, flag) is not None:
            parser.error(f"--{flag.replace('_', '-')} is {NOT_PORTED}")
    if args.balancer == "tpu":
        # the card unless --device cpu: fail before booting anything
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
            journal_dir = args.balancer_journal
            snap_path = args.balancer_snapshot
            if journal_dir and hasattr(lb, "attach_journal"):
                from .loadbalancer.journal import journal_from_config
                journal = journal_from_config(journal_dir, logger=logger)
                if journal is not None:
                    lb.attach_journal(journal)
            if snap_path or journal is not None:
                from .loadbalancer.checkpoint import (BalancerSnapshotter,
                                                      load_snapshot)
                load_snapshot(lb, snap_path or "", logger,
                              cluster_size=args.cluster_size,
                              journal=journal)
                if snap_path:
                    snapshotter = BalancerSnapshotter(
                        lb, snap_path,
                        args.balancer_snapshot_interval, logger,
                        journal=journal).start()
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
            if args.seed_guest:
                from ..standalone import guest_identity
                ident = guest_identity()
                await controller.auth_store.put(
                    WhiskAuthRecord(ident.subject, [ident.namespace],
                                    [ident.authkey]))
            await controller.start(host=args.host, port=args.port)
            print(f"controller{args.instance} up on :{args.port} "
                  f"(balancer={args.balancer}, bus={args.bus}"
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
