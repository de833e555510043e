"""CLI: run a standalone invoker process against a bus + shared store.
A copy of `openwhisk_tpu/invoker/__main__.py`.

Rebuild of core/invoker/.../Invoker.scala main: connect to the bus, claim a
stable instance id for --unique-name (store-backed CAS, no Zookeeper), start
the container pool and the activation feed, ping health at 1 Hz.

  python -m openwhisk_tpu_torch.invoker --bus 127.0.0.1:4222 --db /path/whisks.db \
      --unique-name invoker-a --memory 2048
"""
from __future__ import annotations

import argparse
import asyncio

from ..containerpool import ContainerPoolConfig
from ..containerpool.factory import FACTORY_PROVIDERS
from ..core.entity import ExecManifest, InvokerInstanceId, MB
from ..database import ArtifactActivationStore, EntityStore, open_store
from ..messaging import provider_for_bus
from ..utils.logging import Logging
from .id_assigner import InstanceIdAssigner
from .reactive import InvokerReactive
from .server import InvokerServer
from ..utils.tasks import wait_for_shutdown


def main() -> None:
    parser = argparse.ArgumentParser(description="OpenWhisk-TPU invoker")
    parser.add_argument("--bus", default="127.0.0.1:4222", help="broker host:port")
    parser.add_argument("--db", required=True, help="shared sqlite store path")
    parser.add_argument("--unique-name", required=True,
                        help="stable name; maps to a persistent invoker id")
    parser.add_argument("--id", type=int, default=None,
                        help="force this invoker id (overrides assignment)")
    parser.add_argument("--memory", type=int, default=2048, help="user memory MB")
    parser.add_argument("--port", type=int, default=0, help="liveness /ping port")
    parser.add_argument("--prewarm", action="store_true")
    parser.add_argument(
        "--container-factory", default=None,
        choices=tuple(FACTORY_PROVIDERS),
        help="container driver shorthand; without it the "
             "ContainerFactoryProvider SPI resolves (default: process; "
             "override via CONFIG_whisk_spi_ContainerFactoryProvider)")
    args = parser.parse_args()

    async def run():
        logger = Logging(level="info")
        from ..utils.tracing import maybe_enable_zipkin
        zipkin = maybe_enable_zipkin(f"invoker-{args.unique_name}")
        invoker = server = None
        try:
            ExecManifest.initialize()
            provider = provider_for_bus(args.bus)
            store = open_store(args.db)
            instance_id = await InstanceIdAssigner(store).assign(
                args.unique_name, args.id)
            instance = InvokerInstanceId(instance_id,
                                         unique_name=args.unique_name,
                                         user_memory=MB(args.memory))
            # container driver through the SPI seam (ref reference.conf
            # ContainerFactoryProvider); the CLI shorthand binds it
            from .. import spi
            if args.container_factory:
                spi.bind("ContainerFactoryProvider", FACTORY_PROVIDERS[
                    args.container_factory])
            factory = spi.get("ContainerFactoryProvider").instance(
                invoker_name=args.unique_name, logger=logger)
            # fleet observatory: announce this invoker's admin
            # address on its health pings so controllers can build the
            # peer directory. Gated at WIRING time — disabled keeps the
            # ping payload byte-exact with pre-observatory builds.
            from ..utils.eventlog import fleet_config, set_identity
            fleet_cfg = fleet_config()
            admin_url = (f"http://127.0.0.1:{args.port}"
                         if fleet_cfg.enabled and args.port else None)
            if fleet_cfg.enabled:
                set_identity(instance=instance_id, role="invoker")
            invoker = InvokerReactive(
                instance, provider, EntityStore(store),
                ArtifactActivationStore(store), factory,
                pool_config=ContainerPoolConfig(user_memory=MB(args.memory),
                                                pause_grace=1.0),
                logger=logger, admin_url=admin_url)
            # host hot-loop observatory on the invoker's loop too: the
            # pickup/ack path is half of the per-activation Python the
            # 10k/s arc must attack. Installed BEFORE start() so the
            # long-running feed/pinger tasks ride the stall interposer
            # (off via CONFIG_whisk_hostProfiling_enabled=false).
            from ..utils.hostprof import GLOBAL_HOST_OBSERVATORY
            GLOBAL_HOST_OBSERVATORY.install(metrics=logger.metrics)
            await invoker.start(start_prewarm=args.prewarm)
            if args.port:
                server = InvokerServer(invoker, args.port)
                await server.start()
            print(f"invoker{instance_id} ({args.unique_name}) up — "
                  f"bus {args.bus}, memory {args.memory}MB", flush=True)
            await wait_for_shutdown()
        finally:
            from ..utils.hostprof import GLOBAL_HOST_OBSERVATORY
            GLOBAL_HOST_OBSERVATORY.uninstall()
            if server:
                await server.stop()
            if invoker is not None:
                await invoker.stop()
            if zipkin is not None:
                await zipkin.close()

    asyncio.run(run())


if __name__ == "__main__":
    main()
