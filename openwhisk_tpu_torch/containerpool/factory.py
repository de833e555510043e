"""ContainerFactory SPI + pool configuration.

Rebuild of common/scala/.../core/containerpool/ContainerFactory.scala:29-143:
the factory creates containers for a (kind, image, memory) request and owns
cleanup of leftovers from previous lives; ContainerPoolConfig derives cpu
shares from the memory share exactly like the reference (:46-61).
A copy of `openwhisk_tpu/containerpool/factory.py`, its providers the port's.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..core.entity import ByteSize, MB


@dataclass
class ContainerPoolConfig:
    """Ref ContainerPoolConfig (application.conf whisk.container-pool)."""
    user_memory: ByteSize = field(default_factory=lambda: MB(2048))
    concurrent_peek_factor: float = 0.5
    akka_client: bool = False  # kept for config parity; HTTP client is aiohttp
    prewarm_expiration_check_interval: float = 60.0
    idle_container_timeout: float = 600.0   # unusedTimeout (10 min)
    pause_grace: float = 0.05               # pauseGrace (50 ms in reference)

    def cpu_share(self, memory: ByteSize, total_share: int = 1024) -> int:
        """CPU share proportional to the container's memory share of the
        pool (ref ContainerFactory.scala:46-61)."""
        return max(2, int(total_share * memory.to_mb / max(1, self.user_memory.to_mb)))


#: shorthand name -> ContainerFactoryProvider SPI path; the single source
#: of truth for the invoker's --container-factory choices and the deploy
#: inventory's invokers.container_factory validation
FACTORY_PROVIDERS = {
    "process": "openwhisk_tpu_torch.containerpool.process_factory:ProcessContainerFactoryProvider",
    "docker": "openwhisk_tpu_torch.containerpool.docker_factory:DockerContainerFactoryProvider",
    "kubernetes": "openwhisk_tpu_torch.containerpool.kubernetes_factory:KubernetesContainerFactoryProvider",
    "yarn": "openwhisk_tpu_torch.containerpool.yarn_factory:YARNContainerFactoryProvider",
    "mesos": "openwhisk_tpu_torch.containerpool.mesos_factory:MesosContainerFactoryProvider",
}


class ContainerFactory:
    """SPI: async container creation + janitorial cleanup."""

    async def create_container(self, transid, name: str, image: str,
                               memory: ByteSize, cpu_shares: int = 0,
                               action=None):
        raise NotImplementedError

    async def init(self) -> None:
        """Post-construction hook, run by the invoker at boot. Defaults to
        reaping containers left over from a previous life (the reference
        initializes its factory with a stale-container cleanup,
        InvokerReactive.scala:129-147); drivers with a richer bootstrap
        (e.g. YARN's service registration) override this."""
        await self.cleanup()

    async def cleanup(self) -> None:
        """Remove any containers left over from a previous life
        (ref ContainerFactory.cleanup)."""

    async def close(self) -> None:
        await self.cleanup()
