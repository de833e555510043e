"""Docker container driver: shells out to the docker CLI.
A copy of `openwhisk_tpu/containerpool/docker_factory.py`.

Rebuild of core/invoker/.../containerpool/docker/DockerClient.scala:81-179
(+ DockerContainer.scala, DockerContainerFactory.scala): `docker run` with
memory/cpu-share flags, IP discovery via `docker inspect`, pause/unpause, and
janitorial `docker rm` of leftovers tagged with a name prefix. Parallel
`docker run`s are semaphore-limited exactly as the reference's
`maxParallelRuns`. Gated: only usable where a docker daemon exists (not in
the build environment — covered by the process driver + contract tests).
"""
from __future__ import annotations

import asyncio
import shutil
import uuid
from typing import List, Optional

from ..core.entity import ByteSize
from .container import Container, ContainerError
from .factory import ContainerFactory

NAME_PREFIX = "wsk_owtpu"


def docker_available() -> bool:
    return shutil.which("docker") is not None


async def _exec(args: List[str], timeout: float = 60.0) -> str:
    proc = await asyncio.create_subprocess_exec(
        *args, stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE)
    try:
        out, err = await asyncio.wait_for(proc.communicate(), timeout)
    except asyncio.TimeoutError:
        proc.kill()
        raise ContainerError(f"command timed out: {' '.join(args[:3])}")
    if proc.returncode != 0:
        raise ContainerError(f"{' '.join(args[:3])} failed ({proc.returncode}): "
                             f"{err.decode()[:512]}")
    return out.decode()


class DockerClient:
    """Thin async docker CLI wrapper (ref DockerClient.scala)."""

    def __init__(self, max_parallel_runs: int = 10):
        self._run_sem = asyncio.Semaphore(max_parallel_runs)

    async def run(self, image: str, args: List[str]) -> str:
        async with self._run_sem:
            out = await _exec(["docker", "run", "-d"] + args + [image])
            return out.strip()

    async def inspect_ip(self, container_id: str, network: str = "bridge") -> str:
        out = await _exec(["docker", "inspect", "--format",
                           "{{.NetworkSettings.Networks." + network + ".IPAddress}}",
                           container_id])
        ip = out.strip()
        if not ip or ip == "<no value>":
            raise ContainerError(f"no IP for container {container_id}")
        return ip

    async def pause(self, container_id: str) -> None:
        await _exec(["docker", "pause", container_id])

    async def unpause(self, container_id: str) -> None:
        await _exec(["docker", "unpause", container_id])

    async def rm(self, container_id: str) -> None:
        await _exec(["docker", "rm", "-f", container_id])

    async def ps(self, name_prefix: str = NAME_PREFIX, all_: bool = True) -> List[str]:
        out = await _exec(["docker", "ps", "-q"] + (["-a"] if all_ else []) +
                          ["--filter", f"name={name_prefix}"])
        return [l for l in out.splitlines() if l]

    async def pull(self, image: str) -> None:
        await _exec(["docker", "pull", image], timeout=600)

    async def logs(self, container_id: str, since: Optional[str] = None) -> str:
        args = ["docker", "logs", container_id]
        if since:
            args += ["--since", since]
        return await _exec(args)


class DockerContainer(Container):
    def __init__(self, client: DockerClient, container_id: str, ip: str,
                 kind: str, memory: ByteSize, port: int = 8080):
        super().__init__(container_id, (ip, port))
        self.client = client
        self.kind = kind
        self.memory = memory

    async def suspend(self) -> None:
        await self.client.pause(self.container_id)

    async def resume(self) -> None:
        await self.client.unpause(self.container_id)

    async def destroy(self) -> None:
        await super().destroy()
        await self.client.rm(self.container_id)

    async def logs(self, limit_bytes: int = 10 * 1024 * 1024,
                   wait_for_sentinel: bool = True) -> List[str]:
        raw = await self.client.logs(self.container_id)
        return raw.splitlines()[-1000:]


class DockerContainerFactory(ContainerFactory):
    def __init__(self, invoker_name: str = "invoker0",
                 client: Optional[DockerClient] = None,
                 network: str = "bridge", extra_args: Optional[List[str]] = None):
        if not docker_available():
            raise ContainerError("docker CLI not found on PATH")
        self.client = client or DockerClient()
        self.network = network
        self.extra_args = extra_args or []
        # per-invoker name prefix (ref DockerContainerFactory.scala names
        # containers wsk<id>_...): boot-time init()->cleanup() must reap
        # only THIS invoker's leftovers, never a co-hosted invoker's live
        # containers. Trailing '_' so "inv1" never prefix-matches "inv10".
        # `docker ps --filter name=` treats the value as an unanchored
        # regex, so the prefix is whitelisted to regex-inert chars and, when
        # sanitization lost information (e.g. 'inv:1' and 'inv/1' both map
        # to 'inv-1'), a CRC of the raw name keeps distinct invokers from
        # matching each other's containers.
        safe = "".join(c if (c.isalnum() or c == "_") else "-"
                       for c in invoker_name)
        if safe != invoker_name:
            import zlib
            safe += f"-{zlib.crc32(invoker_name.encode()) & 0xffff:04x}"
        self.name_prefix = f"{NAME_PREFIX}_{safe}_"

    async def create_container(self, transid, name: str, image: str,
                               memory: ByteSize, cpu_shares: int = 0,
                               action=None) -> DockerContainer:
        cname = f"{self.name_prefix}{name}_{uuid.uuid4().hex[:8]}"
        args = ["--name", cname, "--network", self.network,
                "-m", f"{memory.to_mb}m", "--memory-swap", f"{memory.to_mb}m"]
        if cpu_shares:
            args += ["--cpu-shares", str(cpu_shares)]
        args += self.extra_args
        cid = await self.client.run(image, args)
        ip = await self.client.inspect_ip(cid, self.network)
        return DockerContainer(self.client, cid, ip, kind=image, memory=memory)

    async def cleanup(self) -> None:
        for cid in await self.client.ps(name_prefix=self.name_prefix):
            try:
                await self.client.rm(cid)
            except ContainerError:
                pass


class DockerContainerFactoryProvider:
    """ContainerFactoryProvider SPI binding
    (CONFIG_whisk_spi_ContainerFactoryProvider=
     openwhisk_tpu_torch.containerpool.docker_factory:DockerContainerFactoryProvider)."""

    @staticmethod
    def instance(invoker_name: str = "invoker0", logger=None,
                 **kwargs) -> DockerContainerFactory:
        return DockerContainerFactory(invoker_name, **kwargs)
