"""Mesos container driver: action tasks via a Mesos framework bridge.
A copy of `openwhisk_tpu/containerpool/mesos_factory.py`.

Rebuild of common/scala/.../core/mesos/ (MesosContainerFactory.scala,
MesosTask.scala): the reference registers a Mesos *framework* (through the
mesos-actor library) and launches one Mesos task per action container with
bridge networking and a dynamically assigned host port; the task's agent
hostname + host port become the container address. Here the framework side
is an HTTP bridge service (the operator runs the scheduler; tests run an
in-process fake): POST /tasks launches a task and returns its address,
DELETE /tasks/{id} kills it. Task parameters mirror the reference's
TaskDef: image, cpus, memory, network=BRIDGE.

Gated: usable wherever a bridge endpoint is reachable.
"""
from __future__ import annotations

import uuid
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import aiohttp

from ..core.entity import ByteSize
from .container import Container, ContainerError
from .factory import ContainerFactory


@dataclass
class MesosConfig:
    """Ref MesosConfig (application.conf whisk.mesos)."""
    master_url: str = "http://127.0.0.1:5050"
    role: str = "*"
    failover_timeout_s: float = 0.0
    task_launch_timeout_s: float = 45.0
    # off by default: tearing down destroys the framework for EVERY invoker
    # sharing the bridge; enable only for a dedicated single-invoker bridge
    teardown_on_exit: bool = False
    cpus: float = 0.1


class MesosBridgeClient:
    """Async client for the framework bridge (the reference's mesos-actor
    in-JVM equivalent, moved out-of-process)."""

    def __init__(self, config: MesosConfig):
        self.config = config
        self._session: Optional[aiohttp.ClientSession] = None

    def _http(self) -> aiohttp.ClientSession:
        if self._session is None or self._session.closed:
            self._session = aiohttp.ClientSession()
        return self._session

    async def submit(self, task: Dict[str, Any]) -> Dict[str, Any]:
        async with self._http().post(
                f"{self.config.master_url}/tasks", json=task,
                timeout=aiohttp.ClientTimeout(
                    total=self.config.task_launch_timeout_s)) as resp:
            body = await resp.json(content_type=None)
            if resp.status not in (200, 201):
                raise ContainerError(
                    f"mesos task launch failed ({resp.status}): {body}")
            if not body.get("host") or not body.get("port"):
                raise ContainerError(f"mesos task has no address: {body}")
            return body

    async def kill(self, task_id: str) -> None:
        async with self._http().delete(
                f"{self.config.master_url}/tasks/{task_id}") as resp:
            if resp.status not in (200, 202, 404):
                raise ContainerError(f"mesos task kill failed ({resp.status})")
            await resp.read()

    async def list_tasks(self, prefix: str) -> List[str]:
        async with self._http().get(f"{self.config.master_url}/tasks",
                                    params={"prefix": prefix}) as resp:
            body = await resp.json(content_type=None)
            return [t["id"] for t in body.get("items", []) if "id" in t]

    async def teardown(self) -> None:
        async with self._http().post(
                f"{self.config.master_url}/teardown") as resp:
            await resp.read()

    async def close(self) -> None:
        if self._session:
            await self._session.close()
            self._session = None


class MesosContainer(Container):
    """A Mesos-task-backed container (ref MesosTask.scala). Mesos offers no
    pause primitive; suspend/resume are no-ops as in the reference."""

    def __init__(self, client: MesosBridgeClient, task_id: str,
                 host: str, port: int):
        super().__init__(task_id, (host, port))
        self.client = client

    async def suspend(self) -> None:
        pass

    async def resume(self) -> None:
        pass

    async def destroy(self) -> None:
        await super().destroy()
        await self.client.kill(self.container_id)

    async def logs(self, limit_bytes: int = 10 * 1024 * 1024,
                   wait_for_sentinel: bool = True) -> List[str]:
        # ref MesosTask: logs live in the Mesos sandbox, out-of-band
        return [f"Logs are in the Mesos sandbox for task {self.container_id}"]


class MesosContainerFactory(ContainerFactory):
    def __init__(self, invoker_name: str = "invoker0",
                 config: Optional[MesosConfig] = None,
                 client: Optional[MesosBridgeClient] = None):
        self.config = config or MesosConfig()
        self.client = client or MesosBridgeClient(self.config)
        # task ids carry the invoker identity so cleanup/teardown of one
        # invoker never reaps another invoker's live tasks on a shared
        # bridge; trailing '-' so "invoker1" never prefix-matches "invoker10"
        self.task_prefix = f"whisk-{invoker_name}-"

    async def create_container(self, transid, name: str, image: str,
                               memory: ByteSize, cpu_shares: int = 0,
                               action=None) -> MesosContainer:
        task_id = f"{self.task_prefix}{name}-{uuid.uuid4().hex[:8]}"
        body = await self.client.submit({
            "id": task_id,
            "image": image,
            "cpus": self.config.cpus,
            "mem_mb": memory.to_mb,
            "network": "BRIDGE",
            "role": self.config.role,
        })
        return MesosContainer(self.client, task_id, body["host"],
                              int(body["port"]))

    async def cleanup(self) -> None:
        for task_id in await self.client.list_tasks(self.task_prefix):
            try:
                await self.client.kill(task_id)
            except ContainerError:
                pass

    async def close(self) -> None:
        await self.cleanup()
        if self.config.teardown_on_exit:
            try:
                await self.client.teardown()
            except (ContainerError, aiohttp.ClientError, OSError):
                pass
        await self.client.close()


class MesosContainerFactoryProvider:
    """ContainerFactoryProvider SPI binding
    (CONFIG_whisk_spi_ContainerFactoryProvider=
     openwhisk_tpu_torch.containerpool.mesos_factory:MesosContainerFactoryProvider)."""

    @staticmethod
    def instance(invoker_name: str = "invoker0", logger=None,
                 **kwargs) -> MesosContainerFactory:
        return MesosContainerFactory(invoker_name, **kwargs)
