"""YARN container driver: action containers via the YARN services REST API.
A copy of `openwhisk_tpu/containerpool/yarn_factory.py`.

Rebuild of core/invoker/.../containerpool/yarn/ (YARNContainerFactory.scala,
YARNComponentActor.scala, YARNRESTUtil.scala): at init the factory registers
one YARN *service* per invoker whose *components* are the action image kinds,
each starting at 0 instances; creating a container flexes the matching
component +1 and polls the service status until the new container reports
READY with an IP; destroying flexes -1. The reference's actor-per-component
serialization of flex ops becomes one asyncio lock per component here.

Gated: usable wherever a YARN RM with the services API (or the in-process
fake in tests) is reachable.
"""
from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import aiohttp

from ..core.entity import ByteSize
from .container import Container, ContainerError
from .factory import ContainerFactory


@dataclass
class YARNConfig:
    """Ref YARNConfig (application.conf whisk.yarn)."""
    master_url: str = "http://127.0.0.1:8088"
    yarn_link_log_message: bool = True
    service_name: str = "openwhisk-action-service"
    auth: Optional[str] = None          # "simple" user name, appended as ?user.name=
    cpus: int = 1
    memory_fallback_mb: int = 256
    action_port: int = 8080


def _component_name(image: str) -> str:
    """YARN component names: [a-z0-9-], derived from the image kind."""
    return "".join(c if c.isalnum() else "-" for c in image.lower()).strip("-")[:63]


class YARNClient:
    """Async client for the subset of the services API the invoker needs
    (ref YARNRESTUtil.scala)."""

    def __init__(self, config: YARNConfig):
        self.config = config
        self._session: Optional[aiohttp.ClientSession] = None

    def _http(self) -> aiohttp.ClientSession:
        if self._session is None or self._session.closed:
            self._session = aiohttp.ClientSession()
        return self._session

    def _url(self, path: str) -> str:
        url = f"{self.config.master_url}/app/v1/services{path}"
        if self.config.auth:
            url += f"?user.name={self.config.auth}"
        return url

    async def create_service(self, definition: Dict[str, Any]) -> None:
        async with self._http().post(self._url(""), json=definition) as resp:
            if resp.status not in (200, 202):
                raise ContainerError(
                    f"YARN service create failed ({resp.status}): "
                    f"{(await resp.text())[:512]}")

    async def describe(self, service: str) -> Dict[str, Any]:
        async with self._http().get(self._url(f"/{service}")) as resp:
            if resp.status != 200:
                raise ContainerError(f"YARN describe failed ({resp.status})")
            return await resp.json(content_type=None)

    async def add_component(self, service: str, component: str, image: str,
                            cpus: int, memory_mb: int) -> None:
        """Declare a component with its artifact + resource spec (the
        reference pre-declares every runtime kind at service creation from
        the ExecManifest; we declare lazily on first use)."""
        async with self._http().put(
                self._url(f"/{service}"),
                json={"components": [{
                    "name": component,
                    "number_of_containers": 0,
                    "artifact": {"id": image, "type": "DOCKER"},
                    "resource": {"cpus": cpus, "memory": str(memory_mb)},
                    "launch_command": "",
                    "restart_policy": "NEVER",
                }]}) as resp:
            if resp.status not in (200, 202):
                raise ContainerError(
                    f"YARN add component {component} failed ({resp.status}): "
                    f"{(await resp.text())[:512]}")
            await resp.read()

    async def flex(self, service: str, component: str, count: int,
                   decommission: Optional[List[str]] = None) -> None:
        body: Dict[str, Any] = {"number_of_containers": count}
        if decommission:
            # remove THESE instances, not an arbitrary newest one
            body["decommissioned_instances"] = list(decommission)
        async with self._http().put(
                self._url(f"/{service}/components/{component}"),
                json=body) as resp:
            if resp.status not in (200, 202):
                raise ContainerError(
                    f"YARN flex {component}={count} failed ({resp.status})")
            await resp.read()

    async def delete_service(self, service: str) -> None:
        async with self._http().delete(self._url(f"/{service}")) as resp:
            if resp.status not in (200, 202, 204, 404):
                raise ContainerError(f"YARN service delete failed ({resp.status})")
            await resp.read()

    async def close(self) -> None:
        if self._session:
            await self._session.close()
            self._session = None


class YARNContainer(Container):
    def __init__(self, factory: "YARNContainerFactory", component: str,
                 yarn_container_id: str, ip: str, port: int):
        super().__init__(yarn_container_id, (ip, port))
        self.factory = factory
        self.component = component

    async def suspend(self) -> None:   # YARN cannot freeze a container
        pass

    async def resume(self) -> None:
        pass

    async def destroy(self) -> None:
        await super().destroy()
        await self.factory.release(self)

    async def logs(self, limit_bytes: int = 10 * 1024 * 1024,
                   wait_for_sentinel: bool = True) -> List[str]:
        # ref: YARN log aggregation is out-of-band; emit the pointer line
        # the reference logs (yarn_link_log_message)
        return [f"Logs are in the YARN UI for container {self.container_id}"]


class YARNContainerFactory(ContainerFactory):
    def __init__(self, invoker_name: str = "invoker0",
                 config: Optional[YARNConfig] = None,
                 client: Optional[YARNClient] = None):
        self.config = config or YARNConfig()
        self.client = client or YARNClient(self.config)
        self.service = f"{self.config.service_name}-{invoker_name}".lower()
        self._components: Dict[str, int] = {}          # component -> target count
        self._known: Dict[str, set] = {}               # component -> seen container ids
        self._locks: Dict[str, asyncio.Lock] = {}      # serialize flex per component
        self._poll_s = 0.05
        self._timeout_s = 60.0

    def _lock(self, component: str) -> asyncio.Lock:
        return self._locks.setdefault(component, asyncio.Lock())

    async def init(self) -> None:
        await self.cleanup()
        await self.client.create_service({
            "name": self.service,
            "version": "1.0.0",
            "components": [],
        })

    async def _ensure_component(self, component: str, image: str,
                                memory_mb: int) -> None:
        if component in self._components:
            return
        await self.client.add_component(self.service, component, image,
                                        self.config.cpus,
                                        memory_mb or self.config.memory_fallback_mb)
        self._components[component] = 0
        self._known[component] = set()

    async def create_container(self, transid, name: str, image: str,
                               memory: ByteSize, cpu_shares: int = 0,
                               action=None) -> YARNContainer:
        component = _component_name(image)
        # serialize only the flex (count bump); the slow readiness poll runs
        # unlocked so concurrent cold starts of one kind overlap, and each
        # new container id is claimed under the lock so no two callers can
        # adopt the same instance
        async with self._lock(component):
            await self._ensure_component(component, image, memory.to_mb)
            self._components[component] += 1
            await self.client.flex(self.service, component,
                                   self._components[component])
        return await self._await_new_container(component)

    async def _await_new_container(self, component: str) -> YARNContainer:
        deadline = asyncio.get_event_loop().time() + self._timeout_s
        while True:
            desc = await self.client.describe(self.service)
            for comp in desc.get("components", []):
                if comp.get("name") != component:
                    continue
                for c in comp.get("containers", []):
                    cid = c.get("id")
                    if (cid and c.get("state") == "READY" and c.get("ip")):
                        async with self._lock(component):
                            if cid in self._known[component]:
                                continue  # another caller claimed it
                            self._known[component].add(cid)
                        return YARNContainer(self, component, cid, c["ip"],
                                             self.config.action_port)
            if asyncio.get_event_loop().time() > deadline:
                raise ContainerError(
                    f"YARN container for {component} not READY within "
                    f"{self._timeout_s}s")
            await asyncio.sleep(self._poll_s)

    async def release(self, container: YARNContainer) -> None:
        component = container.component
        async with self._lock(component):
            self._known[component].discard(container.container_id)
            self._components[component] = max(0, self._components[component] - 1)
            # decommission THIS instance: a bare flex-down lets YARN pick an
            # arbitrary (possibly live, in-use) container to kill
            await self.client.flex(self.service, component,
                                   self._components[component],
                                   decommission=[container.container_id])

    async def cleanup(self) -> None:
        try:
            await self.client.delete_service(self.service)
        except ContainerError:
            pass
        self._components.clear()
        self._known.clear()

    async def close(self) -> None:
        await self.cleanup()
        await self.client.close()


class YARNContainerFactoryProvider:
    """ContainerFactoryProvider SPI binding
    (CONFIG_whisk_spi_ContainerFactoryProvider=
     openwhisk_tpu_torch.containerpool.yarn_factory:YARNContainerFactoryProvider)."""

    @staticmethod
    def instance(invoker_name: str = "invoker0", logger=None,
                 **kwargs) -> YARNContainerFactory:
        return YARNContainerFactory(invoker_name, **kwargs)
