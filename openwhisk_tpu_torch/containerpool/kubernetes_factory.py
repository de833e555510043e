"""Kubernetes container driver: action pods via the k8s REST API.
A copy of `openwhisk_tpu/containerpool/kubernetes_factory.py`.

Rebuild of core/invoker/.../containerpool/kubernetes/ (KubernetesClient.scala,
KubernetesContainer.scala, KubernetesContainerFactory.scala,
WhiskPodBuilder.scala): each activation container is a Pod created through
the API server, labelled for janitorial cleanup, addressed by its podIP, and
log-streamed over the pods/{name}/log subresource. Where the reference uses
the fabric8 JVM client, this speaks the REST API directly over aiohttp —
there is no TPU involvement here (host-side control plane), so the driver
stays a thin async HTTP client that any conformant API server satisfies
(tests run it against an in-process fake server).

Pause/resume: Kubernetes has no pod-pause primitive; like the reference the
driver treats suspend/resume as no-ops and relies on the pool's idle-timeout
eviction instead.
"""
from __future__ import annotations

import asyncio
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import aiohttp

from ..core.entity import ByteSize
from .container import Container, ContainerError
from .factory import ContainerFactory

INVOKER_LABEL = "openwhisk/invoker"
ACTION_LABEL = "openwhisk/action"

_LABEL_OK = set("abcdefghijklmnopqrstuvwxyz"
                "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789")


def _label_value(name: str) -> str:
    """Sanitize to a valid k8s label value: ASCII [A-Za-z0-9._-], ≤63 chars,
    starts and ends alphanumeric."""
    cleaned = "".join(c if (c in _LABEL_OK or c in "._-") else "."
                      for c in name)[:63]
    cleaned = cleaned.strip("._-")
    return cleaned or "unknown"


@dataclass
class KubernetesClientConfig:
    """Ref KubernetesClientConfig (application.conf whisk.kubernetes)."""
    api_server: str = "http://127.0.0.1:8001"   # e.g. kubectl proxy
    namespace: str = "openwhisk"
    token: Optional[str] = None
    timeout_s: float = 60.0
    cpu_scale_millis_per_mb: Optional[float] = None  # ref: cpu-scaling
    user_pod_node_affinity: Optional[Dict[str, str]] = None
    pod_template: Dict[str, Any] = field(default_factory=dict)
    action_port: int = 8080


class WhiskPodBuilder:
    """Builds the action-pod manifest (ref WhiskPodBuilder.scala): image,
    memory request==limit, optional cpu scaled from memory, restart-never,
    labels for cleanup + per-invoker accounting, optional node affinity, and
    an operator-supplied pod template merged underneath."""

    def __init__(self, config: KubernetesClientConfig, invoker_name: str):
        self.config = config
        self.invoker_name = invoker_name

    def build(self, name: str, image: str, memory: ByteSize,
              action_name: str = "") -> Dict[str, Any]:
        resources: Dict[str, Any] = {
            "requests": {"memory": f"{memory.to_mb}Mi"},
            "limits": {"memory": f"{memory.to_mb}Mi"},
        }
        if self.config.cpu_scale_millis_per_mb:
            millis = max(1, int(memory.to_mb * self.config.cpu_scale_millis_per_mb))
            resources["requests"]["cpu"] = f"{millis}m"
            resources["limits"]["cpu"] = f"{millis}m"
        spec: Dict[str, Any] = {
            "restartPolicy": "Never",
            "containers": [{
                "name": "user-action",
                "image": image,
                "ports": [{"containerPort": self.config.action_port,
                           "name": "action"}],
                "resources": resources,
            }],
        }
        if self.config.user_pod_node_affinity:
            spec["nodeSelector"] = dict(self.config.user_pod_node_affinity)
        pod = {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": name,
                "namespace": self.config.namespace,
                "labels": {
                    "name": name,
                    INVOKER_LABEL: self.invoker_name,
                    # label values allow [A-Za-z0-9._-] only, max 63 chars,
                    # and must start/end alphanumeric (ASCII)
                    ACTION_LABEL: _label_value(action_name),
                },
            },
            "spec": spec,
        }
        # operator template merged underneath (explicit fields win)
        tmpl = self.config.pod_template
        if tmpl:
            merged = _deep_merge(tmpl, pod)
            return merged
        return pod


def _deep_merge(base: Dict[str, Any], over: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


class KubernetesClient:
    """Async REST client for the pod lifecycle (ref KubernetesClient.scala).
    Only the five calls the invoker needs: create, wait-ready, delete,
    list-by-label, and log read."""

    def __init__(self, config: Optional[KubernetesClientConfig] = None):
        self.config = config or KubernetesClientConfig()
        self._session: Optional[aiohttp.ClientSession] = None

    def _http(self) -> aiohttp.ClientSession:
        if self._session is None or self._session.closed:
            headers = {}
            if self.config.token:
                headers["Authorization"] = f"Bearer {self.config.token}"
            self._session = aiohttp.ClientSession(headers=headers)
        return self._session

    def _url(self, path: str) -> str:
        return (f"{self.config.api_server}/api/v1/namespaces/"
                f"{self.config.namespace}{path}")

    async def create_pod(self, manifest: Dict[str, Any]) -> Dict[str, Any]:
        async with self._http().post(self._url("/pods"), json=manifest,
                                     timeout=aiohttp.ClientTimeout(
                                         total=self.config.timeout_s)) as resp:
            if resp.status not in (200, 201):
                raise ContainerError(
                    f"pod create failed ({resp.status}): "
                    f"{(await resp.text())[:512]}")
            return await resp.json(content_type=None)

    async def get_pod(self, name: str) -> Dict[str, Any]:
        async with self._http().get(self._url(f"/pods/{name}")) as resp:
            if resp.status == 404:
                raise ContainerError(f"pod {name} not found")
            return await resp.json(content_type=None)

    async def wait_ready(self, name: str, poll_s: float = 0.05) -> str:
        """Poll until the pod is Running with a podIP; return the IP
        (ref KubernetesClient.run's readiness watch)."""
        deadline = asyncio.get_event_loop().time() + self.config.timeout_s
        while True:
            pod = await self.get_pod(name)
            status = pod.get("status", {})
            phase = status.get("phase")
            ip = status.get("podIP")
            if phase == "Running" and ip:
                return ip
            if phase in ("Failed", "Succeeded"):
                raise ContainerError(f"pod {name} entered terminal phase {phase}")
            if asyncio.get_event_loop().time() > deadline:
                raise ContainerError(f"pod {name} not ready within "
                                     f"{self.config.timeout_s}s (phase={phase})")
            await asyncio.sleep(poll_s)

    async def delete_pod(self, name: str) -> None:
        async with self._http().delete(self._url(f"/pods/{name}")) as resp:
            if resp.status not in (200, 202, 404):
                raise ContainerError(f"pod delete failed ({resp.status})")
            await resp.read()

    async def list_pods(self, label_selector: str) -> List[Dict[str, Any]]:
        async with self._http().get(
                self._url("/pods"),
                params={"labelSelector": label_selector}) as resp:
            if resp.status != 200:
                raise ContainerError(
                    f"pod list failed ({resp.status}): "
                    f"{(await resp.text())[:512]}")
            body = await resp.json(content_type=None)
            return body.get("items", [])

    async def read_log(self, name: str, since_time: Optional[str] = None) -> str:
        params = {}
        if since_time:
            params["sinceTime"] = since_time
        async with self._http().get(self._url(f"/pods/{name}/log"),
                                    params=params) as resp:
            return await resp.text()

    async def close(self) -> None:
        if self._session:
            await self._session.close()
            self._session = None


class KubernetesContainer(Container):
    """A pod-backed container (ref KubernetesContainer.scala). suspend and
    resume are no-ops: k8s cannot freeze a pod."""

    def __init__(self, client: KubernetesClient, pod_name: str, ip: str,
                 port: int = 8080):
        super().__init__(pod_name, (ip, port))
        self.client = client
        self._log_offset = 0  # chars already attributed to past activations

    async def suspend(self) -> None:
        pass

    async def resume(self) -> None:
        pass

    async def destroy(self) -> None:
        await super().destroy()
        await self.client.delete_pod(self.container_id)

    async def logs(self, limit_bytes: int = 10 * 1024 * 1024,
                   wait_for_sentinel: bool = True,
                   sentinel_timeout: float = 2.0) -> List[str]:
        """Only the lines this activation produced: the k8s log endpoint
        always returns the full stream, so the driver tracks a per-container
        offset (warm reuse). Polls until the runtime's end-of-activation
        sentinel shows up past the offset (the runtime may not have flushed
        yet when /run returns), then advances the offset past it so a late
        tail is never misattributed to the next activation — same contract
        as the process/docker drivers."""
        import asyncio

        from .container import ACTIVATION_LOG_SENTINEL
        # the pod log endpoint merges stdout+stderr, and the runtime writes
        # the sentinel to BOTH streams — a complete activation therefore ends
        # with two complete sentinel lines in the merged stream
        marker = ACTIVATION_LOG_SENTINEL + "\n"
        deadline = asyncio.get_event_loop().time() + sentinel_timeout
        while True:
            raw = await self.client.read_log(self.container_id)
            fresh = raw[self._log_offset:]
            complete = fresh.count(marker)  # only fully-written sentinel lines
            if complete >= 2 or not wait_for_sentinel:
                break
            if asyncio.get_event_loop().time() > deadline:
                break
            await asyncio.sleep(0.05)
        if complete:
            # consume through the LAST complete sentinel line; a partial
            # sentinel still being written stays for the next call
            end = 0
            for _ in range(complete):
                end = fresh.index(marker, end) + len(marker)
            head = fresh[:end]
            self._log_offset += end
        else:
            head = fresh
            self._log_offset += len(fresh)
        lines = [l for l in head.splitlines()
                 if ACTIVATION_LOG_SENTINEL not in l and l]
        out, total = [], 0
        for l in lines:
            total += len(l.encode()) + 1
            if total > limit_bytes:
                break
            out.append(l)
        return out


class KubernetesContainerFactory(ContainerFactory):
    """ContainerFactory over pods (ref KubernetesContainerFactory.scala):
    create builds + waits on a labelled pod; cleanup deletes every pod this
    invoker ever labelled (leftovers of a previous life)."""

    def __init__(self, invoker_name: str = "invoker0",
                 config: Optional[KubernetesClientConfig] = None,
                 client: Optional[KubernetesClient] = None):
        self.config = config or KubernetesClientConfig()
        self.client = client or KubernetesClient(self.config)
        self.invoker_name = invoker_name
        self.builder = WhiskPodBuilder(self.config, invoker_name)

    async def create_container(self, transid, name: str, image: str,
                               memory: ByteSize, cpu_shares: int = 0,
                               action=None) -> KubernetesContainer:
        pod_name = f"wsk-{name}-{uuid.uuid4().hex[:8]}".lower().replace("_", "-")
        action_name = str(getattr(action, "fully_qualified_name", "") or "") \
            if action else ""
        manifest = self.builder.build(pod_name, image, memory, str(action_name))
        await self.client.create_pod(manifest)
        try:
            ip = await self.client.wait_ready(pod_name)
        except ContainerError:
            await self.client.delete_pod(pod_name)
            raise
        return KubernetesContainer(self.client, pod_name, ip,
                                   port=self.config.action_port)

    async def cleanup(self) -> None:
        try:
            pods = await self.client.list_pods(
                f"{INVOKER_LABEL}={self.invoker_name}")
        except (ContainerError, aiohttp.ClientError, OSError):
            return  # janitorial only — an unreachable API must not abort close
        for pod in pods:
            name = pod.get("metadata", {}).get("name")
            if name:
                try:
                    await self.client.delete_pod(name)
                except ContainerError:
                    pass

    async def close(self) -> None:
        await self.cleanup()
        await self.client.close()


class KubernetesContainerFactoryProvider:
    """ContainerFactoryProvider SPI binding
    (CONFIG_whisk_spi_ContainerFactoryProvider=
     openwhisk_tpu_torch.containerpool.kubernetes_factory:KubernetesContainerFactoryProvider)."""

    @staticmethod
    def instance(invoker_name: str = "invoker0", logger=None,
                 **kwargs) -> KubernetesContainerFactory:
        return KubernetesContainerFactory(invoker_name, **kwargs)
