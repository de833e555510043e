"""LogStore SPI: per-activation log collection + retrieval.

Rebuild of common/scala/.../core/containerpool/logging/ — the SPI has two
sides (LogStore.scala): `collect_logs` runs invoker-side after each
activation, `fetch_logs` serves `GET .../activations/{id}/logs` controller-
side. Impl inventory mirrors the reference:

  ContainerLogStore        DockerToActivationLogStore — read the container's
                           sentinel-framed stdout/stderr into the activation
                           record (+ optional file sink =
                           DockerToActivationFileLogStore).
  LogDriverLogStore        logs ship out-of-band via the platform's log
                           driver; nothing collected, nothing fetchable.
  ElasticSearchLogStore    logs ship out-of-band; fetch queries an
                           Elasticsearch-compatible HTTP API per activation.
  SplunkLogStore           same, against a Splunk search endpoint.

The remote stores take an injectable async `http_client(method, url, body,
headers) -> dict` so deployments wire their own transport/auth and tests run
without a network.
"""
from __future__ import annotations

import json
from typing import Any, Callable, Dict, List, Optional

LOG_FIELDS = ("time", "stream", "log")


class ContainerLogStore:
    """Collect logs from the container into the activation record
    (ref DockerToActivationLogStore / ...FileLogStore)."""

    def __init__(self, log_file_path: Optional[str] = None):
        self.log_file_path = log_file_path

    async def collect_logs(self, transid, user, activation, container, action) -> List[str]:
        limit = action.limits.logs.size.bytes
        if limit <= 0:
            return []
        lines = await container.logs(limit_bytes=limit, wait_for_sentinel=True)
        if self.log_file_path:
            self._sink(user, activation, lines)
        return lines

    async def fetch_logs(self, user, activation) -> List[str]:
        """Logs live in the activation record itself."""
        return list(activation.logs or [])

    def _sink(self, user, activation, lines: List[str]) -> None:
        with open(self.log_file_path, "a") as f:
            for line in lines:
                f.write(json.dumps({
                    "activationId": activation.activation_id.asString,
                    "namespace": str(activation.namespace),
                    "action": str(activation.name),
                    "message": line,
                }) + "\n")


class LogDriverLogStore:
    """Out-of-band log shipping via the container platform's log driver
    (ref LogDriverLogStore.scala): the invoker collects nothing and the API
    cannot serve logs — operators read them from their logging stack."""

    async def collect_logs(self, transid, user, activation, container, action) -> List[str]:
        return []

    async def fetch_logs(self, user, activation) -> List[str]:
        return ["Logs are not available in the activation record. "
                "Please check your platform's logging service."]


class RemoteLogStore:
    """Shared fetch-side plumbing for log stores backed by an external
    search service. Collection is out-of-band (log driver), like the
    reference's ElasticSearchLogStore/SplunkLogStore."""

    def __init__(self, http_client: Callable, base_url: str,
                 headers: Optional[Dict[str, str]] = None):
        self.http = http_client
        self.base_url = base_url.rstrip("/")
        self.headers = headers or {}

    async def collect_logs(self, transid, user, activation, container, action) -> List[str]:
        return []

    async def fetch_logs(self, user, activation) -> List[str]:
        raise NotImplementedError


class ElasticSearchLogStore(RemoteLogStore):
    """Fetch activation logs from an Elasticsearch-compatible API
    (ref ElasticSearchLogStore.scala + ElasticSearchRestClient.scala):
    query the per-namespace index for docs tagged with the activation id,
    render as `time stream: log`."""

    def __init__(self, http_client: Callable, base_url: str,
                 index_pattern: str = "whisk_user_logs",
                 headers: Optional[Dict[str, str]] = None):
        super().__init__(http_client, base_url, headers)
        self.index_pattern = index_pattern

    def _index(self, user) -> str:
        # reference: path schema substitutes the user's uuid into the index
        return self.index_pattern.replace(
            "{uuid}", str(getattr(user.namespace, "uuid", "") or ""))

    async def fetch_logs(self, user, activation) -> List[str]:
        url = f"{self.base_url}/{self._index(user)}/_search"
        body = {
            "query": {"term": {
                "activation_id": activation.activation_id.asString}},
            "sort": [{"time_date": {"order": "asc"}}],
            "size": 1000,
        }
        resp = await self.http("POST", url, body, self.headers)
        hits = (resp or {}).get("hits", {}).get("hits", [])
        out = []
        for h in hits:
            src = h.get("_source", {})
            out.append(f"{src.get('time_date', '')} "
                       f"{src.get('stream', 'stdout')}: "
                       f"{src.get('message', '')}".strip())
        return out


class SplunkLogStore(RemoteLogStore):
    """Fetch activation logs from a Splunk search endpoint
    (ref SplunkLogStore.scala): one-shot search job over the configured
    index, filtered by activation id, oldest-first."""

    def __init__(self, http_client: Callable, base_url: str,
                 index: str = "whisk", log_message_field: str = "log_message",
                 activation_id_field: str = "activation_id",
                 headers: Optional[Dict[str, str]] = None):
        super().__init__(http_client, base_url, headers)
        self.index = index
        self.log_message_field = log_message_field
        self.activation_id_field = activation_id_field

    async def fetch_logs(self, user, activation) -> List[str]:
        search = (f"search index={self.index} "
                  f"{self.activation_id_field}="
                  f"{activation.activation_id.asString} "
                  f"| table {self.log_message_field}")
        body = {"exec_mode": "oneshot", "search": search,
                "output_mode": "json"}
        resp = await self.http("POST",
                               f"{self.base_url}/services/search/jobs",
                               body, self.headers)
        results = (resp or {}).get("results", [])
        return [r.get(self.log_message_field, "") for r in results]


def aiohttp_json_client(timeout: float = 10.0) -> Callable:
    """Default transport for the remote stores (deployments with network).
    One pooled session is created lazily and reused across requests; call
    `client.close()` on shutdown."""
    state: Dict[str, Any] = {}

    async def client(method: str, url: str, body: Any,
                     headers: Dict[str, str]) -> dict:
        import aiohttp
        if state.get("session") is None or state["session"].closed:
            state["session"] = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=timeout))
        async with state["session"].request(method, url, json=body,
                                            headers=headers) as r:
            return await r.json(content_type=None)

    async def close():
        if state.get("session") is not None and not state["session"].closed:
            await state["session"].close()

    client.close = close
    return client


class ContainerLogStoreProvider:
    @staticmethod
    def instance(log_file_path: Optional[str] = None) -> ContainerLogStore:
        return ContainerLogStore(log_file_path)


class LogDriverLogStoreProvider:
    @staticmethod
    def instance(**kwargs) -> LogDriverLogStore:
        return LogDriverLogStore()
