"""The Container abstraction: /init + /run HTTP contract.

Rebuild of common/scala/.../core/containerpool/Container.scala:54-239 — a
container is an opaque sandbox reachable over HTTP: POST /init loads the
code, POST /run executes one activation; suspend/resume implement the pause
grace; `logs` drains stdout/stderr up to the sentinel line the runtime
prints after each activation (Container.scala ACTIVATION_LOG_SENTINEL).
"""
from __future__ import annotations

import asyncio
import json
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import aiohttp

ACTIVATION_LOG_SENTINEL = "XXX_THE_END_OF_A_WHISK_ACTIVATION_XXX"


class ContainerError(Exception):
    pass


class InitializationError(ContainerError):
    def __init__(self, message: str, response: Optional[dict] = None):
        super().__init__(message)
        self.response = response


@dataclass
class RunResult:
    start: float
    end: float
    response: Optional[Dict[str, Any]]
    ok: bool
    timed_out: bool = False
    #: transport-level failure (socket died mid-request): the container's
    #: state is unknown, the proxy must treat it as a whisk error and
    #: destroy — NOT as the user code's own error
    connection_failed: bool = False

    @property
    def interval_ms(self) -> int:
        return int((self.end - self.start) * 1000)


class Container:
    """Abstract container; concrete drivers: process (subprocess sandbox),
    docker (CLI), stubs in tests."""

    def __init__(self, container_id: str, addr: Tuple[str, int]):
        self.container_id = container_id
        self.addr = addr
        self._session: Optional[aiohttp.ClientSession] = None
        self._http_lock = asyncio.Lock()

    # -- lifecycle (driver-specific) ---------------------------------------
    async def suspend(self) -> None:
        raise NotImplementedError

    async def resume(self) -> None:
        raise NotImplementedError

    async def destroy(self) -> None:
        if self._session:
            await self._session.close()
            self._session = None

    async def logs(self, limit_bytes: int = 10 * 1024 * 1024,
                   wait_for_sentinel: bool = True) -> List[str]:
        raise NotImplementedError

    # -- HTTP contract -----------------------------------------------------
    def _http(self) -> aiohttp.ClientSession:
        if self._session is None or self._session.closed:
            # force_close: one fresh connection per request. Keep-alive
            # reuse races the container closing idle sockets (e.g. around
            # pause/resume) and surfaces as ServerDisconnectedError on /run
            # — which must NOT be retried (at-most-once for user code), so
            # the stale-socket case is removed structurally instead
            self._session = aiohttp.ClientSession(
                connector=aiohttp.TCPConnector(force_close=True))
        return self._session

    async def _post(self, path: str, payload: dict, timeout: float,
                    retry_disconnects: bool = False) -> Tuple[int, dict]:
        """POST with connect retries: a cold container's server may not be
        listening yet (the reference's HttpUtils retries until the socket
        opens, bounded only by the caller's timeout). `retry_disconnects`
        additionally retries ServerDisconnectedError — only /init opts in
        (idempotent; ref Container.scala:123 retry=true vs :168 run
        retry=false, NoHttpResponseException handling in
        ApacheBlockingContainerClient.scala:160-163)."""
        url = f"http://{self.addr[0]}:{self.addr[1]}{path}"
        last: Optional[Exception] = None
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                async with self._http().post(
                        url, json=payload,
                        timeout=aiohttp.ClientTimeout(total=remaining)) as resp:
                    try:
                        body = await resp.json(content_type=None)
                    except (json.JSONDecodeError, aiohttp.ContentTypeError):
                        body = {"error": (await resp.text())[:1024]}
                    return resp.status, body if isinstance(body, dict) else {"value": body}
            except (aiohttp.ClientConnectorError, ConnectionRefusedError) as e:
                last = e
                await asyncio.sleep(0.05)
            except aiohttp.ServerDisconnectedError as e:
                if not retry_disconnects:
                    raise ContainerError(
                        f"connection to container {self.container_id} "
                        f"failed: {e!r}") from e
                last = e
                await asyncio.sleep(0.05)
            except asyncio.TimeoutError:
                return 408, {"error": f"request to {path} timed out"}
            except (aiohttp.ClientError, OSError) as e:
                # container died mid-request (OOM kill, crash): not retryable
                raise ContainerError(
                    f"connection to container {self.container_id} failed: {e!r}") from e
        raise ContainerError(f"cannot connect to container {self.container_id}: {last!r}")

    async def initialize(self, init_payload: dict, timeout: float = 60.0) -> int:
        """POST /init; returns init duration in ms. Raises
        InitializationError on non-OK (ref Container.initialize:113-150)."""
        t0 = time.monotonic()
        status, body = await self._post("/init", {"value": init_payload},
                                        timeout, retry_disconnects=True)
        dt = int((time.monotonic() - t0) * 1000)
        if status == 408:
            raise InitializationError(
                f"initialization exceeded its time limit of {timeout} s", body)
        if status != 200:
            raise InitializationError(
                body.get("error", f"initialization failed with status {status}"), body)
        return dt

    async def run(self, args: Dict[str, Any], environment: Dict[str, Any],
                  timeout: float = 60.0) -> RunResult:
        """POST /run (ref Container.run:153-189). Never raises on action
        errors — the response body carries them."""
        start = time.time()
        payload = {"value": args, **environment}
        try:
            status, body = await self._post("/run", payload, timeout)
        except ContainerError as e:
            return RunResult(start, time.time(), {"error": str(e)}, ok=False,
                             connection_failed=True)
        end = time.time()
        if status == 408:
            return RunResult(start, end,
                             {"error": f"action exceeded its time limit of {timeout} s"},
                             ok=False, timed_out=True)
        return RunResult(start, end, body, ok=(status == 200))

    def __repr__(self):
        return f"{type(self).__name__}({self.container_id}@{self.addr[0]}:{self.addr[1]})"
