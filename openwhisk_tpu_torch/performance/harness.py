"""Shared scaffolding for the performance harness.

A copy of the repository's `tests/performance/harness.py` for the PyTorch
port (`python -m openwhisk_tpu_torch.performance.<tool>`). Its named cuts:
no `sys.path` preamble, and the open-loop schedule from the port's
`tools/loadgen.py`. `run_with_standalone` boots the port's standalone,
whose default balancer places on the CUDA card; `device="cpu"` asks for
the plain torch path.

Rebuild of the reference's tests/performance harness conventions
(tests/performance/README.md:31-140): each simulation runs against a live
system, reports latency/throughput statistics, and — exactly like the
reference's Gatling assertions — fails the run only when an operator-supplied
environment threshold is present and violated:

  MEAN_RESPONSE_TIME / MAX_MEAN_RESPONSE_TIME   upper bounds, milliseconds
  REQUESTS_PER_SEC   / MIN_REQUESTS_PER_SEC     lower bounds, requests/second

Simulations here drive the in-process standalone server (the framework's
single-host deployment) over real HTTP, so they measure the full stack:
edge-less REST -> entitlement -> balancer -> bus -> invoker -> sandbox.
"""
from __future__ import annotations

import asyncio
import base64
import json
import os
import sys
import time
from dataclasses import dataclass
from typing import Awaitable, Callable, List, Optional

import aiohttp  # noqa: E402

NOOP_CODE = "def main(args):\n    return {'ok': True}\n"


@dataclass
class Stats:
    """Latency/throughput summary over one simulation run."""
    name: str
    samples_ms: List[float]
    wall_s: float
    errors: int = 0

    def _pct(self, p: float) -> float:
        xs = sorted(self.samples_ms)
        if not xs:
            return float("nan")
        return xs[min(len(xs) - 1, int(p * len(xs)))]

    @property
    def mean_ms(self) -> float:
        return sum(self.samples_ms) / max(len(self.samples_ms), 1)

    @property
    def rps(self) -> float:
        return len(self.samples_ms) / self.wall_s if self.wall_s else 0.0

    def row(self) -> dict:
        return {
            "simulation": self.name,
            "requests": len(self.samples_ms),
            "errors": self.errors,
            "mean_ms": round(self.mean_ms, 2),
            "p50_ms": round(self._pct(0.50), 2),
            "p90_ms": round(self._pct(0.90), 2),
            "p99_ms": round(self._pct(0.99), 2),
            "rps": round(self.rps, 1),
        }

    def report(self) -> None:
        print(json.dumps(self.row()))

    def check_thresholds(self) -> bool:
        """Apply the reference's env-var assertions; True = pass."""
        ok = True
        gated = any(os.environ.get(v) for v in
                    ("MEAN_RESPONSE_TIME", "MAX_MEAN_RESPONSE_TIME",
                     "REQUESTS_PER_SEC", "MIN_REQUESTS_PER_SEC"))
        if gated and (self.errors or not self.samples_ms):
            print(f"FAIL {self.name}: {self.errors} errors, "
                  f"{len(self.samples_ms)} successful samples",
                  file=sys.stderr)
            return False
        for var in ("MEAN_RESPONSE_TIME", "MAX_MEAN_RESPONSE_TIME"):
            v = os.environ.get(var)
            if v and self.mean_ms > float(v):
                print(f"FAIL {self.name}: mean {self.mean_ms:.1f}ms > {var}={v}",
                      file=sys.stderr)
                ok = False
        for var in ("REQUESTS_PER_SEC", "MIN_REQUESTS_PER_SEC"):
            v = os.environ.get(var)
            if v and self.rps < float(v):
                print(f"FAIL {self.name}: {self.rps:.1f} rps < {var}={v}",
                      file=sys.stderr)
                ok = False
        return ok


class Client:
    """Minimal authenticated REST client for the simulations."""

    def __init__(self, session: aiohttp.ClientSession, base: str, uuid: str,
                 key: str):
        self.session = session
        self.base = base
        auth = base64.b64encode(f"{uuid}:{key}".encode()).decode()
        self.headers = {"Authorization": f"Basic {auth}",
                        "Content-Type": "application/json"}

    async def put_action(self, name: str, code: str = NOOP_CODE,
                         kind: str = "python:3", **fields) -> int:
        async with self.session.put(
                f"{self.base}/namespaces/_/actions/{name}?overwrite=true",
                headers=self.headers,
                json={"exec": {"kind": kind, "code": code}, **fields}) as r:
            return r.status

    async def invoke(self, name: str, payload: Optional[dict] = None,
                     blocking: bool = True) -> tuple:
        qs = "?blocking=true" if blocking else ""
        async with self.session.post(
                f"{self.base}/namespaces/_/actions/{name}{qs}",
                headers=self.headers, json=payload or {}) as r:
            return r.status, await r.json()

    async def get(self, path: str) -> tuple:
        async with self.session.get(f"{self.base}{path}",
                                    headers=self.headers) as r:
            return r.status, await r.json()

    async def post(self, path: str, payload: Optional[dict] = None) -> tuple:
        async with self.session.post(f"{self.base}{path}",
                                     headers=self.headers,
                                     json=payload or {}) as r:
            body = await r.json() if r.content_type == "application/json" else {}
            return r.status, body

    async def put(self, path: str, payload: Optional[dict] = None) -> tuple:
        async with self.session.put(f"{self.base}{path}",
                                    headers=self.headers,
                                    json=payload or {}) as r:
            body = await r.json() if r.content_type == "application/json" else {}
            return r.status, body

    async def delete(self, path: str) -> int:
        async with self.session.delete(f"{self.base}{path}",
                                       headers=self.headers) as r:
            return r.status


async def open_loop(n_requests: int, rate: float,
                    one: Callable[[int], Awaitable[bool]],
                    dist: str = "poisson", seed: int = 1) -> Stats:
    """Open-loop counterpart of `timed_loop`: arrivals follow a fixed
    schedule (tools/loadgen.make_schedule, the shared arrival-schedule
    helper) independent of completions, and each latency is measured from
    the SCHEDULED arrival time, so queueing behind a stalled system is
    charged to the system (coordinated-omission-correct; `timed_loop`'s
    semaphore workers self-throttle and under-report exactly that).
    Unfinished requests after the drain window count as errors."""
    from openwhisk_tpu_torch.tools.loadgen import make_schedule
    from openwhisk_tpu_torch.tools.loadgen import open_loop as _drive

    async def wrapped(i: int, sched_ns: int) -> bool:
        return await one(i)

    row = await _drive(wrapped, make_schedule(rate, n_requests, dist=dist,
                                              seed=seed))
    return Stats("", row["samples_ms"], row["wall_s"],
                 row["errors"] + row["unfinished"])


async def timed_loop(n_requests: int, concurrency: int,
                     one: Callable[[int], Awaitable[bool]]) -> Stats:
    """Run `one(i)` n_requests times at the given concurrency; time each.
    CLOSED loop: arrivals gate on completions — fine for smoke coverage,
    use `open_loop` when the percentiles are the point."""
    samples: List[float] = []
    errors = 0
    sem = asyncio.Semaphore(concurrency)

    async def worker(i: int):
        nonlocal errors
        async with sem:
            t0 = time.perf_counter()
            try:
                ok = await one(i)
            except Exception as e:  # transport/parse errors count, not abort
                print(f"request {i} failed: {e!r}", file=sys.stderr)
                ok = False
            dt = (time.perf_counter() - t0) * 1e3
            if ok:
                samples.append(dt)
            else:
                errors += 1

    t0 = time.perf_counter()
    await asyncio.gather(*(worker(i) for i in range(n_requests)))
    wall = time.perf_counter() - t0
    return Stats("", samples, wall, errors)


def run_with_standalone(coro_fn, port: int = 13366, pass_controller: bool = False,
                        **standalone_kw):
    """Boot the standalone server, run coro_fn(client), tear down.

    Throttles are raised far past what any simulation drives (the reference
    perf setups do the same in their deployment config,
    tests/performance/README.md) — the harness measures the data plane, not
    the 60/min namespace rate limit; ThrottleTests cover enforcement.
    `pass_controller=True` calls coro_fn(client, controller) for simulations
    that inspect the balancer's books (soak). `standalone_kw` passes on
    to the port's `make_standalone`: `device="cpu"` for the plain torch
    path, `balancer="lean"` for in-process dispatch."""
    from openwhisk_tpu_torch.standalone import (GUEST_KEY, GUEST_UUID,
                                          make_standalone)

    standalone_kw.setdefault("invocations_per_minute", 1_000_000)
    standalone_kw.setdefault("concurrent_invocations", 10_000)
    standalone_kw.setdefault("fires_per_minute", 1_000_000)

    async def go():
        controller = await make_standalone(port=port, **standalone_kw)
        try:
            async with aiohttp.ClientSession() as session:
                client = Client(session, f"http://127.0.0.1:{port}/api/v1",
                                GUEST_UUID, GUEST_KEY)
                if pass_controller:
                    return await coro_fn(client, controller)
                return await coro_fn(client)
        finally:
            await controller.stop()

    return asyncio.run(go())
