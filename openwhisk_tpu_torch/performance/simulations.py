"""The four headline simulations of the reference performance harness.

A copy of the repository's `tests/performance/simulations.py` for the
PyTorch port. Its named cuts: the harness is the port's
(`performance/harness.py`), and `--device cuda|cpu` (`device=` of `run`
and `run_soak`) says where the standalone's balancer places: the CUDA
card by default, which fails where there is none.

Parity with tests/performance (tests/performance/README.md):
  latency     warm end-to-end blocking-invoke latency, concurrency 1
              (wrk latency test :31-43 + Gatling LatencySimulation :88-121)
  throughput  sustained blocking throughput on one warm action, concurrency C
              (wrk throughput :45-52 + BlockingInvokeOneActionSimulation
              :124-140)
  cold        cold-start blocking throughput — every invoke hits a fresh
              action so no warm container can be reused
              (ColdBlockingInvokeSimulation)
  apiv1       CRUD/API throughput over /api/v1 — put/get/list/delete cycle
              (ApiV1Simulation :63-86)

Thresholds come from the environment exactly as in the reference
(MEAN_RESPONSE_TIME, MAX_MEAN_RESPONSE_TIME, REQUESTS_PER_SEC,
MIN_REQUESTS_PER_SEC); without them the run is report-only.

    python -m openwhisk_tpu_torch.performance.simulations latency --requests 100
    python -m openwhisk_tpu_torch.performance.simulations all --requests 50 --concurrency 4
    python -m openwhisk_tpu_torch.performance.simulations latency --device cpu
"""
from __future__ import annotations

import argparse
import os
import sys

from .harness import Client, Stats, run_with_standalone, timed_loop


async def latency_simulation(client: Client, requests: int, **_) -> Stats:
    """Warm latency at concurrency 1: one priming invoke, then the loop."""
    assert await client.put_action("perf-latency") == 200
    await client.invoke("perf-latency")

    async def one(i: int) -> bool:
        status, body = await client.invoke("perf-latency")
        return status == 200 and body["response"]["success"]

    stats = await timed_loop(requests, 1, one)
    stats.name = "latency"
    return stats


async def throughput_simulation(client: Client, requests: int,
                                concurrency: int, **_) -> Stats:
    """Sustained blocking throughput on one warm action."""
    assert await client.put_action("perf-throughput") == 200
    # prime enough warm sandboxes to cover the concurrency
    for _ in range(concurrency):
        await client.invoke("perf-throughput")

    async def one(i: int) -> bool:
        status, _ = await client.invoke("perf-throughput")
        return status == 200

    stats = await timed_loop(requests, concurrency, one)
    stats.name = "throughput"
    return stats


async def cold_simulation(client: Client, requests: int, concurrency: int,
                          **_) -> Stats:
    """Cold-start throughput: a distinct action per invoke (no warm reuse)."""
    for i in range(requests):
        assert await client.put_action(f"perf-cold-{i}") == 200

    async def one(i: int) -> bool:
        status, _ = await client.invoke(f"perf-cold-{i}")
        return status == 200

    stats = await timed_loop(requests, concurrency, one)
    stats.name = "cold"
    return stats


async def apiv1_simulation(client: Client, requests: int, concurrency: int,
                           **_) -> Stats:
    """CRUD cycle throughput: PUT + GET + list + DELETE per iteration."""

    async def one(i: int) -> bool:
        name = f"perf-crud-{i}"
        if await client.put_action(name) != 200:
            return False
        s1, _ = await client.get(f"/namespaces/_/actions/{name}")
        s2, _ = await client.get("/namespaces/_/actions?limit=10")
        s3 = await client.delete(f"/namespaces/_/actions/{name}")
        return (s1, s2, s3) == (200, 200, 200)

    stats = await timed_loop(requests, concurrency, one)
    stats.name = "apiv1"
    return stats


async def soak_simulation(client: Client, requests: int, concurrency: int,
                          duration: float = 60.0, controller=None,
                          **_) -> Stats:
    """Sustained mixed load for `duration` seconds — warm invokes, trigger
    fires and CRUD churn interleaved — then drain and assert the control
    plane leaked nothing: no live activation slots, no concurrency-slot
    refcounts, bounded RSS growth. The reference has no direct equivalent
    (its soak story is the HA/chaos CI); this guards the balancer/invoker
    bookkeeping over time rather than per-request."""
    import asyncio
    import time

    def rss_mb() -> float:
        page = os.sysconf("SC_PAGE_SIZE")
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * page / 1e6

    assert await client.put_action("soak-warm") == 200
    st, _ = await client.put("/namespaces/_/triggers/soak-t", {})
    assert st == 200
    st, _ = await client.put("/namespaces/_/rules/soak-r",
                             {"trigger": "/_/soak-t",
                              "action": "/_/soak-warm"})
    assert st == 200
    await client.invoke("soak-warm")
    rss0 = rss_mb()

    samples: list = []
    errors = 0
    stop = time.monotonic() + duration
    counter = {"i": 0}

    async def one():
        nonlocal errors
        counter["i"] += 1
        i = counter["i"]
        t0 = time.perf_counter()
        try:
            if i % 7 == 5:   # trigger fire path
                st, _ = await client.post("/namespaces/_/triggers/soak-t",
                                          {"n": i})
                ok = st in (200, 202, 204)
            elif i % 7 == 6:  # CRUD churn (unique name: two workers must
                # never race PUT/DELETE on the same entity)
                name = f"soak-crud-{i}"
                ok = await client.put_action(name) == 200
                ok = ok and (await client.delete(
                    f"/namespaces/_/actions/{name}")) == 200
            else:            # warm invoke — 202 is the reference's valid
                # slow-path outcome (ack-wait exhausted -> activation id;
                # the activation still completes and releases its slot)
                st, _ = await client.invoke("soak-warm")
                ok = st in (200, 202)
        except Exception:  # noqa: BLE001 — count, keep soaking
            ok = False
        if ok:
            # successes only, like timed_loop — error latencies must not
            # skew the reported mean/percentiles or inflate rps
            samples.append(time.perf_counter() - t0)
        else:
            errors += 1

    async def worker():
        while time.monotonic() < stop:
            await one()

    await asyncio.gather(*[worker() for _ in range(concurrency)])
    # drain: trigger fires are non-blocking, so rule activations may still
    # be RUNNING when the load stops — poll the books quiescent instead of
    # sleeping a fixed beat (a real leak still fails: nothing releases it)
    if controller is not None:
        bal = controller.load_balancer
        for _ in range(120):
            if bal.total_active_activations == 0:
                break
            await asyncio.sleep(0.25)
    await asyncio.sleep(0.5)  # let the last release fold into the books

    stats = Stats("soak", [x * 1000 for x in samples], duration, errors)
    extra = {"duration_s": round(duration, 1),
             "rss_growth_mb": round(rss_mb() - rss0, 1)}
    if controller is not None:
        bal = controller.load_balancer
        leaks = {
            "active_activations": bal.total_active_activations,
            "activation_slots": len(bal.activation_slots),
        }
        slots = getattr(bal, "_slots", None)
        if slots is not None:
            leaks["conc_refcounts"] = sum(slots.refcount.values())
            leaks["overflow_keys"] = len(slots.overflow)
        extra.update(leaks)
        import json as _json
        print(_json.dumps({"soak_books": extra}))
        assert all(v == 0 for v in leaks.values()), f"leaked: {leaks}"
        assert extra["rss_growth_mb"] < 200, extra
    return stats


SIMULATIONS = {
    "latency": latency_simulation,
    "throughput": throughput_simulation,
    "cold": cold_simulation,
    "apiv1": apiv1_simulation,
}


def run(names, requests: int, concurrency: int, port: int = 13366,
        device=None) -> bool:
    """Run the named simulations against one standalone server; True=pass.
    `device`: None = the CUDA card, "cpu" = the plain torch path."""

    async def go(client: Client):
        results = []
        for name in names:
            stats = await SIMULATIONS[name](client, requests=requests,
                                            concurrency=concurrency)
            stats.report()
            results.append(stats.check_thresholds())
        return all(results)

    return run_with_standalone(go, port=port, device=device)


def run_soak(duration: float, concurrency: int, port: int = 13366,
             balancer: str = "tpu", device=None) -> bool:
    """Soak needs the controller to inspect the balancer's books after the
    drain — run_with_standalone passes it through."""

    async def go(client: Client, controller) -> bool:
        stats = await soak_simulation(
            client, requests=0, concurrency=concurrency,
            duration=duration, controller=controller)
        stats.report()
        return stats.check_thresholds()

    return run_with_standalone(go, port=port, pass_controller=True,
                               balancer=balancer, device=device)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("simulation", choices=[*SIMULATIONS, "soak", "all"])
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--concurrency", type=int, default=4)
    ap.add_argument("--port", type=int, default=13366)
    ap.add_argument("--duration", type=float, default=60.0,
                    help="soak: seconds of sustained load")
    ap.add_argument("--balancer", default="tpu",
                    help="soak: lean|tpu (device placement path)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the standalone's balancer places: the CUDA "
                         "card (default) or the plain torch path on the CPU")
    args = ap.parse_args()
    # "cuda" is the default: None, which raises without a card
    device = None if args.device == "cuda" else args.device
    if args.simulation == "soak":
        sys.exit(0 if run_soak(args.duration, args.concurrency, args.port,
                               args.balancer, device=device) else 1)
    names = list(SIMULATIONS) if args.simulation == "all" else [args.simulation]
    sys.exit(0 if run(names, args.requests, args.concurrency, args.port,
                      device=device) else 1)


if __name__ == "__main__":
    main()
