"""owperf equivalent: rule (trigger->action) vs direct-action performance.

A copy of the repository's `tests/performance/owperf.py` for the PyTorch
port. Its named cuts: the harness is the port's, and `--device cuda|cpu`
says where the standalone's balancer places (the CUDA card by default).

Parity with the reference's tools/owperf (tools/owperf/README.md:19-46): for
each sample, fire a trigger bound to a rule (or invoke the action directly),
then mine the resulting activation records for the client-observed latency
plus the system's own timing breakdown — the `waitTime` annotation (queueing:
balancer + bus + pool), `initTime` (cold-start init) and `duration` (user
code) — and emit per-phase statistics as CSV, one row per measurement, like
owperf's CSV output mode.

    python -m openwhisk_tpu_torch.performance.owperf --samples 50 --ratio 2
    python -m openwhisk_tpu_torch.performance.owperf --samples 5 --device cpu
"""
from __future__ import annotations

import argparse
import asyncio
import statistics
import sys
import time

from .harness import NOOP_CODE, Client, open_loop, run_with_standalone


def _summary(name: str, xs) -> str:
    if not xs:
        return f"{name},0,,,,"
    xs = sorted(xs)
    return (f"{name},{len(xs)},{statistics.mean(xs):.2f},"
            f"{xs[int(0.5 * (len(xs) - 1))]:.2f},"
            f"{xs[int(0.9 * (len(xs) - 1))]:.2f},{xs[-1]:.2f}")


async def _activation_timings(client: Client, activation_id: str,
                              tries: int = 80) -> dict:
    """Poll the activation record; return its timing annotations."""
    for _ in range(tries):
        status, act = await client.get(f"/namespaces/_/activations/{activation_id}")
        if status == 200:
            ann = {a["key"]: a["value"] for a in act.get("annotations", [])}
            return {"waitTime": ann.get("waitTime", 0),
                    "initTime": ann.get("initTime", 0),
                    "duration": act.get("duration", 0)}
        await asyncio.sleep(0.05)
    return {}


async def _main(client: Client, samples: int, ratio: int,
                rate: float = 0.0) -> None:
    # setup: one action, one trigger, `ratio` rules binding them
    assert await client.put_action("owperf-act") == 200
    async with client.session.put(
            f"{client.base}/namespaces/_/triggers/owperf-t?overwrite=true",
            headers=client.headers, json={}) as r:
        assert r.status == 200, r.status
    for i in range(ratio):
        async with client.session.put(
                f"{client.base}/namespaces/_/rules/owperf-r{i}?overwrite=true",
                headers=client.headers,
                json={"trigger": "_/owperf-t", "action": "_/owperf-act"}) as r:
            assert r.status == 200, await r.text()
    await client.invoke("owperf-act")  # warm the sandbox

    e2e_action, e2e_rule = [], []
    waits, inits, durs = [], [], []

    # direct action samples (owperf "action" test). With --rate the phase
    # runs OPEN-loop through the shared arrival schedule (the port's
    # tools/loadgen via harness.open_loop): invokes fire at scheduled times, latency is
    # measured from the schedule, and the record mining happens after the
    # drive so polling never perturbs the arrival process.
    if rate > 0:
        aids = []

        async def one(i: int) -> bool:
            status, body = await client.invoke("owperf-act")
            if status != 200:
                return False
            aids.append(body["activationId"])
            return True

        stats = await open_loop(samples, rate, one)
        e2e_action = stats.samples_ms
        if stats.errors:
            print(f"{stats.errors} open-loop action samples failed",
                  file=sys.stderr)
        for aid in aids:
            t = await _activation_timings(client, aid)
            if not t:
                print(f"activation {aid} record missing", file=sys.stderr)
                continue
            waits.append(t["waitTime"])
            inits.append(t["initTime"])
            durs.append(t["duration"])
    else:
        for _ in range(samples):
            t0 = time.perf_counter()
            status, body = await client.invoke("owperf-act")
            e2e_action.append((time.perf_counter() - t0) * 1e3)
            assert status == 200
            t = await _activation_timings(client, body["activationId"])
            if not t:  # record never surfaced: drop, don't zero-fill
                print(f"activation {body['activationId']} record missing",
                      file=sys.stderr)
                continue
            waits.append(t["waitTime"])
            inits.append(t["initTime"])
            durs.append(t["duration"])

    # rule samples (owperf "rule" test): fire -> poll for the rule-driven
    # activation recorded in the trigger activation's log entries
    for _ in range(samples):
        t0 = time.perf_counter()
        status, body = await client.post("/namespaces/_/triggers/owperf-t")
        assert status == 202, status
        trig_id = body["activationId"]
        # the trigger activation logs carry per-rule action activation ids
        action_ids = []
        for _ in range(80):
            s, act = await client.get(f"/namespaces/_/activations/{trig_id}")
            if s == 200 and act.get("logs"):
                import json as _json
                action_ids = [aid for aid in
                              (_json.loads(l).get("activationId")
                               for l in act["logs"]) if aid]
                break
            await asyncio.sleep(0.05)
        deadline = time.perf_counter() + 30.0
        done = 0
        while done < len(action_ids) and time.perf_counter() < deadline:
            done = 0
            for aid in action_ids:
                s, _ = await client.get(f"/namespaces/_/activations/{aid}")
                done += (s == 200)
            if done < len(action_ids):
                await asyncio.sleep(0.05)
        if not action_ids or done < len(action_ids):
            print(f"rule sample dropped: {done}/{len(action_ids)} "
                  "activations surfaced within 30s", file=sys.stderr)
            continue
        e2e_rule.append((time.perf_counter() - t0) * 1e3)

    print("phase,samples,mean_ms,p50_ms,p90_ms,max_ms")
    print(_summary("action_e2e" + (f"_open@{rate:g}" if rate > 0 else ""),
                   e2e_action))
    print(_summary(f"rule_e2e_x{ratio}", e2e_rule))
    print(_summary("waitTime", waits))
    print(_summary("initTime", inits))
    print(_summary("duration", durs))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--samples", type=int, default=50)
    ap.add_argument("--ratio", type=int, default=1,
                    help="rules per trigger (owperf -ratio)")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="open-loop offered rate for the action phase "
                         "(requests/s, 0 = legacy closed-loop sampling)")
    ap.add_argument("--port", type=int, default=13377)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the standalone's balancer places: the CUDA "
                         "card (default) or the plain torch path on the CPU")
    args = ap.parse_args()

    async def go(client: Client):
        await _main(client, args.samples, args.ratio, rate=args.rate)

    run_with_standalone(go, port=args.port,
                        device=None if args.device == "cuda" else args.device)


if __name__ == "__main__":
    main()
