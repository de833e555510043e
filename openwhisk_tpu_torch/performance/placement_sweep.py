"""Placement-kernel scale sweep: 16 -> 64k invokers, single-device + sharded.

A copy of the repository's `tests/performance/placement_sweep.py` for the
PyTorch port. Its named cuts: `_example_batch` is the copy of
`__graft_entry__._example_batch` (numpy columns, then torch tensors on the
device); `_measure` waits with `torch.cuda.synchronize()` where the
reference blocks on the arrays; the single-device step is the port's
balancer's on the card (`device_pair`: the scan kernel below 32 rows, the
repair kernel from there, plus the release fold); the sharded step is the
port's single-controller mesh (`parallel/sharded_state.py`), whose shards
share the card when there are fewer cards than shards; the reference's
`--pallas` row (the Pallas scan against XLA's) is `--kernel`: the CUDA
scan kernel's schedule against its plain version's on the same books. `--device cpu`
runs it all on the CPU's plain torch path.

The BASELINE.json build-target matrix: placement decisions/sec and p50
schedule() step latency across fleet sizes from 16 simulated invokers up to
64k invokers sharded 8 ways (the north-star configuration; SURVEY §6). The
device step measured is the full per-batch work the balancer does:
schedule_batch + the matching release fold, books held constant.

    python -m openwhisk_tpu_torch.performance.placement_sweep          # the card
    python -m openwhisk_tpu_torch.performance.placement_sweep --sharded --kernel
    python -m openwhisk_tpu_torch.performance.placement_sweep --device cpu --sizes 16 64

Prints one JSON line per configuration.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _example_batch(n_invokers: int, batch: int, seed: int = 0, device=None):
    """Host-side request construction exactly as TpuBalancer.publish does."""
    import torch

    from openwhisk_tpu_torch.models.sharding_policy import (generate_hash,
                                                      pairwise_coprimes)
    from openwhisk_tpu_torch.ops.placement import RequestBatch, resolve_device

    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    managed = max(int(0.9 * n_invokers), 1)
    steps = pairwise_coprimes(managed)
    cols = {k: np.zeros((batch,), np.int32) for k in
            ("offset", "size", "home", "step_inv", "need_mb", "conc_slot",
             "max_conc", "rand")}
    for i in range(batch):
        a = rng.randint(0, 64)
        h = generate_hash(f"ns{a % 8}", f"action{a}")
        step = steps[h % len(steps)]
        cols["offset"][i] = 0
        cols["size"][i] = managed
        cols["home"][i] = h % managed
        cols["step_inv"][i] = pow(step, -1, managed) if managed > 1 else 0
        cols["need_mb"][i] = [128, 256, 512][a % 3]
        cols["conc_slot"][i] = a
        cols["max_conc"][i] = 1
        cols["rand"][i] = rng.randint(0, managed)
    return RequestBatch(*(torch.from_numpy(cols[k]).to(dev) for k in
                          ("offset", "size", "home", "step_inv", "need_mb",
                           "conc_slot", "max_conc", "rand")),
                        valid=torch.ones((batch,), dtype=torch.bool,
                                         device=dev))


def _block() -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    import torch

    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _measure(config: str, n_invokers: int, batch: int, iters: int,
             state, step) -> dict:
    """Shared warmup + timing loop: full device step, books held constant."""
    for _ in range(3):
        state, chosen = step(state)
    _block()

    lat = []
    t0 = time.perf_counter()
    for _ in range(iters):
        t1 = time.perf_counter()
        state, chosen = step(state)
        _block()
        lat.append(time.perf_counter() - t1)
    dt = time.perf_counter() - t0
    return {"config": config, "n_invokers": n_invokers, "batch": batch,
            "placements_per_sec": round(batch * iters / dt, 1),
            "p50_step_ms": round(sorted(lat)[len(lat) // 2] * 1e3, 3)}


def bench_single(n_invokers: int, batch: int, iters: int, slot_mb: int = 2048,
                 seed: int = 7, device=None) -> dict:
    from openwhisk_tpu_torch.controller.loadbalancer.tpu_balancer import \
        device_pair
    from openwhisk_tpu_torch.ops.placement import init_state, resolve_device

    dev = resolve_device(device)
    state = init_state(n_invokers, [slot_mb] * n_invokers, action_slots=256,
                       device=dev)
    req = _example_batch(n_invokers, batch, seed=seed, device=dev)
    schedule, release, _ = device_pair(dev, "auto")

    def step(state):
        state, chosen, forced, *_rounds = schedule(state, req)
        ok = chosen >= 0
        return release(state, chosen.clamp(min=0), req.conc_slot,
                       req.need_mb, req.max_conc, ok), chosen

    return _measure("single-device", n_invokers, batch, iters, state, step)


def bench_sharded(n_invokers: int, batch: int, iters: int, n_shards: int = 8,
                  slot_mb: int = 2048, seed: int = 7, device=None) -> dict:
    from openwhisk_tpu_torch.ops.placement import init_state
    from openwhisk_tpu_torch.parallel.sharded_state import (make_mesh,
                                                      make_sharded_release,
                                                      make_sharded_schedule,
                                                      shard_state)

    mesh = make_mesh(n_shards, device=device)
    state = shard_state(
        init_state(n_invokers, [slot_mb] * n_invokers, action_slots=256,
                   device=mesh.lead), mesh)
    req = _example_batch(n_invokers, batch, seed=seed, device=mesh.lead)
    schedule = make_sharded_schedule(mesh)
    release = make_sharded_release(mesh)

    def step(state):
        state, chosen, forced = schedule(state, req)
        ok = chosen >= 0
        return release(state, chosen.clamp(min=0), req.conc_slot,
                       req.need_mb, req.max_conc, ok), chosen

    return _measure(f"{n_shards}-shard", n_invokers, batch, iters, state, step)


def bench_kernel(n_invokers: int, batch: int, iters: int, slot_mb: int = 2048,
                 action_slots: int = 256, seed: int = 7, device=None) -> dict:
    """schedule-only comparison of the CUDA scan kernel vs its plain
    version, each on books of its own (the port's steps write the books
    in place)."""
    from openwhisk_tpu_torch.ops.placement import (init_state, resolve_device,
                                             schedule_batch)
    from openwhisk_tpu_torch.ops.placement_cuda import (schedule_batch_cuda,
                                                  to_transposed)

    dev = resolve_device(device)

    def books():
        return init_state(n_invokers, [slot_mb] * n_invokers,
                          action_slots=action_slots, device=dev)

    req = _example_batch(n_invokers, batch, seed=seed, device=dev)
    row = _measure("plain-schedule", n_invokers, batch, iters, books(),
                   lambda s: schedule_batch(s, req)[:2])
    krow = _measure("cuda-schedule", n_invokers, batch, iters,
                    to_transposed(books()),
                    lambda s: schedule_batch_cuda(s, req)[:2])
    row["cuda_placements_per_sec"] = krow["placements_per_sec"]
    row["cuda_p50_step_ms"] = krow["p50_step_ms"]
    row["config"] = "cuda-vs-plain"
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sharded", action="store_true",
                    help="also run the 8-shard configurations (needs >=8 "
                         "devices, e.g. the virtual CPU mesh)")
    ap.add_argument("--kernel", action="store_true",
                    help="also compare the CUDA scan kernel vs its plain "
                         "version")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the books live: the CUDA card (default) or "
                         "the CPU")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--sizes", type=int, nargs="*",
                    default=[16, 256, 4096, 65536])
    args = ap.parse_args()
    # "cuda" is the default: None, which raises without a card
    device = None if args.device == "cuda" else args.device

    for n in args.sizes:
        print(json.dumps(bench_single(n, args.batch, args.iters,
                                      device=device)), flush=True)
    if args.sharded:
        for n in args.sizes:
            if n % 8:
                continue
            print(json.dumps(bench_sharded(n, args.batch, args.iters,
                                           device=device)),
                  flush=True)
    if args.kernel:
        from openwhisk_tpu_torch.ops.placement_cuda import fits_scan
        for n in args.sizes:
            if fits_scan(n):
                print(json.dumps(bench_kernel(n, args.batch, args.iters,
                                              device=device)),
                      flush=True)


if __name__ == "__main__":
    main()
