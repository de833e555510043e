"""Warm-hit parity: the placement kernels vs the reference scheduling policy.

A copy of the repository's `tests/performance/warmhit.py` for the PyTorch
port. Its named cuts: `simulate(..., device=)` holds the books and the
request columns as torch tensors on `device` (None = the CUDA card) and
schedules each round through the balancer's own choice of kernel
(`_schedule`): the scan kernel below `REPAIR_MIN_BATCH` rows, the repair
kernel at or above it; the churn's releases fold through the release
kernel (`release_batch_cuda`). The wrappers take the plain versions only
for tensors on the CPU. The returned dict is the reference's, key for
key.

BASELINE.json's quality bar is >= 95% warm-hit parity with
ShardingContainerPoolBalancer. This tool measures it directly: a simulated
workload (zipf-ish action popularity, schedule/release churn) runs through
BOTH the device kernel (ops.placement) and the CPU oracle
(models.sharding_policy — the reference algorithm), with identical forced-
placement randomness. For each path we track which (invoker, action) pairs
are warm (a prior placement of the action on that invoker still resident)
and report the warm-hit rate plus the fraction of identical decisions.

Because the kernel reproduces the oracle's probe order bit-for-bit (the
plain versions are held to the JAX package's by the port's tests, the
kernels to the plain versions on the card), decision parity
is expected to be 1.0 — i.e. warm-hit parity is 100%, not just >= 95%.

    python -m openwhisk_tpu_torch.performance.warmhit --invokers 64 --rounds 20 --batch 128
    python -m openwhisk_tpu_torch.performance.warmhit --device cpu
"""
from __future__ import annotations

import argparse
import json
import random

import numpy as np


def _schedule(state, batch):
    """The balancer's choice of kernel for a batch of this many rows
    (`tpu_balancer._cuda_pair("auto")`): the repair kernel at or above
    REPAIR_MIN_BATCH rows, the scan kernel below. On the books' [N, A]
    view; returns (state, chosen, forced)."""
    from openwhisk_tpu_torch.controller.loadbalancer.tpu_balancer import \
        REPAIR_MIN_BATCH
    from openwhisk_tpu_torch.ops.placement_cuda import (
        schedule_batch_cuda, schedule_batch_repair_cuda, to_transposed)
    if batch.valid.shape[0] >= REPAIR_MIN_BATCH:
        ts, chosen, forced, _rounds = schedule_batch_repair_cuda(
            to_transposed(state), batch)
    else:
        ts, chosen, forced = schedule_batch_cuda(to_transposed(state), batch)
    return to_transposed(ts), chosen, forced


def simulate(n_invokers: int, rounds: int, batch: int, n_actions: int = 32,
             seed: int = 11, device=None) -> dict:
    import torch

    from openwhisk_tpu_torch.models.sharding_policy import (ShardingPolicyState,
                                                      generate_hash, release,
                                                      schedule)
    from openwhisk_tpu_torch.ops.placement import (RequestBatch, init_state,
                                             resolve_device)
    from openwhisk_tpu_torch.ops.placement_cuda import release_batch_cuda

    dev = resolve_device(device)

    rng = random.Random(seed)
    mems = [128, 256, 512]
    actions = [(f"ns{a % 4}", f"action{a}", mems[a % 3])
               for a in range(n_actions)]
    # zipf-ish popularity: low action ids dominate, like production mixes
    weights = [1.0 / (a + 1) for a in range(n_actions)]

    st = ShardingPolicyState.build([2048] * n_invokers)
    kstate = init_state(n_invokers, [st.invoker_slot_mb(2048)] * n_invokers,
                        action_slots=max(64, n_actions), device=dev)

    warm_oracle: set = set()
    warm_kernel: set = set()
    hits_o = hits_k = agree = total = 0
    in_flight: list = []  # (a, oracle_chosen, kernel_chosen)

    for rnd in range(rounds):
        picks = rng.choices(range(n_actions), weights=weights, k=batch)
        cols = {k: np.zeros((batch,), np.int32) for k in
                ("offset", "size", "home", "step_inv", "need_mb", "conc_slot",
                 "max_conc", "rand")}
        oracle_out = []
        for i, a in enumerate(picks):
            ns, act, mem = actions[a]
            offset, size = st.partition(False)
            h = generate_hash(ns, act)
            step = st.step_sizes_managed[h % len(st.step_sizes_managed)]
            frand = (h ^ ((rnd * batch + i) * 2654435761)) % max(size, 1)
            cols["offset"][i] = offset
            cols["size"][i] = size
            cols["home"][i] = h % size
            cols["step_inv"][i] = pow(step, -1, size) if size > 1 else 0
            cols["need_mb"][i] = mem
            cols["conc_slot"][i] = a
            cols["max_conc"][i] = 1
            cols["rand"][i] = frand
            oc, _ = schedule(st, ns, act, mem, forced_rand=frand)
            oracle_out.append(oc if oc is not None else -1)

        rb = RequestBatch(*(torch.from_numpy(cols[k]).to(dev) for k in
                            ("offset", "size", "home", "step_inv", "need_mb",
                             "conc_slot", "max_conc", "rand")),
                          valid=torch.ones((batch,), dtype=torch.bool,
                                           device=dev))
        kstate, chosen, _forced = _schedule(kstate, rb)
        kernel_out = [int(c) for c in chosen.cpu().numpy()]

        for a, oc, kc in zip(picks, oracle_out, kernel_out):
            total += 1
            agree += (oc == kc)
            if oc >= 0:
                hits_o += ((oc, a) in warm_oracle)
                warm_oracle.add((oc, a))
            if kc >= 0:
                hits_k += ((kc, a) in warm_kernel)
                warm_kernel.add((kc, a))
            if oc >= 0 or kc >= 0:
                in_flight.append((a, oc, kc))

        # churn: release a random half of the in-flight placements on both
        # paths (warm sets keep the affinity — the container stays warm)
        rng.shuffle(in_flight)
        n_rel = len(in_flight) // 2
        rel, in_flight = in_flight[:n_rel], in_flight[n_rel:]
        if rel:
            for a, oc, kc in rel:
                if oc is not None and oc >= 0:
                    ns, act, mem = actions[a]
                    release(st, oc, act, mem)
            inv = torch.tensor([kc for a, _, kc in rel], dtype=torch.int32,
                               device=dev)
            slot = torch.tensor([a for a, _, _ in rel], dtype=torch.int32,
                                device=dev)
            mem = torch.tensor([actions[a][2] for a, _, _ in rel],
                               dtype=torch.int32, device=dev)
            maxc = torch.ones((len(rel),), dtype=torch.int32, device=dev)
            valid = torch.tensor([kc >= 0 for _, _, kc in rel],
                                 dtype=torch.bool, device=dev)
            kstate = release_batch_cuda(kstate, inv.clamp(min=0), slot, mem,
                                        maxc, valid)

    return {
        "metric": "warm_hit_parity",
        "requests": total,
        "oracle_warm_rate": round(hits_o / max(total, 1), 4),
        "kernel_warm_rate": round(hits_k / max(total, 1), 4),
        "decision_parity": round(agree / max(total, 1), 4),
        "target_parity": 0.95,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--invokers", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--actions", type=int, default=32)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the books live: the CUDA card (default; the "
                         "kernels) or the CPU (their plain versions)")
    args = ap.parse_args()
    print(json.dumps(simulate(args.invokers, args.rounds, args.batch,
                              args.actions,
                              device=None if args.device == "cuda"
                              else args.device)))


if __name__ == "__main__":
    main()
