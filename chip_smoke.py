#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`openwhisk_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each reported on its own line:
  1. card     the card's name and power limit (nvidia-smi)
  2. build    the placement kernels (and the grid- and cluster-barrier
              probes) built with nvcc for sm_90a from
              openwhisk_tpu_torch/csrc, one nvcc per source, in parallel
  3. kernels  each kernel against its plain PyTorch version on the card at
              the full geometry (10,000 invokers padded to N = 16,384,
              A = 4,096 concurrency slots): the scan at B in {8, 16, 256},
              the repair at B in {32, 256, 1024}, with and without a
              penalty, over six traffic families. Bit-exact: chosen,
              forced, rounds, free and conc. Times from CUDA events at
              B = 16 / 256 on memory-dominant traffic, with and without the
              penalty.
  4. main     `BalancerCore(device="cuda")` over 10,000 invokers of
              8,192 MB (managed 0.9 / blackbox 0.1, max_batch 256,
              action_slots 4096): warm-up, full 256-row batches of a
              Zipf(1.1) mix over 2,000 actions with completions 1-8 steps
              later and 1% of the invokers flapping every 20 steps, a
              trickle of 1-16-row steps (the scan kernel) and an overload
              burst under a blackbox outage (forced placements). Steps
              150-179 run under `torch.profiler` (the "profile" line:
              device time by kernel kind, the device's idle share and
              longest idle gaps, host time and device span of each phase of
              the fused step, the repair kernel's ms per launch and per
              round); the inputs of step 200's repair launch and of the
              first scan launch from step 360 on (a trickle step) are
              kept, and every scan launch of the run is timed with CUDA
              events. The first 110
              steps are replayed through `BalancerCore(device="cpu")` and
              must agree in decisions, rounds and books.
  5. each kernel on its kept main-path batch: held against the plain
     version, timed with and without a penalty, with its bound from the
     same inputs; its cost per round (repair) or per request (scan) on
     serial batches (one commit a round, every request on one invoker);
     one grid barrier at the repair's launch shape, and at the scan's one
     cluster barrier and one exchange of its minima (the kernel's and its
     first design's).
  6. scan-pinned main path: `BalancerCore(placement_kernel="scan")`, 40 full
     256-row steps of the same traffic (step p50, scan launches, each
     launch timed with CUDA events); its first 10 steps are replayed on
     the CPU and must agree in decisions and books.
  7. front    the load balancer front, `TpuBalancer()` on the card, over
              the in-memory bus: 10,000 simulated invokers register by
              pings through its supervision pool (the books grow from
              initial_pad 64 to 16,384 rows on the card), then
              `publish_many` waves of 256 rows of phase 4's action mix,
              acked by the fleet 1-8 waves later (one fleet task drains
              every invoker topic), 1% of the invokers turned unhealthy
              through the supervision FSM and back by a ping, waves 40-69
              under `torch.profiler` (the device's idle share), and a
              1-16-row trickle once the releases have drained (the scan);
              then a second balancer with `rate_limit_per_minute` over 16
              waves (throttled rows). Every dispatched packed buffer, idle
              release fold and health set is recorded by wrapping the
              balancer's functions here, and replayed on the CPU through
              the plain fused steps from the same initial books: decisions,
              throttled bits, rounds and the final books must agree. Every
              activation must resolve, none stay active, and the books
              come back to full capacity. One "front" line of numbers.
  8. a `{"kernels": [...]}` JSON line, then the card line, then the last
     line `{"ok": true, "device": {...}}`.

Any failure raises, so the script exits non-zero and prints no last line;
without a CUDA card, or outside the repository, it fails at once.

bound_ms is the least time the card could take for the kernel's work: the
larger of (bytes it must move) / 3.35 TB/s and (key evaluations) /
33.5 T int32 ops/s (half the 67 TFLOP/s float32 rate: Hopper issues 64
int32 against 128 float32 operations per SM and clock), counting one
operation a key. The key evaluations are what the exact algorithm needs on
these inputs: one forced-rotation key per valid row and column of its
partition window, plus one probe key per column of the window for every
probe (the scan probes each row once, the repair each pending row in
every round). The bytes are the request matrix, free and health over the
windows' union, each distinct conc row over the union of its rows'
windows, read once, and the outputs: chosen, forced, rounds and the book
cells that changed.
"""
import asyncio
import ctypes
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

N_INV, N_PAD, A = 10_000, 16_384, 4_096
MANAGED, BLACKBOX = int(0.9 * N_INV), int(0.1 * N_INV)
MEM_MB = 8_192
MAX_BATCH = 256
HBM_BYTES_S = 3.35e12
INT32_OPS_S = 33.5e12
FAMILIES = ("memory", "burst", "container", "overload", "unhealthy", "oob")
CPU_STEPS = 110
DEVICE = "cuda"


def say(tag, **kw):
    print(json.dumps({"phase": tag, **kw}), flush=True)


def require(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


# ---------------------------------------------------------------- phase 3
def _inv(rng, size):
    st = rng.randint(1, size + 1)
    while math.gcd(int(st), int(size)) != 1:
        st = rng.randint(1, size + 1)
    return pow(int(st), -1, int(size)) if size > 1 else 0


def make_case(family, b, seed, torch, P):
    """Books and a request batch on the card for one traffic family."""
    rng = np.random.RandomState(seed)
    bb = rng.rand(b) < 0.1
    off = np.where(bb, MANAGED, 0)
    size = np.where(bb, BLACKBOX, MANAGED)
    home = rng.randint(0, 1 << 30, b) % size
    step_inv = np.array([_inv(rng, s) for s in size])
    need = rng.choice([128, 256, 512, 1024, 2048], b)
    slot = rng.randint(0, A, b)
    maxc = np.ones(b, int)
    rand = rng.randint(0, 1 << 30, b) % size
    valid = rng.rand(b) < 0.95
    free = np.zeros(N_PAD, np.int32)
    free[:N_INV] = MEM_MB
    health = np.zeros(N_PAD, bool)
    health[:N_INV] = True
    conc_p = 0.02
    if family == "burst":  # same-action runs onto nearly full invokers
        act = rng.randint(0, 4, b)
        off, size = np.zeros(b, int), np.full(b, MANAGED)
        home = rng.randint(0, MANAGED, 4)[act]
        step_inv = np.array([_inv(rng, MANAGED) for _ in range(4)])[act]
        slot, need = rng.randint(0, A, 4)[act], np.full(b, 256)
        free[:N_INV] = rng.randint(0, 1024, N_INV)
    elif family == "container":  # container-open rows on shared slots
        maxc = np.where(rng.rand(b) < 0.7, rng.randint(2, 17, b), 1)
        slot = rng.randint(0, 8, b)
        conc_p = 0.3
    elif family == "overload":  # demand far above capacity
        free[:N_INV] = np.where(rng.rand(N_INV) < 0.01, 2048, 0)
        need = rng.choice([1024, 2048], b)
    elif family == "unhealthy":  # half the fleet down, random windows
        health[:N_INV] = rng.rand(N_INV) < 0.5
        off = rng.randint(0, N_INV // 2, b)
        size = rng.randint(1, N_INV + 1, b) % (N_INV - off) + 1
        home = rng.randint(0, 1 << 30, b) % size
        step_inv = np.array([_inv(rng, s) for s in size])
        rand = rng.randint(0, 1 << 30, b) % size
    elif family == "oob":  # slots past the slot axis: read clamped, write dropped
        slot = np.where(rng.rand(b) < 0.25, A + rng.randint(0, 64, b), slot)
        maxc = np.where(rng.rand(b) < 0.4, rng.randint(2, 9, b), 1)
        conc_p = 0.2
    conc = torch.zeros((A, N_PAD), dtype=torch.int32, device=DEVICE)
    rows = np.unique(np.clip(slot, 0, A - 1))
    vals = np.where(rng.rand(len(rows), N_PAD) < conc_p,
                    rng.randint(1, 4, (len(rows), N_PAD)), 0)
    vals[:, N_INV:] = 0
    conc[torch.from_numpy(rows).to(DEVICE)] = torch.from_numpy(
        vals.astype(np.int32)).to(DEVICE)
    state = P.PlacementState(torch.from_numpy(free).to(DEVICE), conc.T,
                             torch.from_numpy(health).to(DEVICE))
    batch = P.request_batch_from_numpy(off, size, home, step_inv, need, slot,
                                       maxc, rand, valid, device=DEVICE)
    pen = torch.from_numpy(rng.randint(0, 4, N_PAD).astype(np.int32)).to(
        DEVICE)
    return state, batch, pen


def clone_state(P, s):
    return P.PlacementState(s.free_mb.clone(), s.conc_free.T.clone().T,
                            s.health.clone())


def run_pair(kind, state, batch, pen, P, K):
    """(kernel outputs, plain outputs), each on its own copy of the books."""
    ks, ps = clone_state(P, state), clone_state(P, state)
    if kind == "scan":
        kout = K.schedule_batch_cuda(K.to_transposed(ks), batch, pen)
        pout = P.schedule_batch(ps, batch, pen)
    else:
        kout = K.schedule_batch_repair_cuda(K.to_transposed(ks), batch, pen)
        pout = P.schedule_batch_repair(ps, batch, pen)
    return (ks, kout), (ps, pout)


def compare(kind, state, batch, pen, P, K, torch):
    (ks, kout), (ps, pout) = run_pair(kind, state, batch, pen, P, K)
    torch.cuda.synchronize()
    err = 0
    pairs = [(kout[1], pout[1]), (kout[2].int(), pout[2].int()),
             (ks.free_mb, ps.free_mb), (ks.conc_free, ps.conc_free)]
    if kind == "repair":
        pairs.append((kout[3].reshape(1), pout[3].reshape(1)))
    for x, y in pairs:
        err = max(err, int((x.long() - y.long()).abs().max()))
    rounds = int(kout[3]) if kind == "repair" else 0
    return err, rounds, int(kout[2].sum())


def work_bytes_ops(kind, state, batch, pen, P):
    """Bytes the call must move and key evaluations the exact algorithm
    needs (see the module docstring), from this run's inputs: the plain
    version runs once on a copy of the books and reports the pending rows
    of every repair round."""
    ps = clone_state(P, state)
    pending = []
    if kind == "scan":
        P.schedule_batch(ps, batch, pen)
    else:
        P.schedule_batch_repair(ps, batch, pen,
                                on_round=lambda p: pending.append(
                                    p.cpu().numpy()))
    n = state.free_mb.shape[0]
    a = state.conc_free.shape[1]
    b = batch.valid.shape[0]
    off = batch.offset.cpu().numpy().astype(np.int64)
    lo = np.clip(off, 0, n)
    hi = np.clip(off + batch.size.cpu().numpy(), lo, n)
    valid = batch.valid.cpu().numpy()
    width = np.where(valid, hi - lo, 0)
    # one forced-rotation key per valid row and window column, plus one
    # probe key per window column for every probe (the scan probes each
    # row once, the repair each pending row in every round)
    keys = int(width.sum()) + (int(width.sum()) if kind == "scan" else
                               sum(int(width[p].sum()) for p in pending))
    cols = np.zeros(n, bool)
    slot = np.clip(batch.conc_slot.cpu().numpy(), 0, a - 1)
    slot_cols = {}
    for i in np.nonzero(valid)[0]:
        cols[lo[i]:hi[i]] = True
        slot_cols.setdefault(slot[i], np.zeros(n, bool))[lo[i]:hi[i]] = True
    conc_cells = sum(int(m.sum()) for m in slot_cols.values())
    changed = (int((ps.free_mb != state.free_mb).sum())
               + int((ps.conc_free != state.conc_free).sum()))
    nbytes = (9 * 4 * b + 5 * int(cols.sum()) + 4 * conc_cells + 8 * b
              + (4 if kind == "repair" else 0) + 4 * changed)
    return nbytes, keys, len(pending)


def bound(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / INT32_OPS_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def time_ms(fn, restore, torch, reps=15):
    """Median CUDA-event time of fn(), the books restored before each
    call (outside the timed window)."""
    evs = []
    fn()  # warm
    for _ in range(reps):
        restore()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in evs]))


def kernel_phase(torch, P, K):
    results = {"scan": {"err": 0, "cases": 0, "times": {}},
               "repair": {"err": 0, "cases": 0, "rounds_max": 0,
                          "times": {}}}
    seed = 0
    for family in FAMILIES:
        for kind, bs in (("scan", (8, 16, 256)),
                         ("repair", (32, 256, 1024))):
            for b in bs:
                for use_pen in (False, True):
                    seed += 1
                    state, batch, pen = make_case(family, b, seed, torch, P)
                    err, rounds, n_forced = compare(
                        kind, state, batch, pen if use_pen else None, P, K,
                        torch)
                    r = results[kind]
                    r["err"] = max(r["err"], err)
                    r["cases"] += 1
                    if kind == "repair":
                        r["rounds_max"] = max(r["rounds_max"], rounds)
                    say("kernel_case", kernel=kind, family=family, B=b,
                        penalty=use_pen, max_abs_err=err, rounds=rounds,
                        forced=n_forced)
                    require(err == 0, f"{kind} {family} B={b} pen={use_pen}"
                                      f" differs from plain by {err}")
                    del state, batch, pen
    # times at B = 16 and 256 on memory-dominant traffic (one or two
    # repair rounds); the kernels line takes its main numbers from each
    # kernel's own main-path batch (main_path_kernel)
    for kind, b in (("scan", 256), ("repair", 16), ("scan", 16),
                    ("repair", 256)):
        state, batch, pen = make_case("memory", b, 1000 + b, torch, P)
        work = clone_state(P, state)
        kview = K.to_transposed(work)

        def restore():
            work.free_mb.copy_(state.free_mb)
            work.conc_free.copy_(state.conc_free)

        kfn = (K.schedule_batch_cuda if kind == "scan"
               else K.schedule_batch_repair_cuda)
        pfn = P.schedule_batch if kind == "scan" else P.schedule_batch_repair
        plain0 = time_ms(lambda: pfn(work, batch), restore, torch)
        ms = time_ms(lambda: kfn(kview, batch), restore, torch)
        plain1 = time_ms(lambda: pfn(work, batch), restore, torch)
        pen_ms = time_ms(lambda: kfn(kview, batch, pen), restore, torch)
        pen_plain_ms = time_ms(lambda: pfn(work, batch, pen), restore, torch,
                               reps=3)
        nbytes, ops, rounds = work_bytes_ops(kind, state, batch, None, P)
        pbytes, pops, prounds = work_bytes_ops(kind, state, batch, pen, P)
        bound_ms, bound_by = bound(nbytes, ops)
        pen_bound_ms, pen_bound_by = bound(pbytes, pops)
        row = dict(B=b, ms=ms, plain_ms=min(plain0, plain1), bytes=nbytes,
                   key_evals=ops, rounds=rounds, bound_ms=bound_ms,
                   bound_by=bound_by, penalized=dict(
                       ms=pen_ms, plain_ms=pen_plain_ms, bytes=pbytes,
                       key_evals=pops,
                       rounds=prounds, bound_ms=pen_bound_ms,
                       bound_by=pen_bound_by))
        results[kind]["times"][f"B{b}"] = row
        say("kernel_time", kernel=kind, family="memory", **row,
            plain_ms_both=[plain0, plain1])
        del state, batch, work, kview
    return results


def main_path_kernel(kind, box, torch, P, K):
    """A kernel on one batch of the main path, as the balancer handed it
    over (books after the step's release and health folds): held against
    the plain version, timed with and without a penalty, and its bound
    from the same inputs."""
    kfn, pfn = ((K.schedule_batch_cuda, P.schedule_batch) if kind == "scan"
                else (K.schedule_batch_repair_cuda, P.schedule_batch_repair))
    free0, conc0, health = box["state"]
    batch = box["batch"]
    work = P.PlacementState(free0.clone(), conc0.clone(), health)
    std = K.to_transposed(P.PlacementState(free0, conc0, health))

    def restore():
        work.free_mb.copy_(free0)
        work.conc_free.copy_(conc0)

    pen = torch.from_numpy(np.random.RandomState(11).randint(
        0, 4, free0.shape[0]).astype(np.int32)).to(free0.device)
    out = {}
    for label, p in (("plain", None), ("penalized", pen)):
        err, rounds, _ = compare(kind, std, batch, p, P, K, torch)
        require(err == 0, f"main-path {kind} ({label}) differs from plain "
                          f"by {err}")
        ms = time_ms(lambda: kfn(work, batch, p), restore, torch, reps=10)
        nbytes, ops, prounds = work_bytes_ops(kind, std, batch, p, P)
        require(prounds == rounds, "plain and kernel rounds agree")
        bound_ms, bound_by = bound(nbytes, ops)
        out[label] = dict(ms=ms, bytes=nbytes, key_evals=ops,
                          bound_ms=bound_ms, bound_by=bound_by,
                          max_abs_err=err)
        if kind == "repair":
            out[label].update(rounds=rounds, ms_per_round=ms / rounds)
        out[label]["plain_ms"] = time_ms(
            lambda: pfn(K.to_transposed(work), batch, p), restore, torch,
            reps=3)
    out["B"] = int(batch.valid.shape[0])
    out["valid_rows"] = int(batch.valid.sum())
    if kind == "scan":
        out["cluster"] = K.schedule_batch_cuda.cluster
    else:
        out["grid"] = K.schedule_batch_repair_cuda.grid
    say("main_path_kernel", kernel=kind, **out)
    return out


def serial_cost(kind, torch, P, K):
    """A kernel's cost per serial step apart from its probe: B
    container-opening rows on the same one-invoker window and slot. The
    repair commits one row a round (each later row conflicts with the row
    before), so rounds = B; the scan's every request commits at the same
    cell that the requests after it have already prefetched, which pins
    the owner's patch rule. Held against the plain version too."""
    out = {}
    for b in ((16, 256) if kind == "scan" else (32, 256)):
        ones = np.ones(b, int)
        batch = P.request_batch_from_numpy(
            0 * ones, ones, 0 * ones, 0 * ones, 128 * ones, 0 * ones,
            4 * ones, 0 * ones, ones.astype(bool), device=DEVICE)
        free = np.zeros(N_PAD, np.int32)
        free[:N_INV] = MEM_MB
        free[0] = 1 << 30
        health = np.zeros(N_PAD, bool)
        health[:N_INV] = True
        state = P.PlacementState(
            torch.from_numpy(free).to(DEVICE),
            torch.zeros((A, N_PAD), dtype=torch.int32, device=DEVICE).T,
            torch.from_numpy(health).to(DEVICE))
        err, rounds, _ = compare(kind, state, batch, None, P, K, torch)
        require(err == 0 and (kind == "scan" or rounds == b),
                f"serial {kind} case B={b}: err {err}, rounds {rounds}")
        work = clone_state(P, state)

        def restore():
            work.free_mb.copy_(state.free_mb)
            work.conc_free.copy_(state.conc_free)

        kfn = (K.schedule_batch_cuda if kind == "scan"
               else K.schedule_batch_repair_cuda)
        ms = time_ms(lambda: kfn(K.to_transposed(work), batch), restore,
                     torch, reps=10)
        steps = b if kind == "scan" else rounds
        out[f"B{b}"] = {"ms": ms, "max_abs_err": err,
                        ("us_per_request" if kind == "scan"
                         else "us_per_round"): ms * 1e3 / steps}
        if kind == "repair":
            out[f"B{b}"]["rounds"] = rounds
    say("serial_cost", kernel=kind, **out)
    return out


def per_op_us(run, torch):
    """The cost of one of the operations a probe kernel repeats: run(count)
    launches it, timed at 2,000 and at 0; (us per operation, ms by count)."""
    ms = {c: time_ms(lambda: run(c), lambda: None, torch, reps=10)
          for c in (0, 2000)}
    return (ms[2000] - ms[0]) * 1e3 / 2000, ms


def barrier_cost(torch, K, _build):
    """One cooperative grid barrier at the repair kernel's launch shape:
    csrc/grid_barrier.cu runs only barriers."""
    fn = _build.load("grid_barrier").grid_barrier_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = K.schedule_batch_repair_cuda.grid["blocks"]
    stream = torch.cuda.current_stream().cuda_stream

    def run(syncs):
        rc = fn(syncs, blocks, stream)
        require(rc == 0, f"grid_barrier launch: CUDA error {rc}")

    us, ms = per_op_us(run, torch)
    say("grid_barrier", blocks=blocks, threads=1024, ms=ms,
        us_per_barrier=us)
    return us


#: csrc/cluster_barrier.cu's modes: what the scan pays once a request
CLUSTER_MODES = ("cluster_barrier", "exchange", "first_design_exchange")


def cluster_cost(torch, K, _build):
    """At the scan's launch shape (one cluster), the cost of one cluster
    barrier, of one exchange of the scan's two minima a thread, and of the
    same exchange as the scan's first design made it: csrc/
    cluster_barrier.cu runs only those."""
    fn = _build.load("cluster_barrier").cluster_barrier_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = K.schedule_batch_cuda.cluster["blocks"]
    stream = torch.cuda.current_stream().cuda_stream
    sink = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    out = {}
    for mode, name in enumerate(CLUSTER_MODES):
        def run(count):
            rc = fn(count, blocks, mode, sink.data_ptr(), stream)
            require(rc == 0, f"cluster_barrier mode {mode}: CUDA error {rc}")

        out[f"{name}_us"] = per_op_us(run, torch)[0]
    say("cluster_cost", blocks=blocks, threads=1024, **out)
    return out


# ---------------------------------------------------------------- phase 4
class Traffic:
    """A seeded activation stream against one BalancerCore: a Zipf(1.1)
    mix over 2,000 actions (memory 128-2048 MB, max_conc 2-16 for a fifth,
    blackbox for 5%), completions 1-8 steps after placement, 1% of the
    invokers flapping health every 20 steps."""

    def __init__(self, seed, n_actions=2000):
        self.rng = rng = np.random.RandomState(seed)
        p = np.arange(1, n_actions + 1, dtype=float) ** -1.1
        self.p = p / p.sum()
        self.mem = rng.choice([128, 256, 512, 1024, 2048], n_actions)
        self.maxc = np.where(rng.rand(n_actions) < 0.2,
                             rng.randint(2, 17, n_actions), 1)
        self.blackbox = rng.rand(n_actions) < 0.05
        pb = np.where(self.blackbox, self.p, 0.0)
        self.p_blackbox = pb / pb.sum()
        self.ns = [f"ns{k % 200}" for k in range(n_actions)]
        self.fqn = [f"ns{k % 200}/pkg/action{k}" for k in range(n_actions)]
        self.healthy = np.ones(N_INV, bool)
        self.due = {}
        self.step_no = 0

    def flip(self, core, idxs, usable=None):
        for i in idxs:
            v = (not self.healthy[i]) if usable is None else usable
            self.healthy[i] = v
            core.set_health(int(i), bool(v))

    def advance(self, core, n_rows, blackbox_only=False):
        rng = self.rng
        for c in self.due.pop(self.step_no, []):
            core.complete(*c)
        if self.step_no and self.step_no % 20 == 0:
            self.flip(core, rng.choice(N_INV, N_INV // 100, replace=False))
        acts = rng.choice(len(self.p), n_rows,
                          p=self.p_blackbox if blackbox_only else self.p)
        core.submit([core.build_row(self.ns[a], self.fqn[a],
                                    int(self.mem[a]), int(self.maxc[a]),
                                    bool(self.blackbox[a])) for a in acts])
        t0 = time.perf_counter()
        with torch.profiler.record_function("balancer_step"):
            res = core.step()
        dt = time.perf_counter() - t0
        delays = rng.randint(1, 9, len(res.chosen))
        for k, inv in enumerate(res.chosen):
            if inv >= 0:
                self.due.setdefault(self.step_no + int(delays[k]), []).append(
                    (int(inv), int(res.rows[5, k]), int(res.rows[4, k]),
                     int(res.rows[6, k]), res.slot_keys[k]))
        self.step_no += 1
        return res, dt


def schedule():
    """(name, rows, blackbox_only, outage) per step; the first CPU_STEPS
    cover warm-up, full batches, trickle and the overload burst."""
    plan = [("warmup", MAX_BATCH, False, None)] * 4
    plan += [("full", MAX_BATCH, False, None)] * 56
    plan += [("trickle", None, False, None)] * 20
    plan += [("overload", MAX_BATCH, True, "down")]
    plan += [("overload", MAX_BATCH, True, None)] * 17
    plan += [("overload", MAX_BATCH, True, "up")]
    plan += [("overload", MAX_BATCH, True, None)] * 11
    plan += [("full", MAX_BATCH, False, None)] * 250
    plan += [("trickle", None, False, None)] * 20
    return plan


def drive(core, traffic, plan):
    """Run `plan` on core; yields (name, StepResult, seconds) per step."""
    outage = np.arange(N_INV - BLACKBOX + 10, N_INV)  # 990 blackbox invokers
    for name, rows, bb_only, out in plan:
        if out == "down":
            traffic.flip(core, outage, usable=False)
        elif out == "up":
            traffic.flip(core, outage, usable=True)
        n = rows if rows is not None else int(traffic.rng.randint(1, 17))
        res, dt = traffic.advance(core, n, blackbox_only=bb_only)
        yield name, res, dt


def capture_next(TB, attr):
    """Route the balancer's launches of kernel wrapper `attr` through a
    wrapper that keeps a copy of the first one's inputs (kernel layout).
    Returns (box, undo)."""
    real = getattr(TB, attr)
    box = {}

    def keep(state, batch, penalty=None):
        if not box:
            box["state"] = tuple(t.clone() for t in state)
            box["batch"] = type(batch)(*(c.clone() for c in batch))
        return real(state, batch, penalty)

    setattr(TB, attr, keep)
    return box, lambda: setattr(TB, attr, real)


def time_launches(TB, attr):
    """Route the balancer's launches of kernel wrapper `attr` through a
    wrapper that brackets each with CUDA events (no synchronisation).
    Returns (event pairs, undo)."""
    real = getattr(TB, attr)
    pairs = []

    def timed(*args, **kw):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = real(*args, **kw)
        e.record()
        pairs.append((s, e))
        return out

    setattr(TB, attr, timed)
    return pairs, lambda: setattr(TB, attr, real)


def launch_ms(pairs):
    """(median, count) of the timed launches' ms; call after a sync."""
    ms = [s.elapsed_time(e) for s, e in pairs]
    return (float(np.median(ms)) if ms else None), len(ms)


def _kind(name):
    if "placement_repair" in name:
        return "repair_kernel"
    if "placement_scan" in name:
        return "scan_kernel"
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return name.split(" (")[0]
    return "torch_ops"


def _union_ms(intervals, lo, hi):
    """Length of the union of (start, end) intervals clipped to [lo, hi)."""
    busy, end = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            busy += e - s
            end = e
    return busy


def device_profile(prof, torch, rounds):
    """Device time by kernel kind, the device's idle share over the
    profiled window and inside the steps (host range "balancer_step"), its
    longest idle gaps, the host time and device span of each named phase
    of the fused step, and the repair kernel's time per launch and per
    round."""
    cpu_t, cuda_t = torch.autograd.DeviceType.CPU, \
        torch.autograd.DeviceType.CUDA
    spans = ("balancer_step", "release_fold", "health_fold", "schedule")
    evs = prof.events()
    host = {k: [] for k in spans}
    gpu_span = {k: [] for k in spans}
    for e in evs:
        if e.name in spans:
            (host if e.device_type == cpu_t else gpu_span)[e.name].append(
                (e.time_range.start, e.time_range.end))
    steps = host["balancer_step"]
    t0, t1 = min(s for s, _ in steps), max(e for _, e in steps)
    dev = sorted((e.time_range.start, e.time_range.end, e.name) for e in evs
                 if e.device_type == cuda_t and e.name not in spans
                 and t0 <= e.time_range.start < t1)
    by_kind, by_name, repair_us = {}, {}, []
    for s, e, name in dev:
        k = _kind(name)
        by_kind[k] = by_kind.get(k, 0.0) + (e - s)
        if k == "torch_ops":
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        if k == "repair_kernel":
            repair_us.append(e - s)
    gaps, end, prev = [], t0, "window start"
    for s, e, name in dev:
        if s > end:
            gaps.append((s - end, prev, name))
        if e > end:
            end, prev = e, name
    if t1 > end:
        gaps.append((t1 - end, prev, "window end"))
    gaps.sort(key=lambda g: -g[0])
    iv = [(s, e) for s, e, _ in dev]
    busy = _union_ms(iv, t0, t1)
    step_us = sum(e - s for s, e in steps)
    busy_in_steps = sum(_union_ms(iv, s, e) for s, e in steps)
    phases = {k: dict(
        calls=len(host[k]),
        host_ms=sum(e - s for s, e in host[k]) / len(host[k]) / 1e3,
        device_span_ms=(sum(e - s for s, e in gpu_span[k]) / len(gpu_span[k])
                        / 1e3 if gpu_span[k] else None))
        for k in spans if host[k]}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    ops = sorted(((e.key, e.self_device_time_total) for e in
                  prof.key_averages() if e.self_device_time_total > 0),
                 key=lambda kv: -kv[1])[:8]
    n_rounds = sum(rounds)
    return dict(
        steps=len(steps), window_ms=(t1 - t0) / 1e3,
        device_busy_ms=busy / 1e3,
        device_idle_share=1.0 - busy / (t1 - t0),
        step_ms=step_us / len(steps) / 1e3,
        device_idle_share_in_steps=1.0 - busy_in_steps / step_us,
        device_ms_by_kind={k: v / 1e3 for k, v in by_kind.items()},
        top_torch_kernels_ms=[(n[:80], v / 1e3) for n, v in top],
        top_ops_self_device_ms=[(n[:60], v / 1e3) for n, v in ops],
        longest_idle_gaps=[dict(ms=g / 1e3, after=a[:60], before=b[:60])
                           for g, a, b in gaps[:5]],
        phases=phases, repair_launches=len(repair_us),
        repair_ms_per_launch=(float(np.mean(repair_us)) / 1e3
                              if repair_us else None),
        repair_rounds=n_rounds,
        repair_ms_per_round=(sum(repair_us) / 1e3 / n_rounds
                             if n_rounds else None))


#: steps of the main path's second full segment that are profiled, the step
#: whose repair inputs are kept for main_path_kernel, and the step from
#: which the first scan launch's inputs are kept (the second trickle: a
#: step's bucket covers its releases too, so the scan runs once the full
#: steps' completions have drained); all are left out of the step-latency
#: statistics
PROFILE_FROM, PROFILE_STEPS = 150, 30
CAPTURE_STEP = 200
SCAN_CAPTURE_FROM = 360
#: full steps of the scan-pinned main path, and how many the CPU replays
PINNED_STEPS, PINNED_CPU_STEPS = 40, 10


def main_path_phase(torch, K, TB):
    mem = [MEM_MB] * N_INV
    kw = dict(managed_fraction=0.9, blackbox_fraction=0.1,
              max_batch=MAX_BATCH, action_slots=A)
    plan = schedule()
    gpu = TB.BalancerCore(mem, device=DEVICE, **kw)
    require(gpu.n_pad == N_PAD, f"n_pad {gpu.n_pad}")
    traffic = Traffic(seed=7)
    scan_events, untime = time_launches(TB, "schedule_batch_cuda")
    K.reset_launch_counts()
    gpu_log, times, rounds, prof_rounds = [], {}, [], []
    books_at = prof = box = undo = sbox = sundo = scan_kept_at = None
    profiled = range(PROFILE_FROM, PROFILE_FROM + PROFILE_STEPS)
    forced = placed = 0
    t_all = time.perf_counter()
    for k, (name, res, dt) in enumerate(drive(gpu, traffic, plan)):
        gpu_log.append((res.chosen, res.forced, res.rounds))
        if sundo is not None and sbox:  # this step's scan launch was kept
            sundo()
            sundo, scan_kept_at = None, k
        if k in profiled:
            if res.bucket >= 32:
                prof_rounds.append(res.rounds)
        elif k not in (CAPTURE_STEP, scan_kept_at):
            times.setdefault(name, []).append(dt)
        if res.bucket >= 32:
            rounds.append(res.rounds)
        forced += int(res.forced.sum())
        placed += int((res.chosen >= 0).sum())
        require(((res.chosen >= -1) & (res.chosen < N_INV)).all(),
                "decisions in range")
        if k + 1 == CPU_STEPS:
            torch.cuda.synchronize()
            books_at = gpu.books()
        # the loop body runs between steps k and k + 1
        if k + 1 == PROFILE_FROM:
            torch.cuda.synchronize()
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.start()
        elif k + 1 == profiled.stop:
            torch.cuda.synchronize()
            prof.stop()
        elif k + 1 == CAPTURE_STEP:
            box, undo = capture_next(TB, "schedule_batch_repair_cuda")
        elif k == CAPTURE_STEP:
            undo()
        elif k + 1 == SCAN_CAPTURE_FROM:
            sbox, sundo = capture_next(TB, "schedule_batch_cuda")
    wall = time.perf_counter() - t_all
    launches = {"scan": K.schedule_batch_cuda.launches,
                "repair": K.schedule_batch_repair_cuda.launches}
    untime()
    torch.cuda.synchronize()
    scan_ms, scan_timed = launch_ms(scan_events)
    full = np.array(times["full"]) * 1e3
    full_placed = sum(int((r[0] >= 0).sum()) for k, ((nm, *_), r) in
                      enumerate(zip(plan, gpu_log))
                      if nm == "full" and k not in profiled
                      and k != CAPTURE_STEP)
    free, _, _ = gpu.books()
    require(np.isfinite(free).all() and free.shape == (N_PAD,), "books")
    summary = dict(
        steps=len(plan), wall_s=wall, placed=placed, forced=forced,
        full_steps_timed=len(full),
        placements_per_s=full_placed / (full.sum() / 1e3),
        step_p50_ms=float(np.percentile(full, 50)),
        step_p99_ms=float(np.percentile(full, 99)),
        trickle_p50_ms=float(np.percentile(np.array(times["trickle"]) * 1e3,
                                           50)),
        mean_repair_rounds=float(np.mean(rounds)), launches=launches,
        scan_ms_per_launch=scan_ms, scan_kept_at_step=scan_kept_at,
        counters=gpu.counters)
    say("main_path", **summary)
    require(launches["scan"] > 0 and launches["repair"] > 0,
            f"both kernels launched on the main path: {launches}")
    require(scan_timed == launches["scan"], "every scan launch was timed")
    require(forced > 0, "the overload burst forced placements")
    profile = device_profile(prof, torch, prof_rounds)
    say("profile", **profile)
    require(profile["repair_launches"] == len(prof_rounds),
            "the profile saw every repair launch of its steps")
    require(box and sbox, "a repair and a scan launch of the main path "
                          "were kept")

    # the same seed and sequence through the plain path on the CPU
    cpu = TB.BalancerCore(mem, device="cpu", **kw)
    t0 = time.perf_counter()
    mismatches = 0
    for k, (name, res, _) in enumerate(drive(cpu, Traffic(seed=7),
                                             plan[:CPU_STEPS])):
        g = gpu_log[k]
        if not (np.array_equal(res.chosen, g[0])
                and np.array_equal(res.forced, g[1])
                and res.rounds == g[2]):
            mismatches += 1
    cpu_books = cpu.books()
    books_equal = all(np.array_equal(x, y)
                      for x, y in zip(cpu_books, books_at))
    say("cpu_replay", steps=CPU_STEPS, mismatched_steps=mismatches,
        books_equal=books_equal, cpu_s=time.perf_counter() - t0)
    require(mismatches == 0 and books_equal,
            "card and CPU runs agree in decisions, rounds and books")
    return summary, launches, profile, box, sbox


def scan_pinned_phase(torch, K, TB):
    """The main path with the scan on every bucket: PINNED_STEPS full
    256-row steps of the same traffic through
    `BalancerCore(placement_kernel="scan")`, each scan launch timed with
    CUDA events; the first PINNED_CPU_STEPS replayed on the CPU."""
    mem = [MEM_MB] * N_INV
    kw = dict(managed_fraction=0.9, blackbox_fraction=0.1,
              max_batch=MAX_BATCH, action_slots=A, placement_kernel="scan")
    plan = [("full", MAX_BATCH, False, None)] * PINNED_STEPS
    gpu = TB.BalancerCore(mem, device=DEVICE, **kw)
    events, untime = time_launches(TB, "schedule_batch_cuda")
    K.reset_launch_counts()
    log, step_ms, books_at = [], [], None
    for k, (_, res, dt) in enumerate(drive(gpu, Traffic(seed=7), plan)):
        log.append((res.chosen, res.forced))
        step_ms.append(dt * 1e3)
        require(res.bucket == MAX_BATCH and res.rounds == 0,
                "full steps on the scan")
        if k + 1 == PINNED_CPU_STEPS:
            torch.cuda.synchronize()
            books_at = gpu.books()
    launches = {"scan": K.schedule_batch_cuda.launches,
                "repair": K.schedule_batch_repair_cuda.launches}
    untime()
    torch.cuda.synchronize()
    kernel_ms, timed = launch_ms(events)
    require(launches["scan"] == PINNED_STEPS and launches["repair"] == 0
            and timed == PINNED_STEPS,
            f"the scan alone ran the pinned path: {launches}")
    cpu = TB.BalancerCore(mem, device="cpu", **kw)
    t0 = time.perf_counter()
    mismatches = 0
    for k, (_, res, _) in enumerate(drive(cpu, Traffic(seed=7),
                                          plan[:PINNED_CPU_STEPS])):
        if not (np.array_equal(res.chosen, log[k][0])
                and np.array_equal(res.forced, log[k][1])):
            mismatches += 1
    books_equal = all(np.array_equal(x, y)
                      for x, y in zip(cpu.books(), books_at))
    out = dict(steps=PINNED_STEPS, step_p50_ms=float(np.median(step_ms)),
               launches=launches, kernel_ms_per_launch=kernel_ms,
               kernel_share_of_step=kernel_ms / float(np.median(step_ms)),
               placed=int(sum((c >= 0).sum() for c, _ in log)),
               cpu_replay=dict(steps=PINNED_CPU_STEPS,
                               mismatched_steps=mismatches,
                               books_equal=books_equal,
                               cpu_s=time.perf_counter() - t0))
    say("scan_pinned", **out)
    require(mismatches == 0 and books_equal,
            "scan-pinned card and CPU runs agree in decisions and books")
    return out


# ---------------------------------------------------------------- phase 7
#: the front's traffic: publish_many waves of MAX_BATCH rows, the profiled
#: waves, the 1% flap (down at FLAP_AT, a ping brings it back FLAP_BACK
#: waves later), the trickle steps, and the rate-limited segment
FRONT_WAVES = 80
FRONT_PROFILE_FROM, FRONT_PROFILE_WAVES = 40, 30
FLAP_AT, FLAP_BACK = 10, 6
FRONT_TRICKLE = 20
RATE_WAVES, RATE_LIMIT = 16, 60
#: the pool marks an invoker offline after 10 s without a ping: the fleet
#: pings every invoker again once this many seconds have passed
REPING_S = 3.0
PING_CHUNK = 1000  # pings in flight at once (the health topic keeps 4,096)


def _percentiles(xs):
    xs = np.asarray(xs, float)
    return (float(np.percentile(xs, 50)), float(np.percentile(xs, 99))) \
        if len(xs) else (None, None)


def _time_calls(obj, name, acc, key):
    """Route obj.name through a wrapper that adds its wall time to
    acc[key] (a host-time split of the front; coroutines are timed from
    call to return)."""
    real = getattr(obj, name)
    acc.setdefault(key, 0.0)
    if asyncio.iscoroutinefunction(real):
        async def timed(*a, **k):
            t = time.perf_counter()
            try:
                return await real(*a, **k)
            finally:
                acc[key] += time.perf_counter() - t
    else:
        def timed(*a, **k):
            t = time.perf_counter()
            try:
                return real(*a, **k)
            finally:
                acc[key] += time.perf_counter() - t
    setattr(obj, name, timed)


class Fleet:
    """N_INV simulated invokers of MEM_MB on one in-memory bus. One fleet
    task drains the invoker topics the balancer wrote to (the bus's
    producer notes them), and acks each activation `delay` waves after it
    arrived, with its result; pings go out in paced rounds."""

    def __init__(self, seed):
        from openwhisk_tpu_torch.core import entity as E
        from openwhisk_tpu_torch.messaging import memory as mem
        from openwhisk_tpu_torch.messaging import message as M
        self.E, self.M = E, M
        self.rng = np.random.RandomState(seed)
        fleet = self
        self.touched, self.wake = set(), None

        class Producer(mem.MemoryProducer):
            async def send(self, topic, msg):
                await super().send(topic, msg)
                if topic.startswith("invoker"):
                    fleet.touched.add(topic)
                    fleet.wake.set()

        class Bus(mem.MemoryMessagingProvider):
            def get_producer(self):
                return Producer(self.bus)

        self.provider = Bus()
        self.producer = self.provider.get_producer()
        self.instances = [E.InvokerInstanceId(i, user_memory=E.MB(MEM_MB))
                          for i in range(N_INV)]
        self.consumers = {}
        self.due = {}          # wave -> [ack]
        self.wave = 0
        self.received = 0
        self.last_ping = 0.0
        self.task = None
        self.host_s = {"fleet_parse_and_ack_build": 0.0}
        _time_calls(self, "ack_due", self.host_s, "fleet_ack_send")
        self.host_s["fleet_ping_send"] = 0.0

    def start(self):
        self.wake = asyncio.Event()
        self.task = asyncio.get_event_loop().create_task(self._drain())

    async def stop(self):
        self.task.cancel()
        await asyncio.gather(self.task, return_exceptions=True)

    async def _drain(self):
        E, M = self.E, self.M
        while True:
            await self.wake.wait()
            self.wake.clear()
            topics, self.touched = self.touched, set()
            t0 = time.perf_counter()
            for topic in topics:
                c = self.consumers.get(topic)
                if c is None:
                    c = self.consumers[topic] = self.provider.get_consumer(
                        topic, topic, max_peek=1 << 16)
                got = await c.peek(1 << 16, timeout=0)
                c.commit()
                inv = self.instances[int(topic[len("invoker"):])]
                for _, _, _, payload in got:
                    msg = M.ActivationMessage.parse(payload)
                    now = time.time()
                    act = E.WhiskActivation(
                        E.EntityPath(str(msg.user.namespace.name)),
                        msg.action.name, msg.user.subject,
                        msg.activation_id, now, now,
                        E.ActivationResponse.success({"ok": True}),
                        duration=1)
                    ack = (f"completed{msg.root_controller_index.as_string}",
                           M.CombinedCompletionAndResultMessage(
                               msg.transid, act, inv))
                    self.due.setdefault(
                        self.wave + int(self.rng.randint(1, 9)),
                        []).append(ack)
                    self.received += 1
            self.host_s["fleet_parse_and_ack_build"] += \
                time.perf_counter() - t0

    async def ack_due(self, wave, everything=False):
        """Advance to `wave` and send the acks due by then (all of them
        with `everything`)."""
        self.wave = wave
        keys = sorted(k for k in self.due if everything or k <= wave)
        for k in keys:
            for topic, ack in self.due.pop(k):
                await self.producer.send(topic, ack)

    async def ping(self, pool, ids):
        """Ping invokers `ids` through `pool`'s health feed, PING_CHUNK at
        a time, each chunk waited for (pings are handled in order)."""
        t_round = time.monotonic()
        for s in range(0, len(ids), PING_CHUNK):
            chunk = ids[s:s + PING_CHUNK]
            t0 = time.perf_counter()
            for i in chunk:
                await self.producer.send("health",
                                         self.M.PingMessage(self.instances[i]))
            self.host_s["fleet_ping_send"] += time.perf_counter() - t0
            last = chunk[-1]
            while (pool.invokers.get(last) is None
                   or pool.invokers[last].last_ping < t_round):
                require(time.monotonic() - t_round < 60.0,
                        "the pool handled a ping round within 60 s")
                await asyncio.sleep(0.001)
        self.last_ping = time.monotonic()

    async def keep_alive(self, pool):
        if time.monotonic() - self.last_ping > REPING_S:
            await self.ping(pool, list(range(N_INV)))


class ActionMix:
    """Phase 4's Zipf(1.1) mix over 2,000 actions as `(action, message)`
    pairs for the front: one namespace identity per ns, memory 128-2048 MB,
    max_conc 2-16 for a fifth, blackbox for 5%."""

    def __init__(self, seed, ctrl):
        from openwhisk_tpu_torch.core import entity as E
        from openwhisk_tpu_torch.messaging import message as M
        from openwhisk_tpu_torch.utils.transaction import TransactionId
        self.E, self.M, self.Tx, self.ctrl = E, M, TransactionId, ctrl
        mix = Traffic(seed)
        self.rng, self.p = mix.rng, mix.p
        # deployments opt in to these (the defaults cap at 512 MB / 1)
        E.MemoryLimit.MAX = E.MB(2048)
        E.ConcurrencyLimit.MAX = 16
        self.idents = [E.Identity.from_json({
            "subject": f"subject{j}",
            "namespace": {"name": f"ns{j}",
                          "uuid": f"{j:08x}-71f6-4ed5-8c54-816aa4f8c502"},
            "authkey": {"api_key": f"{j:08x}-71f6-4ed5-8c54-816aa4f8c502:"
                                   + "k" * 64},
            "rights": ["ACTIVATE"], "limits": {}}) for j in range(200)]
        self.actions = []
        for k in range(len(mix.p)):
            exe = (E.BlackBoxExec(image="img") if mix.blackbox[k]
                   else E.CodeExec(kind="python:3", code="x"))
            a = E.ExecutableWhiskAction(
                E.EntityPath(f"ns{k % 200}/pkg"), E.EntityName(f"action{k}"),
                exe, limits=E.ActionLimits(
                    E.TimeLimit(60_000), E.MemoryLimit(E.MB(int(mix.mem[k]))),
                    concurrency=E.ConcurrencyLimit(int(mix.maxc[k]))))
            a.rev = E.DocRevision("1-a")
            self.actions.append(a)
        self.count = 0

    def pairs(self, n):
        E = self.E
        out = []
        for k in self.rng.choice(len(self.p), n, p=self.p):
            self.count += 1
            a = self.actions[k]
            out.append((a, self.M.ActivationMessage(
                self.Tx(f"front{self.count}"), a.fully_qualified_name,
                "1-a", self.idents[k % 200], E.ActivationId.generate(),
                self.ctrl, False, {})))
        return out


class Recorder:
    """Wraps a balancer's packed step, idle release fold, slot-axis growth
    and the module's health set, keeping each call's inputs and the step's
    output (the smoke's instrumentation: the balancer has no such
    feature)."""

    def __init__(self, bal, TB):
        self.bal, self.TB, self.log = bal, TB, []
        step, rel, grow, health = bal._packed_fn, bal._release_packed_fn, \
            bal._grow_slots, TB.set_health
        self.undo = lambda: (setattr(bal, "_packed_fn", step),
                             setattr(bal, "_release_packed_fn", rel),
                             setattr(bal, "_grow_slots", grow),
                             setattr(TB, "set_health", health))
        rate = bal.rate_limit_per_minute is not None

        def grow_slots(new_slots):
            self.log.append(("slots", new_slots))
            return grow(new_slots)

        def packed(*args):
            res = step(*args)
            buf, *rest = args[1:]
            now = float(rest.pop(0)) if rate else None
            self.log.append(("step", buf, now, tuple(rest), res[1]))
            return res

        def release(state, rel_t):
            self.log.append(("release", rel_t))
            return rel(state, rel_t)

        def set_health(state, idx, vals):
            self.log.append(("health", list(idx), list(vals)))
            return health(state, idx, vals)

        bal._packed_fn, bal._release_packed_fn = packed, release
        bal._grow_slots = grow_slots
        TB.set_health = set_health

    def replay(self, books, buckets, P, TB, TT):
        """The log through the plain fused steps on the CPU from `books`
        (free, conc [A, N], health) and `buckets`: (steps whose packed
        output differs, steps, plain state)."""
        sched, release, _ = TB._torch_pair(self.bal.placement_kernel)
        rate = buckets is not None
        step = (P.make_fused_admit_step_packed if rate
                else P.make_fused_step_packed)(release, sched)
        rel_fn = P.make_release_packed(release)
        free, conc, health = books
        st = P.placement_state_from_numpy(free, conc.T, health, "cpu")
        bk = TT.TokenBucketState(*(t.cpu().clone() for t in buckets)) \
            if rate else None
        bad = steps = 0
        for ev in self.log:
            if ev[0] == "step":
                _, buf, now, shape, out = ev
                if rate:
                    (st, bk), o = step((st, bk), buf.cpu(), np.float32(now),
                                       *shape)
                else:
                    st, o = step(st, buf.cpu(), *shape)
                steps += 1
                bad += int(not torch.equal(o, out.cpu()))
            elif ev[0] == "release":
                st = rel_fn(st, ev[1].cpu())
            elif ev[0] == "slots":
                conc = torch.zeros((ev[1], st.free_mb.shape[0]),
                                   dtype=torch.int32)
                conc[:st.conc_free.shape[1]] = st.conc_free.T
                st = P.PlacementState(st.free_mb, conc.T, st.health)
            else:
                st = P.set_health(st, ev[1], ev[2])
        return bad, steps, st


def _books_np(state):
    return tuple(t.cpu().numpy().copy() for t in (
        state.free_mb, state.conc_free.T, state.health))


async def _drain_front(bal, timeout=120.0):
    """Until every activation is acked and nothing is queued or folding."""
    t0 = time.monotonic()
    while (bal.total_active_activations or bal._inflight_steps
           or bal._pending or bal._releases or bal._readbacks
           or not (bal._flush_task is None or bal._flush_task.done())):
        require(time.monotonic() - t0 < timeout,
                f"front drained within {timeout} s: "
                f"{bal.total_active_activations} active")
        await asyncio.sleep(0.001)


async def _front_run(TB, K, rate_limit, ctrl_id, waves, trickle, profile,
                     flap):
    """One balancer's run: register the fleet, drive `waves` publish_many
    waves (acks 1-8 waves later; the 1% flap with `flap`; the profiled
    window with `profile`), ack everything, the trickle. Returns the run's
    numbers, its recorder, (books at the start, bucket state at the start,
    books at the end) and the profiler."""
    from openwhisk_tpu_torch.core import entity as E
    from openwhisk_tpu_torch.controller.loadbalancer.base import (
        HEALTHY, LoadBalancerThrottleException)
    errors = []

    class Log:
        def error(self, _tid, msg, *_):
            errors.append(msg)

        def warn(self, *_):
            pass

        def info(self, *_):
            pass

    ctrl = E.ControllerInstanceId(ctrl_id)
    fleet = Fleet(seed=11)
    fleet.start()
    bal = TB.TpuBalancer(
        fleet.provider, ctrl, logger=Log(), managed_fraction=0.9,
        blackbox_fraction=0.1, max_batch=MAX_BATCH, action_slots=A,
        initial_pad=64, rate_limit_per_minute=rate_limit,
        device=None if DEVICE == "cuda" else DEVICE)
    await bal.start()
    t0 = time.perf_counter()
    await fleet.ping(bal.supervision, list(range(N_INV)))
    register_s = time.perf_counter() - t0
    require(len(bal._registry) == N_INV and all(bal._healthy)
            and bal.state.free_mb.shape[0] == N_PAD,
            f"fleet registered, pad {bal.state.free_mb.shape[0]}")
    # a step folds at most HEALTH_BATCH of the registration's N_INV health
    # flips, an idle fold all of them: let one run before the traffic
    bal._arm_flush()
    await _drain_front(bal)
    require(not bal._health_updates and bool(bal.state.health[:N_INV].all()),
            "the registration's health flips folded")
    books0 = _books_np(bal.state)
    buckets0 = (None if bal._bucket_state is None else
                tuple(t.clone() for t in bal._bucket_state))
    rec = Recorder(bal, TB)
    # the host-time split of the driven segment (the smoke's wrappers)
    host = fleet.host_s
    for k in host:
        host[k] = 0.0
    for name, key in (("publish_many", "balancer_publish_many"),
                      ("_row_placed", "balancer_fan_out"),
                      ("send_activation_to_invoker", "balancer_send"),
                      ("process_acknowledgement", "balancer_ack")):
        _time_calls(bal, name, host, key)
    _time_calls(bal.supervision, "on_ping", host, "pool_on_ping")
    mix = ActionMix(seed=7, ctrl=ctrl)
    flapped = [int(i) for i in
               fleet.rng.choice(N_INV, N_INV // 100, replace=False)]
    lat, outs_all, flap_status = [], [], {}
    prof = window = rate_waves = None

    async def ack_everything(wave):
        # the fleet must hold every placed activation before it acks all
        placed = sum(1 for o in outs_all
                     if o.done() and not o.cancelled()
                     and o.exception() is None)
        t0 = time.monotonic()
        while fleet.received < placed:
            require(time.monotonic() - t0 < 60.0,
                    f"the fleet received {fleet.received} of {placed}")
            await asyncio.sleep(0.001)
        await fleet.ack_due(wave, everything=True)
        await _drain_front(bal)

    K.reset_launch_counts()
    t_first = time.perf_counter()
    prev = []
    for w in range(waves):
        await fleet.ack_due(w)
        await fleet.keep_alive(bal.supervision)
        if flap and w == FLAP_AT:
            for i in flapped:
                for _ in range(4):
                    bal.supervision.on_invocation_finished(
                        fleet.instances[i], True, False)
            flap_status["down"] = sum(
                bal.supervision.invokers[i].status != HEALTHY
                for i in flapped)
        if flap and w == FLAP_AT + FLAP_BACK:
            await fleet.ping(bal.supervision, flapped)
            flap_status["back"] = sum(
                bal.supervision.invokers[i].status == HEALTHY
                for i in flapped)
        if profile and w == FRONT_PROFILE_FROM:
            rate_waves = (time.perf_counter() - t_first, w * MAX_BATCH)
            torch.cuda.synchronize()
            prof = torch.profiler.profile(activities=PROFILE_ACTIVITIES)
            prof.start()
            window = torch.profiler.record_function("front_window")
            window.__enter__()
        t_pub = time.perf_counter()
        outs = bal.publish_many(mix.pairs(MAX_BATCH))
        for o in outs:
            o.add_done_callback(
                lambda f, t=t_pub: lat.append(time.perf_counter() - t))
        outs_all.extend(outs)
        # up to two waves in flight: wait for the one before this
        await asyncio.gather(*prev, return_exceptions=True)
        prev = outs
        if profile and w == FRONT_PROFILE_FROM + FRONT_PROFILE_WAVES - 1:
            await asyncio.gather(*prev, return_exceptions=True)
            torch.cuda.synchronize()
            window.__exit__(None, None, None)
            prof.stop()
    await asyncio.gather(*prev, return_exceptions=True)
    await ack_everything(waves)
    # the trickle once the releases have drained: 1-16 rows a step through
    # publish_many, every second step one serial publish
    for k in range(trickle):
        if k % 2:
            a, msg = mix.pairs(1)[0]
            outs = [asyncio.ensure_future(bal.publish(a, msg))]
        else:
            outs = bal.publish_many(mix.pairs(int(mix.rng.randint(1, 17))))
        outs_all.extend(outs)
        await asyncio.gather(*outs, return_exceptions=True)
        await ack_everything(waves + 1 + k)
    t_last = time.perf_counter()
    launches = {"scan": K.schedule_batch_cuda.launches,
                "repair": K.schedule_batch_repair_cuda.launches}
    rec.undo()
    promises, failed, throttled = [], [], 0
    for o in outs_all:
        exc = o.exception()
        if isinstance(exc, LoadBalancerThrottleException):
            throttled += 1
        elif exc is not None:
            failed.append(repr(exc))
        else:
            promises.append(o.result())
    results = await asyncio.gather(*promises, return_exceptions=True)
    torch.cuda.synchronize()
    books = _books_np(bal.state)
    summary = dict(
        rate_limit=rate_limit, register_s=register_s, waves=waves,
        trickle_steps=trickle, activations=len(promises),
        throttled=throttled, failed=len(failed), failed_first=failed[:3],
        unresolved=sum(not hasattr(r, "response") for r in results),
        fleet_received=fleet.received,
        active_at_end=bal.total_active_activations,
        activations_per_s=len(promises) / (t_last - t_first),
        placement_ms_p50_p99=[x * 1e3 for x in _percentiles(lat)],
        step_ms_p50_p99=list(_percentiles(bal.step_ms)),
        steps=bal.counters["steps"], launches=launches,
        mean_repair_rounds=(bal.counters["repair_rounds"]
                            / max(1, bal.counters["repair_steps"])),
        rtt_policy=bal.rtt_policy, rtt_ewma_ms=bal._rtt_ewma_ms,
        books_full=bool((books[0][:N_INV] == MEM_MB).all()
                        and not books[1].any() and books[2][:N_INV].all()),
        errors=errors[:3],
        host_s=dict(host, wall=t_last - t_first,
                    other=t_last - t_first - sum(host.values())))
    if flap:
        summary["flap"] = dict(invokers=len(flapped), **flap_status)
    if rate_waves is not None:
        summary["placements_per_s_before_profile"] = \
            rate_waves[1] / rate_waves[0]
    await bal.close()
    await fleet.stop()
    return summary, rec, (books0, buckets0, books), prof


def _window_idle_share(prof):
    """The device's idle share over the host range "front_window"."""
    cpu_t, cuda_t = torch.autograd.DeviceType.CPU, \
        torch.autograd.DeviceType.CUDA
    evs = prof.events()
    win = [(e.time_range.start, e.time_range.end) for e in evs
           if e.name == "front_window" and e.device_type == cpu_t]
    t0, t1 = win[0]
    dev = [(e.time_range.start, e.time_range.end) for e in evs
           if e.device_type == cuda_t and e.name != "front_window"]
    busy = _union_ms(dev, t0, t1)
    return dict(window_ms=(t1 - t0) / 1e3, device_busy_ms=busy / 1e3,
                device_idle_share=1.0 - busy / (t1 - t0))


#: the profiler's activities (the CPU rehearsal drops CUDA)
PROFILE_ACTIVITIES = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]


def front_phase(torch, P, K, TB):
    """Phase 7: the front at full width, its checks and its CPU replay."""
    from openwhisk_tpu_torch.ops import throttle as TT
    res = {}
    for label, rate, waves, trickle, profile in (
            ("main", None, FRONT_WAVES, FRONT_TRICKLE, True),
            ("rate_limited", RATE_LIMIT, RATE_WAVES, 0, False)):
        t0 = time.perf_counter()
        out, rec, (books0, buckets0, books), prof = asyncio.run(_front_run(
            TB, K, rate, "0" if label == "main" else "1", waves, trickle,
            profile=profile, flap=profile))
        if prof is not None:
            out["profile"] = _window_idle_share(prof)
        t1 = time.perf_counter()
        bad, steps, st = rec.replay(books0, buckets0, P, TB, TT)
        replay_books = _books_np(st)
        books_equal = all(np.array_equal(x, y)
                          for x, y in zip(books, replay_books))
        out["cpu_replay"] = dict(steps=steps, events=len(rec.log),
                                 mismatched_steps=bad,
                                 books_equal=books_equal,
                                 cpu_s=time.perf_counter() - t1)
        out["run_s"] = t1 - t0
        say("front", segment=label, **out)
        require(not out["failed"] and not out["unresolved"]
                and not out["errors"],
                f"front {label}: every activation resolved")
        require(out["active_at_end"] == 0 and out["books_full"],
                f"front {label}: nothing active, books at full capacity")
        require(bad == 0 and books_equal,
                f"front {label}: card and CPU replay agree")
        if rate is None:
            require(out["launches"]["scan"] > 0
                    and out["launches"]["repair"] > 0,
                    f"both kernels launched on the front: {out['launches']}")
            require(out["flap"]["down"] == out["flap"]["invokers"]
                    and out["flap"]["back"] == out["flap"]["invokers"],
                    f"the 1% flap went down and came back: {out['flap']}")
        else:
            require(out["throttled"] > 0, "rows throttled")
            require(out["launches"]["repair"] > 0,
                    f"the repair kernel ran: {out['launches']}")
        res[label] = out
    return res


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from openwhisk_tpu_torch.controller.loadbalancer import tpu_balancer as TB
    from openwhisk_tpu_torch.ops import _build
    from openwhisk_tpu_torch.ops import placement as P
    from openwhisk_tpu_torch.ops import placement_cuda as K

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    say("card", nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda)

    t0 = time.perf_counter()
    _build.build(K.SOURCES + ("grid_barrier", "cluster_barrier"))
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if "registers" in ln or "spill" in ln]
             for k, v in _build.build_logs.items()}
    say("build", seconds=time.perf_counter() - t0, ptxas=ptxas)

    t0 = time.perf_counter()
    kres = kernel_phase(torch, P, K)
    say("kernel_phase", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    summary, launches, profile, box, sbox = main_path_phase(torch, K, TB)
    say("main_phase", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    mk = main_path_kernel("repair", box, torch, P, K)
    sk = main_path_kernel("scan", sbox, torch, P, K)
    del box, sbox
    serial_cost("repair", torch, P, K)
    sserial = serial_cost("scan", torch, P, K)
    barrier_cost(torch, K, _build)
    cluster = cluster_cost(torch, K, _build)
    say("main_kernel_phase", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    pinned = scan_pinned_phase(torch, K, TB)
    say("scan_pinned_phase", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    front = front_phase(torch, P, K, TB)
    say("front_phase", seconds=time.perf_counter() - t0)
    front_launches = {k: sum(seg["launches"][k] for seg in front.values())
                      for k in ("scan", "repair")}

    scan = sk["plain"]
    rep = mk["plain"]
    kernels = [
        {"name": "placement_scan", "route": "cuda",
         "source": "openwhisk_tpu_torch/csrc/placement_scan.cu",
         "replaces": "openwhisk_tpu/ops/placement_pallas.py:244",
         "launches": launches["scan"],
         "front_launches": front_launches["scan"],
         "max_abs_err": max(kres["scan"]["err"], scan["max_abs_err"],
                            sk["penalized"]["max_abs_err"],
                            *(v["max_abs_err"] for v in sserial.values())),
         "B": sk["B"], "cluster": sk["cluster"], "ms": scan["ms"],
         "plain_ms": scan["plain_ms"], "bound_ms": scan["bound_ms"],
         "bound_by": scan["bound_by"], "key_evals": scan["key_evals"],
         "library_ms": None,
         "us_per_request": sserial["B256"]["us_per_request"],
         "main_path_ms": summary["scan_ms_per_launch"],
         **cluster,
         "serial": sserial, "memory_traffic": kres["scan"]["times"],
         "scan_pinned": {k: pinned[k] for k in
                         ("step_p50_ms", "kernel_ms_per_launch", "launches")},
         "penalized": sk["penalized"]},
        {"name": "placement_repair", "route": "cuda",
         "source": "openwhisk_tpu_torch/csrc/placement_repair.cu",
         "replaces": "openwhisk_tpu/ops/placement_pallas.py:464",
         "launches": launches["repair"],
         "front_launches": front_launches["repair"],
         "max_abs_err": max(kres["repair"]["err"], rep["max_abs_err"]),
         "B": mk["B"], "grid": mk["grid"], "ms": rep["ms"],
         "rounds": rep["rounds"], "ms_per_round": rep["ms_per_round"],
         "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
         "bound_by": rep["bound_by"], "key_evals": rep["key_evals"],
         "library_ms": None,
         "main_path_ms_per_launch": profile["repair_ms_per_launch"],
         "main_path_ms_per_round": profile["repair_ms_per_round"],
         "memory_traffic": kres["repair"]["times"],
         "penalized": mk["penalized"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
