"""One scenario for `BalancerCore`'s step graphs (`_graphed_step`), on any
device, shared by `test_torch_core_graph.py` (the CPU, with a stand-in
graph) and `test_torch_core_graph_cuda.py` (the card).

Sixteen steps over 300 invokers: batches of 8, 64 and 256 rows and some
in between (several step shapes, each R = B = the step's bucket, H = 64),
completions of 40% of the placed rows at random, health flips on three
steps only, a clock that moves between steps (rate admission, when on,
refills from it), and the books handed over to new storage before step
`SWAP_AT`. Imports no jax.
"""
import numpy as np

from openwhisk_tpu_torch.controller.loadbalancer import \
    tpu_balancer as TB
from openwhisk_tpu_torch.ops import placement as T

#: rows submitted before each step
BATCHES = (8, 64, 256, 256, 8, 64, 40, 256, 5, 256, 256, 64, 8, 256, 256,
           130)
#: the step before which the books move to new storage
SWAP_AT = 9
#: health flips queued before a step: (invoker, usable)
FLIPS = {3: [(5, False), (17, False)], 7: [(5, True), (290, False)],
         12: [(17, True)]}


def make_core(device, admit: bool) -> "TB.BalancerCore":
    return TB.BalancerCore([2048] * 300, device=device, max_batch=256,
                           action_slots=64,
                           rate_limit_per_minute=600 if admit else None)


def swap_books(core) -> T.PlacementState:
    """Hand `core` a copy of its books in new storage; returns the old."""
    old = core.state
    new = T.empty_books_like(old)
    for s, t in zip(new, old):
        s.copy_(t)
    core.state = new
    return old


def drive(core, before_step=None) -> list:
    """The scenario on `core`: per step (decisions, books, buckets,
    counters, bucket), decisions as (chosen, forced, throttled, rounds)
    and buckets as host copies of (tokens, last_refill), None without
    admission. `before_step(core, step)` runs right before each step."""
    rng = np.random.RandomState(5)
    p = 0.6 ** np.arange(30)
    log = []
    for step, n in enumerate(BATCHES):
        core.set_clock(step * 0.37 + 0.013)
        for i, v in FLIPS.get(step, ()):
            core.set_health(i, v)
        acts = rng.choice(30, n, p=p / p.sum())
        core.submit([core.build_row(f"ns{a % 6}", f"ns{a % 6}/a{a}",
                                    128 * (1 + a % 3), 4 if a % 4 == 0 else 1,
                                    a % 11 == 0) for a in acts])
        if before_step is not None:
            before_step(core, step)
        res = core.step()
        thr = None if res.throttled is None else res.throttled.tolist()
        buckets = None if core._buckets is None else (
            core._buckets.tokens.cpu().numpy().copy(),
            float(core._buckets.last_refill))
        log.append(((res.chosen.tolist(), res.forced.tolist(), thr,
                     res.rounds), core.books(), buckets,
                    dict(core.counters), res.bucket))
        for k, inv in enumerate(res.chosen):
            if inv >= 0 and rng.rand() < 0.4:
                core.complete(int(inv), int(res.rows[5, k]),
                              int(res.rows[4, k]), int(res.rows[6, k]),
                              res.slot_keys[k])
    return log


def expected_captures(log) -> list:
    """Per step, 1 where the step's shape is new to the books it runs on
    (its first step, or its first after the swap), else 0."""
    seen, out = set(), []
    for step, (*_, bucket) in enumerate(log):
        key = (bucket, step >= SWAP_AT)
        out.append(int(key not in seen))
        seen.add(key)
    return out


def assert_same_run(got, want) -> None:
    """Step for step: decisions and flags, books, bucket state."""
    for step, (g, w) in enumerate(zip(got, want)):
        assert g[0] == w[0], f"decisions differ at step {step}"
        for x, y in zip(g[1], w[1]):
            np.testing.assert_array_equal(x, y, f"books at step {step}")
        if w[2] is None:
            assert g[2] is None
        else:
            np.testing.assert_array_equal(g[2][0], w[2][0],
                                          f"tokens at step {step}")
            assert g[2][1] == w[2][1]
    assert len(got) == len(want) == len(BATCHES)


def counter_steps(log, name: str) -> list:
    """Per step, how much counter `name` rose in it."""
    values = [0] + [c[name] for _, _, _, c, _ in log]
    return [b - a for a, b in zip(values, values[1:])]
