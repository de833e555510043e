"""The one traffic generator: it reads a mix file
(`owbench/traffic/<name>.json`) and a configuration file, and draws every
input of a run from `--seed`.

A mix gives the arrivals, the completions and the health flaps:

- `zipf_s`: how skewed the actions' popularity is: the action of rank k
  is invoked in proportion to k^-zipf_s;
- `burst_rows` [lo, hi]: a trigger fires a burst of rows, its size
  log-uniform in [lo, hi], each row an action drawn from that law;
- `backlog_rows`: before every step, bursts are queued until at least
  that many rows wait (the batch, `max_batch`, for full steps);
- `duration_log_mu`, `duration_log_sigma`, `timeout_s`: an activation's
  duration in seconds is log-normal with those parameters (of its natural
  log), cut at the action timeout;
- `occupancy`: the expected in-flight memory as a share of the fleet's user
  memory. It sets how many steps a second of duration lasts: the mean
  delay in steps is occupancy x invokers x memory / (rows a step x the
  expected memory of one activation, a container's memory over its
  permits), the rows a step those the queue's rule gives (`max_batch`
  wherever the backlog holds a batch). A delay is the duration in steps,
  rounded, at least 1;
- `warm_steps`: set-up steps of ordinary traffic after the fill (below),
  so that completions flow and every kernel the window launches has run;
- `flap_every_steps`, `flap_down_share`: every that many steps the
  invokers taken down at the previous flap come back and a fresh share of
  the fleet, drawn from the healthy ones, goes down.

The fill: the first `fill_steps` steps (the mean delay, rounded) give each
row the delay that brings it to the window's start and, beyond that, a
residual drawn as the residual of an activation in flight at a random
moment of the steady state (P(r) in proportion to P(delay > r)). So after
the fill as many activations are in flight as in the steady state, with
the steady state's residuals, and no completion falls inside the fill.

The action table (memory, max_conc, blackbox per action) comes from the
configuration's `action_table_seed`, not from `--seed`, so that every seed
runs the same set of sizes; the seed draws the order of the rows, their
durations and the flapping invokers.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np


def _phi(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def clipped_lognormal_mean(mu: float, sigma: float, cap: float) -> float:
    """E[min(X, cap)] for X log-normal(mu, sigma)."""
    lc = math.log(cap)
    return (math.exp(mu + sigma * sigma / 2) * _phi((lc - mu - sigma * sigma)
                                                      / sigma)
            + cap * (1.0 - _phi((lc - mu) / sigma)))


class ActionTable:
    """The configuration's actions (names and sizes) and the mix's shares
    of traffic among them."""

    def __init__(self, config: dict, zipf_s: float):
        n = config["actions"]
        rng = np.random.RandomState(config["action_table_seed"])
        weights = np.asarray(config["memory_weights"], float)
        self.mem = rng.choice(config["memory_mb"], n,
                              p=weights / weights.sum()).astype(np.int64)
        lo, hi = config["max_conc_range"]
        self.maxc = np.where(rng.rand(n) < config["concurrent_share"],
                             rng.randint(lo, hi + 1, n), 1).astype(np.int64)
        self.blackbox = rng.rand(n) < config["blackbox_share"]
        p = np.arange(1, n + 1, dtype=float) ** -zipf_s
        self.p = p / p.sum()
        self.cdf = np.cumsum(self.p)
        self.cdf[-1] = 1.0
        ns = config["namespaces"]
        self.namespace = [f"ns{k % ns}" for k in range(n)]
        self.fqn = [f"ns{k % ns}/pkg/action{k}" for k in range(n)]
        # plain lists: the row builders index them once a row
        self.row_args = [(self.namespace[k], self.fqn[k], int(self.mem[k]),
                          int(self.maxc[k]), bool(self.blackbox[k]))
                         for k in range(n)]

    def mean_activation_mb(self) -> float:
        return float((self.p * self.mem / self.maxc).sum())


class Traffic:
    """Every input of one run of a cell, drawn from `seed`."""

    def __init__(self, config: dict, mix: dict, seed: int):
        self.config, self.mix = config, mix
        self.table = ActionTable(config, mix["zipf_s"])
        self.n = config["invokers"]
        self.max_batch = config["max_batch"]
        self.backlog = mix["backlog_rows"]
        self.burst_lo, self.burst_hi = mix["burst_rows"]
        fleet_mb = self.n * config["invoker_memory_mb"]
        self.mean_steps = (mix["occupancy"] * fleet_mb
                           / (self._rows_per_step()
                              * self.table.mean_activation_mb()))
        self.mu = float(mix["duration_log_mu"])
        self.sigma = float(mix["duration_log_sigma"])
        self.timeout = float(mix["timeout_s"])
        #: steps a second of duration lasts
        self.steps_per_s = self.mean_steps / clipped_lognormal_mean(
            self.mu, self.sigma, self.timeout)
        self.cap = max(int(round(self.timeout * self.steps_per_s)), 1)
        # P(delay > r) for r = 0 .. cap - 1: the residuals' law
        r = np.arange(1, self.cap) + 0.5
        z = (np.log(r / self.steps_per_s) - self.mu) / self.sigma
        above = np.concatenate([[1.0], 1.0 - np.vectorize(_phi)(z)])
        self.mean_delay = float(above.sum())
        self.fill_steps = max(int(round(self.mean_delay)), 1)
        self.residual_cdf = np.cumsum(above) / above.sum()
        self.residual_cdf[-1] = 1.0
        self.setup_steps = self.fill_steps + int(mix["warm_steps"])
        self.flap_every = mix["flap_every_steps"]
        self.flap_k = int(round(mix["flap_down_share"] * self.n))
        self.rng = np.random.default_rng(seed)
        self._down = np.zeros(0, np.int64)

    def _burst(self, rng) -> int:
        lo, hi = math.log(self.burst_lo), math.log(self.burst_hi + 1)
        size = int(math.exp(rng.uniform(lo, hi)))
        return min(max(size, self.burst_lo), self.burst_hi)

    def _rows_per_step(self, steps: int = 2000) -> float:
        """Mean rows a step under the queue's rule, from a fixed-seed run
        of the bursts alone (exactly `max_batch` when the backlog holds a
        batch)."""
        if self.backlog >= self.max_batch:
            return float(self.max_batch)
        rng, queued, total = np.random.default_rng(0), 0, 0
        for _ in range(steps):
            while queued < self.backlog:
                queued += self._burst(rng)
            take = min(queued, self.max_batch)
            total, queued = total + take, queued - take
        return total / steps

    def delays(self, step: int, size: int) -> np.ndarray:
        """Completion delays in steps of `size` rows queued before `step`.
        A delay counts from the step that places the row; a fill row's
        brings it to the window's start counted from `step`, so a row of a
        burst that waits a step or two in the queue ends as much later."""
        if step < self.fill_steps:
            res = np.searchsorted(self.residual_cdf, self.rng.random(size),
                                  side="right")
            return (self.fill_steps - step + res).astype(np.int64)
        x = self.rng.lognormal(self.mu, self.sigma, size)
        d = np.rint(np.minimum(x, self.timeout) * self.steps_per_s)
        return np.clip(d, 1, self.cap).astype(np.int64)

    def arrivals(self, step: int, queued: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """(action ids, completion delays in steps) of the bursts that bring
        the queue from `queued` rows to at least the backlog before
        `step`."""
        acts, delays = [], []
        while queued < self.backlog:
            size = self._burst(self.rng)
            acts.append(np.searchsorted(self.table.cdf,
                                        self.rng.random(size), side="right"))
            delays.append(self.delays(step, size))
            queued += size
        if not acts:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return np.concatenate(acts), np.concatenate(delays)

    def flaps(self, step: int) -> List[Tuple[int, bool]]:
        """The health flips queued before `step`: the last flap's invokers
        come back, then fresh ones go down."""
        if step == 0 or step % self.flap_every or not self.flap_k:
            return []
        up = self._down
        healthy = np.setdiff1d(np.arange(self.n), up, assume_unique=True)
        self._down = self.rng.choice(healthy, self.flap_k, replace=False)
        return ([(int(i), True) for i in up]
                + [(int(i), False) for i in self._down])
