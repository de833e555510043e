"""The step loop that drives a balancer core: the port's `BalancerCore` in
the timed run, the NumPy reference in the replay after it. Both go through
the same loop, so both see the same calls in the same order:

  completions due at this step (`complete`), the health flaps (`set_health`),
  the bursts that refill the queue (`build_row` + `submit`), `step()`, and
  the placed rows' completions booked `delay` steps ahead.

A row's completion delay is drawn with the row, and its completion is
booked from the core's own decision, so each side frees what it placed.

Where the configuration's `clock` is `"traffic"`, both sides get
`set_clock(step / steps_per_s)` before every step, set-up and window
alike: the traffic's own seconds, the time base of the durations. Neither
side reads the wall clock.

A step result may carry `throttled` (bool[b]): a row its core held back.
Such a row carries chosen -1 and books no completion; the loop records
the flags beside the decisions, for the comparison.
"""
from __future__ import annotations

import contextlib
from collections import deque
from typing import Callable, List, Optional, Tuple

import numpy as np

from .traffic import ActionTable, Traffic

_NO_SPAN = contextlib.nullcontext()


def _no_span(name):
    return _NO_SPAN


class StepInputs:
    """What the traffic handed the cores before each step: flips, action
    ids and their delays. The timed run draws and records them; the replay
    reads them back."""

    def __init__(self, traffic: Optional[Traffic] = None):
        self.traffic = traffic
        self.log: List[Tuple[list, np.ndarray, np.ndarray]] = []

    def __call__(self, step: int, queued: int):
        if self.traffic is None:
            return self.log[step]
        got = (self.traffic.flaps(step),
               *self.traffic.arrivals(step, queued))
        self.log.append(got)
        return got

    def replay(self) -> "StepInputs":
        out = StepInputs()
        out.log = self.log
        return out


class Loop:
    """One core under the traffic; `run(steps)` drives steps. `span(name)`
    wraps each group of calls (a profiler range in a traced run). With
    `steps_per_s`, the core's clock is set to the traffic's seconds before
    every step."""

    def __init__(self, core, inputs: StepInputs, table: ActionTable,
                 steps_per_s: Optional[float] = None):
        self.core = core
        self.inputs = inputs
        self.row_args = table.row_args
        self.steps_per_s = steps_per_s
        self.span: Callable = _no_span
        self.due: dict = {}
        self.delays: deque = deque()
        self.queued = 0
        self.step_no = 0
        #: per step: (chosen, forced, rows, rounds, throttled) as the core
        #: returned them; throttled is None where the result has no flags
        self.results: List[tuple] = []
        self.rows_built = 0

    def before_step(self) -> None:
        core, span, s = self.core, self.span, self.step_no
        if self.steps_per_s is not None:
            core.set_clock(s / self.steps_per_s)
        due = self.due.pop(s, None)
        flips, acts, delays = self.inputs(s, self.queued)
        if due:
            with span("complete"):
                for c in due:
                    core.complete(*c)
        if flips:
            with span("flap"):
                for i, v in flips:
                    core.set_health(i, v)
        if len(acts):
            with span("row_build"):
                args = self.row_args
                core.submit([core.build_row(*args[a]) for a in acts.tolist()])
            self.delays.extend(delays.tolist())
            self.queued += len(acts)
            self.rows_built += len(acts)

    def after_step(self, res) -> None:
        s = self.step_no
        chosen = res.chosen
        b = len(chosen)
        self.queued -= b
        with self.span("complete"):
            rows, keys, delays = res.rows, res.slot_keys, self.delays
            slot, mem, maxc = (rows[5].tolist(), rows[4].tolist(),
                               rows[6].tolist())
            due = self.due
            for k, inv in enumerate(chosen.tolist()):
                d = delays.popleft()
                if inv >= 0:
                    due.setdefault(s + d, []).append(
                        (inv, slot[k], mem[k], maxc[k], keys[k]))
        self.results.append((chosen, res.forced, rows,
                             getattr(res, "rounds", 0),
                             getattr(res, "throttled", None)))
        self.step_no += 1

    def run(self, steps: int) -> None:
        """Drive `steps` more steps, untimed."""
        for _ in range(steps):
            self.before_step()
            self.after_step(self.core.step())
