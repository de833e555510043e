"""The comparison that decides `correct`: the port's run against the NumPy
reference's replay of the same inputs.

Every number compared is a count of disagreements, and every limit is 0:
the placement policy is exact integer arithmetic on integer books, so any
difference is a wrong answer (see PERF.md for the readings behind each).

- `rows_differ`: request rows whose nine packed columns (slice, home, the
  probe step's inverse, memory, concurrency slot, max_conc, the forced
  rotation, valid) differ from the rows the reference built;
- `decisions_differ`: rows whose chosen invoker, forced flag or throttled
  flag differ, in every step of the run, set-up and window alike (a side
  whose results carry no `throttled` throttles no row);
- `book_cells_differ`: cells of the books (free memory, concurrency
  permits, health) that differ once the window has closed, the padding
  beyond the fleet included, which has to stay empty.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

LIMITS = {"rows_differ": 0, "decisions_differ": 0, "book_cells_differ": 0}


def compare_steps(program: List[tuple], reference: List[tuple]) -> Dict:
    """Counts of rows and decisions that differ, step by step: (chosen,
    forced, rows, rounds, throttled) on each side."""
    rows_differ = decisions_differ = 0
    for k in range(max(len(program), len(reference))):
        if k >= len(program) or k >= len(reference):
            side = program[k] if k < len(program) else reference[k]
            rows_differ += len(side[0])
            decisions_differ += len(side[0])
            continue
        (pc, pf, pr, *_), (rc, rf, rr, *_) = program[k], reference[k]
        if pc.shape != rc.shape:
            n = max(len(pc), len(rc))
            rows_differ += n
            decisions_differ += n
            continue
        rows_differ += int((np.asarray(pr) != rr).any(axis=0).sum())
        differ = (pc != rc) | (pf != rf)
        pt, rt = _throttled(program[k]), _throttled(reference[k])
        if pt is not None or rt is not None:
            pt = np.zeros(len(pc), bool) if pt is None else pt
            rt = np.zeros(len(rc), bool) if rt is None else rt
            differ |= pt != rt if pt.shape == rt.shape == pc.shape else True
        decisions_differ += int(differ.sum())
    return {"rows_differ": rows_differ, "decisions_differ": decisions_differ}


def _throttled(step: tuple):
    flags = step[4] if len(step) > 4 else None
    return None if flags is None else np.asarray(flags, bool)


def compare_books(program, reference) -> int:
    """Cells of the books that differ: the program's (free[N_pad],
    conc[A, N_pad], health[N_pad]) against the reference's over the n
    invokers, with the padding beyond them held to zero and unhealthy."""
    (pf, pc, ph), (rf, rc, rh) = program, reference
    n = len(rf)
    if pc.shape[0] != rc.shape[0] or len(pf) < n:
        return int(pc.size + pf.size + ph.size)
    return int((pf[:n] != rf).sum() + (pf[n:] != 0).sum()
               + (ph[:n] != rh).sum() + ph[n:].sum()
               + (pc[:, :n] != rc).sum() + (pc[:, n:] != 0).sum())


def verdict(readings: Dict[str, int]) -> bool:
    return all(readings[k] <= lim for k, lim in LIMITS.items())
