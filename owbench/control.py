"""The control of the check that decides `correct`, at a cell's own size.

    python3 owbench/control.py --workload <name> --steps <n>
                               --seeds <s1> <s2> ...

For each seed it draws the cell's inputs for `steps` steps (a run's fill
and window), replays them through the configuration's exact reference,
and puts the control in the program's place: the same reference with its
sequential guarantee broken (every row of a step sees the books of the
step's start). It prints, a line a seed, the numbers `correct` compares
as the control reads them; a check that cannot tell the control from the
program would read 0 in each.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seed: int, steps: int) -> dict:
    from owbench.lib.check import compare_books, compare_steps
    from owbench.lib.drive import Loop, StepInputs
    from owbench.lib.traffic import Traffic

    fleet, kw = cell.fleet, cell.side_kwargs()
    Reference = cell.reference_class()
    traffic = Traffic(cell.config, cell.mix, seed)
    clock = traffic.steps_per_s if cell.clock == "traffic" else None
    inputs = StepInputs(traffic)
    control = Loop(Reference(fleet, sequential=False, **kw), inputs,
                   traffic.table, clock)
    control.run(steps)
    exact = Loop(Reference(fleet, **kw), inputs.replay(), traffic.table,
                 clock)
    exact.run(steps)
    out = compare_steps(control.results, exact.results)
    c_books = control.core.books()
    out["book_cells_differ"] = compare_books(c_books, exact.core.books())
    out["forced"] = sum(int(r[1].sum()) for r in exact.results)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--steps", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from owbench.lib.manifest import Manifest

    cell = Manifest(ROOT).cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = readings(cell, seed, args.steps)
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              steps=args.steps, seconds=time.perf_counter()
                              - t0, **got)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
