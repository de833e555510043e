"""owdebug: incident-bundle explorer + journal time-travel debugger CLI.
The port's copy of the repository's `tools/owdebug.py`.

The operator half of the incident plane (the programmatic API is
`controller/loadbalancer/timetravel.py`; the capture side is
`utils/blackbox.py`; triage order is docs/runbook.md):

    # what did the recorder freeze?
    python -m openwhisk_tpu_torch.tools.owdebug list  /tmp/whisk-incidents-1234
    python -m openwhisk_tpu_torch.tools.owdebug info  /tmp/.../inc-XXXX-0001.wbb

    # deterministic replay of a bundle's journal window (or a raw
    # journal directory), with stepping and breakpoints
    python -m openwhisk_tpu_torch.tools.owdebug replay inc-XXXX-0001.wbb
    python -m openwhisk_tpu_torch.tools.owdebug replay inc-XXXX-0001.wbb --to-seq 1700
    python -m openwhisk_tpu_torch.tools.owdebug replay inc-XXXX-0001.wbb --break-aid <aid>
    python -m openwhisk_tpu_torch.tools.owdebug replay /path/to/journal-dir --step-log
    python -m openwhisk_tpu_torch.tools.owdebug replay /path/to/journal-dir --device cpu

`replay` on a bundle finishes with `diff_books`: the re-derived books
against the books the bundle froze at capture time — `match: true` is the
determinism receipt, anything else is incident evidence. Exit code 1 when
the diff mismatches or replay found parity mismatches (scriptable, like
bench_compare).

Replay runs on an OFFLINE balancer on the CUDA card unless `--device cpu`
asks for the plain torch path (placement is bit-deterministic across the
card's kernels and their plain versions, so a journal written on the card
replays on a laptop). Without a card the default exits 2 with the reason.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys


def _print(obj) -> None:
    print(json.dumps(obj, indent=2, default=str))


def cmd_list(args) -> int:
    from openwhisk_tpu_torch.utils.blackbox import read_bundle, _summary
    directory = args.path
    names = sorted(n for n in os.listdir(directory)
                   if n.startswith("inc-") and n.endswith(".wbb"))
    rows = []
    for name in names:
        payload = read_bundle(os.path.join(directory, name))
        rows.append(_summary(payload) if payload is not None
                    else {"id": name[:-4], "error": "unreadable/corrupt"})
    _print(rows)
    return 0


def cmd_info(args) -> int:
    from openwhisk_tpu_torch.utils.blackbox import read_bundle, _summary
    payload = read_bundle(args.path)
    if payload is None:
        print(f"owdebug: not a readable incident bundle: {args.path}",
              file=sys.stderr)
        return 2
    if args.plane:
        plane = (payload.get("planes") or {}).get(args.plane)
        if plane is None:
            print(f"owdebug: bundle has no plane {args.plane!r} "
                  f"(has: {sorted((payload.get('planes') or {}))})",
                  file=sys.stderr)
            return 2
        _print(plane)
    else:
        _print(_summary(payload))
    return 0


async def _replay(args) -> int:
    from openwhisk_tpu_torch.controller.loadbalancer.timetravel import \
        JournalDebugger
    if os.path.isdir(args.path):
        dbg = JournalDebugger.from_directory(args.path,
                                            after_seq=args.after_seq,
                                            kernel=args.kernel,
                                            device=args.device)
    else:
        dbg = JournalDebugger.from_bundle(args.path, kernel=args.kernel,
                                          device=args.device)
    rc = 0
    try:
        stop = None
        if args.break_aid:
            stop = dbg.run_to_activation(args.break_aid)
            if stop is None:
                print(f"owdebug: activation {args.break_aid} was not "
                      "placed in this window", file=sys.stderr)
                rc = 1
            else:
                print(f"# break: batch seq={stop['seq']} placed "
                      f"{args.break_aid}")
                _print({"stop": stop, "decisions": dbg.decisions(),
                        "books": dbg.books()})
        elif args.to_seq is not None:
            stop = dbg.run_to_seq(args.to_seq)
            if stop is None:
                print(f"owdebug: window ended before seq {args.to_seq}",
                      file=sys.stderr)
                rc = 1
            else:
                print(f"# stopped at seq={stop['seq']} ({stop['t']})")
                _print({"stop": stop, "decisions": dbg.decisions(),
                        "books": dbg.books()})
        stats = dbg.run_to_end()
        if args.step_log:
            _print(dbg.history)
        out = {"stats": stats}
        if dbg.captured_books is not None:
            out["diff_books"] = dbg.diff_books()
            if not out["diff_books"].get("match"):
                rc = 1
        if stats.get("parity_mismatches"):
            rc = 1
        _print(out)
    finally:
        await dbg.aclose()
    return rc


def cmd_replay(args) -> int:
    from openwhisk_tpu_torch.ops.placement import resolve_device
    # "cuda" is the default: None, which raises without a card
    args.device = None if args.device == "cuda" else args.device
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"owdebug: {e}", file=sys.stderr)
        return 2
    return asyncio.run(_replay(args))


def main() -> int:
    ap = argparse.ArgumentParser(prog="owdebug", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("list", help="summarize every bundle in a directory")
    p.add_argument("path", help="incident bundle directory")
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser("info", help="one bundle's summary or one plane")
    p.add_argument("path", help="bundle file (.wbb)")
    p.add_argument("--plane", help="print this captured plane verbatim "
                                   "(alerts, anomaly_scores, telemetry_slo, "
                                   "waterfall, flight_recorder, host, "
                                   "traces, events, journal, books)")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("replay",
                       help="time-travel replay of a bundle's journal "
                            "window (or a journal directory)")
    p.add_argument("path", help="bundle file (.wbb) or journal directory")
    p.add_argument("--to-seq", type=int, default=None,
                   help="stop after applying this seq; print books + "
                        "decisions there")
    p.add_argument("--break-aid", default=None,
                   help="stop at the batch that placed this activation id")
    p.add_argument("--after-seq", type=int, default=0,
                   help="journal-directory mode: replay seq > this")
    p.add_argument("--step-log", action="store_true",
                   help="print every applied step's summary")
    p.add_argument("--kernel", choices=("scan", "repair", "auto"),
                   default=None,
                   help="pin the replay's placement kernel (default: auto)")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="where the replay runs: the CUDA card (default) or "
                        "the plain torch path on the CPU")
    p.set_defaults(fn=cmd_replay)

    args = ap.parse_args()
    return args.fn(args)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        # `owdebug ... | head` closes our stdout mid-dump; that is the
        # reader saying "enough", not an error
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
