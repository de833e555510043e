"""Run one cell of the benchmark of `openwhisk_tpu_torch` on the card:

    python3 owbench/run.py --workload <name> --seed <n> --seconds <s>
                           --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (JSON); the numbers that decided `correct` close standard error.
Without enough CUDA cards, or with JAX or the JAX package loaded once the
window has closed, it prints no result and exits non-zero.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: module names whose presence means the run loaded JAX or the JAX package
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "openwhisk_tpu"})


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # kernel caches at fixed paths inside the checkout (build/ is ignored)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / "owbench" / sub)
    sys.path.insert(0, str(ROOT))
    from owbench.lib.manifest import Manifest

    cell = Manifest(ROOT).cell(args.workload)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"owbench: {args.workload} needs {cell.chips} CUDA card(s), "
              f"found {have}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    from owbench.lib.cell import run_cell

    out = run_cell(ROOT, args.workload, args.seed, args.seconds,
                   bool(args.trace), t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"owbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
