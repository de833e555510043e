"""The schedule's work in one step, for `placement_repair_roofline`.

The work is what the exact sequential algorithm needs on the step's rows,
so it is the same whether the scan or the repair kernel implements it, and
it does not depend on the repair's rounds:

- operations: one int32 operation a key: each valid row's probes of its
  walk up to the first invoker that can take it, and a forced row's
  rotation keys up to the first healthy invoker;
- bytes: each input byte once when read: the valid rows of the request
  matrix (9 int32 a row), free memory (int32) and health (one byte) over
  the union of the probed invokers, health alone over the rest of the
  rotations, and the permits (int32) of each slot over the union of its
  rows' probes where the action has permits; each output once when
  written: chosen and forced (int32 each a valid row) and every book cell
  the schedule changed (int32).

`step` is one step's record from the reference's replay (`work`).
"""
KERNEL = "placement_repair_kernel"


def work(step: dict):
    s = step["schedule"]
    ops = s["probes"] + s["rotation_keys"]
    nbytes = (9 * 4 * s["rows"] + 5 * s["probe_columns"]
              + s["rotation_columns"] + 4 * s["permit_cells"]
              + 8 * s["rows"] + 4 * s["cells_changed"])
    return ops, nbytes
