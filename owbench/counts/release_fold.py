"""The release fold's work in one step, for `release_fold_roofline`.

- operations: one int32 operation a valid release row (its add);
- bytes: each input byte once when read: the release rows (invoker, slot,
  memory, max_conc as int32 and a valid byte, 17 bytes a valid row; the
  launch's padding carries nothing), the free-memory cells and the permit cells the rows
  touch (int32 each); each output once when written: every book cell the
  fold changed (int32).

`step` is one step's record from the reference's replay (`work`).
"""
KERNEL = "release_fold_kernel"


def work(step: dict):
    r = step["release"]
    ops = r["rows"]
    nbytes = (17 * r["rows"] + 4 * r["free_cells_read"]
              + 4 * r["conc_cells_read"] + 4 * r["cells_changed"])
    return ops, nbytes
