"""Each kernel's counts on a case worked by hand, and the peaks they are
held against."""
from conftest import BENCH
from owbench.lib import peaks
from owbench.lib.manifest import load_module

REPAIR = load_module(BENCH / "counts" / "placement_repair.py", "c_repair")
RELEASE = load_module(BENCH / "counts" / "release_fold.py", "c_release")


def test_int32_peak_is_lanes_times_sms_times_clock():
    assert peaks.INT32_OPS_S == 64 * 132 * 1.98e9
    assert abs(peaks.INT32_OPS_S - 16.727e12) < 1e9
    assert peaks.HBM_BYTES_S == 3.35e12


def test_repair_counts_by_hand():
    # 8 rows: 50 probes in all, one forced row with 3 rotation keys; the
    # probes cover 30 invokers, the rotation 2 more; 12 permit cells; 5
    # cells changed
    step = {"width": 8, "schedule": {
        "rows": 8, "probes": 50, "rotation_keys": 3, "probe_columns": 30,
        "rotation_columns": 2, "permit_cells": 12, "cells_changed": 5}}
    ops, nbytes = REPAIR.work(step)
    assert ops == 53
    assert nbytes == 9 * 4 * 8 + 5 * 30 + 2 + 4 * 12 + 8 * 8 + 4 * 5


def test_repair_counts_do_not_depend_on_rounds():
    step = {"width": 8, "schedule": {
        "rows": 8, "probes": 80, "rotation_keys": 0, "probe_columns": 10,
        "rotation_columns": 0, "permit_cells": 10, "cells_changed": 1}}
    assert REPAIR.work(dict(step, rounds=1)) == REPAIR.work(
        dict(step, rounds=9))


def test_release_counts_by_hand():
    # 3 valid rows padded to 8; 2 free cells and 1 permit cell read, 2
    # cells changed
    step = {"width": 8, "release": {
        "rows": 3, "conc_rows": 1, "free_cells_read": 2,
        "conc_cells_read": 1, "cells_changed": 2, "backlog": 0}}
    ops, nbytes = RELEASE.work(step)
    assert ops == 3
    assert nbytes == 17 * 3 + 4 * 2 + 4 * 1 + 4 * 2


def test_least_time_names_its_bound():
    t, bound = peaks.least_seconds(1e6, 1e3)
    assert bound == "operations" and t == 1e6 / peaks.INT32_OPS_S
    t, bound = peaks.least_seconds(1, 3.35e6)
    assert bound == "bytes" and abs(t - 1e-6) < 1e-15


def test_reference_records_the_work_it_counts():
    """The reference's record of a step, on a fleet of 20 invokers (18
    managed, 2 blackbox) with three rows and no releases: two rows of one
    managed action, whose home fits both, and a blackbox row with permits
    whose home is down, so it probes two invokers."""
    from owbench.reference.sharding import Reference
    ref = Reference([1024] * 20, managed_fraction=0.9,
                    blackbox_fraction=0.1, max_batch=8, action_slots=4)
    ref.keep_work = True
    rows = [ref.build_row("ns", "ns/a", 256, 1, False),
            ref.build_row("ns", "ns/a", 256, 1, False),
            ref.build_row("ns", "ns/b", 256, 4, True)]
    bb_home = rows[2][0][0] + rows[2][0][2]
    ref.set_health(bb_home, False)
    ref.submit(rows)
    res = ref.step()
    assert (res.chosen >= 0).all() and not res.forced.any()
    assert res.chosen[0] == res.chosen[1] == rows[0][0][2]
    w = ref.work[0]
    assert w["width"] == 8
    s = w["schedule"]
    assert (s["rows"], s["probes"], s["rotation_keys"]) == (3, 4, 0)
    assert (s["probe_columns"], s["rotation_columns"]) == (3, 0)
    # the blackbox row's slot over its two probed invokers
    assert s["permit_cells"] == 2
    # the managed home's free memory; the blackbox invoker's free memory
    # and its new container's permits
    assert s["cells_changed"] == 3
    assert w["release"]["rows"] == 0


def test_a_forced_row_counts_its_rotation():
    """A managed slice with no room: the row probes all 18 invokers, then
    rotates from its random start to the first healthy one."""
    from owbench.reference.sharding import Reference
    ref = Reference([128] * 20, managed_fraction=0.9,
                    blackbox_fraction=0.1, max_batch=8, action_slots=4)
    ref.keep_work = True
    row = ref.build_row("ns", "ns/a", 256, 1, False)
    rand = row[0][7]
    ref.set_health(rand, False)
    ref.submit([row])
    res = ref.step()
    assert res.forced[0] and res.chosen[0] == (rand + 1) % 18
    s = ref.work[0]["schedule"]
    assert (s["probes"], s["rotation_keys"]) == (18, 2)
    assert (s["probe_columns"], s["rotation_columns"]) == (18, 0)
