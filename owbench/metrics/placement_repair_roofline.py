"""The schedule kernel's share of its roofline: see
`owbench/counts/placement_repair.py` and `owbench/lib/roofline.py`."""
from owbench.lib.roofline import share


def read(run):
    return share(run, "placement_repair")
