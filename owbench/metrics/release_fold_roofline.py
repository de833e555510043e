"""The release kernel's share of its roofline: see
`owbench/counts/release_fold.py` and `owbench/lib/roofline.py`."""
from owbench.lib.roofline import share


def read(run):
    return share(run, "release_fold")
