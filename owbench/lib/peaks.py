"""Peaks of one NVIDIA H100 SXM (80 GB HBM3), for the roofline shares.

- `HBM_BYTES_S`: 3.35 TB/s of HBM3 bandwidth, NVIDIA's H100 data sheet
  (SXM part).
- `INT32_OPS_S`: the data sheet gives no int32 rate, so it is derived from
  NVIDIA's Hopper architecture whitepaper (GH100): an SM has four
  partitions of 16 INT32 lanes, 64 lanes; the SXM5 part has 132 SMs; its
  boost clock is 1.98 GHz (the clock at which the whitepaper's 66.9
  TFLOP/s of float32 is 16,896 lanes x 2 x 1.98 GHz). So 64 x 132 x
  1.98e9 = 16.73e12 int32 instructions a second. The whitepaper's own
  "INT32 TOPS" counts a multiply-add as two; one instruction a counted
  operation is the rate that bounds a kernel's time from below.

Both assume the card at its full power limit (700 W); a run records the
card's limit beside its numbers.
"""
HBM_BYTES_S = 3.35e12
INT32_LANES_PER_SM = 64
SMS = 132
BOOST_CLOCK_HZ = 1.98e9
INT32_OPS_S = INT32_LANES_PER_SM * SMS * BOOST_CLOCK_HZ


def least_seconds(ops: float, nbytes: float):
    """(seconds, bound): the least time the card could take for `ops` int32
    operations and `nbytes` moved, and which of the two bounds it."""
    t_ops, t_bytes = ops / INT32_OPS_S, nbytes / HBM_BYTES_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
