"""Column ring for the balancer core's batch assembly.

A copy of `ColumnRing` from `openwhisk_tpu/utils/ring_buffer.py`: numpy
host code, carried over unchanged so the port never imports the JAX
package.
"""
from __future__ import annotations

import numpy as np


class ColumnRing:
    """Growable circular store of fixed-height int32 columns.

    Each enqueue writes its column straight into a preallocated
    `int32[rows, cap]` buffer, and a flush drains the k oldest columns with
    at most two contiguous slice copies.

    Not thread-safe: one owner reads and writes it.
    """

    __slots__ = ("buf", "head", "count")

    def __init__(self, rows: int, cap: int):
        self.buf = np.zeros((rows, max(8, cap)), np.int32)
        self.head = 0
        self.count = 0

    def push(self, col) -> None:
        """Append one column (any length-`rows` int sequence)."""
        cap = self.buf.shape[1]
        if self.count == cap:
            self._grow()
            cap = self.buf.shape[1]
        self.buf[:, (self.head + self.count) % cap] = col
        self.count += 1

    def push_block(self, block) -> None:
        """Append `block.shape[1]` columns in at most two contiguous slice
        copies. `block` is int-like [rows, k]."""
        k = int(block.shape[1])
        if k == 0:
            return
        while self.count + k > self.buf.shape[1]:
            self._grow()
        cap = self.buf.shape[1]
        start = (self.head + self.count) % cap
        first = min(k, cap - start)
        self.buf[:, start:start + first] = block[:, :first]
        if k > first:
            self.buf[:, :k - first] = block[:, first:]
        self.count += k

    def pop_into(self, out, k: int) -> None:
        """Copy the k oldest columns into out[:, :k] (out may carry fewer
        rows than the ring: extra ring rows are dropped) and consume them."""
        if not 0 <= k <= self.count:
            raise ValueError(f"cannot pop {k} of {self.count} columns")
        rows = out.shape[0]
        cap = self.buf.shape[1]
        first = min(k, cap - self.head)
        out[:, :first] = self.buf[:rows, self.head:self.head + first]
        if k > first:
            out[:, first:k] = self.buf[:rows, :k - first]
        self.head = (self.head + k) % cap
        self.count -= k

    def clear(self) -> None:
        self.head = 0
        self.count = 0

    def _grow(self) -> None:
        """Double capacity, re-linearizing so head restarts at 0."""
        cap = self.buf.shape[1]
        new = np.zeros((self.buf.shape[0], cap * 2), np.int32)
        first = cap - self.head
        new[:, :first] = self.buf[:, self.head:]
        new[:, first:cap] = self.buf[:, :self.head]
        self.buf = new
        self.head = 0

    def __len__(self) -> int:
        return self.count
