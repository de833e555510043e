"""Ring buffers of the balancer's host side.

Copies of `RingBuffer`, `SeqRingBuffer` and `ColumnRing` from
`openwhisk_tpu/utils/ring_buffer.py`: plain Python and numpy host code,
carried over unchanged so the port never imports the JAX package.
`RingBuffer` keeps invoker supervision's last N invocation outcomes
(InvokerSupervision.scala:435-443 keeps 10 with error tolerance 3);
`ColumnRing` assembles the packed request and release matrices.
"""
from __future__ import annotations

from collections import deque
from typing import (Callable, Deque, Generic, List, Optional, Tuple,
                    TypeVar)

import numpy as np

T = TypeVar("T")


class RingBuffer(Generic[T]):
    def __init__(self, size: int):
        self._buf: Deque[T] = deque(maxlen=size)
        self.size = size

    def add(self, item: T) -> None:
        self._buf.append(item)

    def to_list(self) -> List[T]:
        return list(self._buf)

    def count(self, predicate: Callable[[T], bool]) -> int:
        return sum(1 for x in self._buf if predicate(x))

    def __len__(self) -> int:
        return len(self._buf)


class SeqRingBuffer(Generic[T]):
    """Pre-sized ring keyed by monotonically increasing sequence number.

    `append` returns (seq, evicted): the sequence assigned to the new item
    and whichever item it overwrote (None while the ring is filling), so the
    caller can keep a by-key index consistent without scanning the ring.
    `get(seq)` answers None once the ring has wrapped past `seq`.
    """

    def __init__(self, size: int):
        if size <= 0:
            raise ValueError("size must be > 0")
        self.size = size
        self._buf: List[Optional[T]] = [None] * size
        self._next_seq = 0

    @property
    def next_seq(self) -> int:
        return self._next_seq

    @property
    def evicted(self) -> int:
        """How many items the ring has wrapped past (dropped from history)."""
        return max(0, self._next_seq - self.size)

    def append(self, item: T) -> Tuple[int, Optional[T]]:
        seq = self._next_seq
        slot = seq % self.size
        old = self._buf[slot]
        self._buf[slot] = item
        self._next_seq = seq + 1
        return seq, old

    def get(self, seq: int) -> Optional[T]:
        if seq < 0 or seq >= self._next_seq or seq < self._next_seq - self.size:
            return None
        return self._buf[seq % self.size]

    def last(self, n: int) -> List[T]:
        """The most recent min(n, len) items, oldest first."""
        lo = max(0, self._next_seq - min(max(n, 0), self.size))
        return [self._buf[s % self.size] for s in range(lo, self._next_seq)]

    def __len__(self) -> int:
        return min(self._next_seq, self.size)


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
