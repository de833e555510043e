"""Journal time-travel debugger: step-through replay with breakpoints.
A copy of `openwhisk_tpu/controller/loadbalancer/timetravel.py` with a
`device` for its offline balancer and its books read from torch tensors.

Placement is deterministic and journaled (`replay_journal` re-derives the
dead active's books bit-exactly); this module turns that replay into a
DEBUGGER. `replay_stepper` (tpu_balancer.py) already yields one step per
applied record — this module drives it interactively:

  * `step(n)` — apply the next n records,
  * `run_to_seq(K)` — apply through seq K and stop,
  * `run_to_activation(aid)` — stop at the batch that placed `aid`
    (batch journal records carry their `aids`),
  * `books()` / `decisions()` — inspect the re-derived capacity books and
    the last batch's derived-vs-recorded decision vectors at ANY stop,
  * `diff_books(captured)` — compare the replayed state against the
    books an incident bundle (utils/blackbox.py) froze at capture time:
    replay divergence is incident evidence (a kernel-knob change across
    a restart, mid-history corruption, a non-deterministic kernel).

The debugger owns an OFFLINE balancer (the test_journal idiom: a fresh
TpuBalancer over a MemoryMessagingProvider that never serves traffic) and
replays onto it, so a live controller is never touched. Construction and
stepping are synchronous; only the balancer teardown is async
(`aclose()`), matching the balancer's own lifecycle. The offline balancer
replays on the CUDA card unless the caller asks for `device="cpu"` (the
plain torch path: a journal written on the card replays there bit for
bit). `python -m openwhisk_tpu_torch.tools.owdebug` is the CLI over this
API.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from ...utils.blackbox import read_bundle


def _host(x) -> np.ndarray:
    """A books tensor (either device) or array as a host numpy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def make_offline_balancer(kernel: Optional[str] = None, logger=None,
                          instance: str = "0", device=None):
    """A traffic-free TpuBalancer to replay onto (owns no topics, serves
    no activations; `managed_fraction=1.0` mirrors the journal writers).
    `kernel` pins the placement kernel (scan|repair|auto); `device` None
    means the CUDA card, "cpu" the plain torch path."""
    from ...core.entity import ControllerInstanceId
    from ...messaging import MemoryMessagingProvider
    from .tpu_balancer import TpuBalancer
    kw: Dict[str, Any] = {"device": device}
    if kernel:
        kw["placement_kernel"] = kernel
    if logger is not None:
        kw["logger"] = logger
    return TpuBalancer(MemoryMessagingProvider(),
                       ControllerInstanceId(instance),
                       managed_fraction=1.0, blackbox_fraction=0.0, **kw)


def _step_summary(step: dict) -> dict:
    """JSON-safe row for step history / CLI printing."""
    detail = step.get("detail") or {}
    out = {"seq": step["seq"], "t": step["t"]}
    if step["t"] == "batch":
        out["b"] = detail.get("b")
        out["aids"] = list(detail.get("aids") or ())
        out["acked"] = detail.get("acked", False)
        out["mismatches"] = detail.get("mismatches", 0)
    return out


class JournalDebugger:
    """Step-through replay session over one journal window (module doc).

    The underlying generator holds `_journal_mute` on the offline
    balancer for the whole session; `close()` (or exhausting the replay)
    runs the stepper's finalization — always close a session you abandon
    early, or the balancer's host books are never refreshed."""

    def __init__(self, records: Iterable[dict], balancer=None,
                 logger=None, from_seq: Optional[int] = None,
                 captured_books: Optional[dict] = None,
                 kernel: Optional[str] = None, device=None):
        self.balancer = (balancer if balancer is not None
                         else make_offline_balancer(kernel=kernel,
                                                    logger=logger,
                                                    device=device))
        self._owns_balancer = balancer is None
        self.captured_books = captured_books
        self.stats: Dict[str, Any] = {}
        self.records = list(records)
        self._stepper = self.balancer.replay_stepper(
            self.records, logger=logger, from_seq=from_seq,
            stats=self.stats)
        #: summaries of every applied step, in order
        self.history: List[dict] = []
        #: the last applied step, full detail (numpy vectors included)
        self.current: Optional[dict] = None
        self.done = False

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_directory(cls, path: str, after_seq: int = 0,
                       **kw) -> "JournalDebugger":
        """Replay a journal directory's tail (seq > after_seq)."""
        from .journal import PlacementJournal
        journal = PlacementJournal(path)
        try:
            records = list(journal.records(after_seq))
        finally:
            journal.close()
        return cls(records, from_seq=after_seq or None, **kw)

    @classmethod
    def from_bundle(cls, bundle, **kw) -> "JournalDebugger":
        """Replay an incident bundle's embedded journal window; the
        bundle's captured books become the diff baseline. `bundle` is a
        payload dict or a path to a `.wbb` file."""
        if isinstance(bundle, str):
            payload = read_bundle(bundle)
            if payload is None:
                raise ValueError(f"not a readable incident bundle: "
                                 f"{bundle}")
            bundle = payload
        planes = bundle.get("planes") or {}
        window = planes.get("journal") or {}
        records = window.get("records") or []
        from_seq = window.get("from_seq")
        return cls(records,
                   from_seq=int(from_seq) if from_seq else None,
                   captured_books=planes.get("books"), **kw)

    # -- stepping ----------------------------------------------------------
    @property
    def position(self) -> int:
        """Seq of the last applied record (stats from_seq before any)."""
        if self.current is not None:
            return int(self.current["seq"])
        return int(self.stats.get("from_seq", 0) or 0)

    def _advance(self) -> Optional[dict]:
        if self.done:
            return None
        try:
            step = next(self._stepper)
        except StopIteration:
            self.done = True
            return None
        self.current = step
        self.history.append(_step_summary(step))
        return step

    def step(self, n: int = 1) -> List[dict]:
        """Apply the next `n` records; returns their summaries (empty at
        end of window)."""
        out = []
        for _ in range(max(0, int(n))):
            step = self._advance()
            if step is None:
                break
            out.append(self.history[-1])
        return out

    def run_to_seq(self, seq: int) -> Optional[dict]:
        """Apply records THROUGH seq (state includes seq's mutation);
        returns the stop step's summary, None when the window ends
        first."""
        while True:
            step = self._advance()
            if step is None:
                return None
            if int(step["seq"]) >= int(seq):
                return self.history[-1]

    def run_to_activation(self, activation_id: str) -> Optional[dict]:
        """Break on the batch record that placed `activation_id`; the
        stopped state has that batch applied. None = never placed in this
        window."""
        aid = str(activation_id)
        while True:
            step = self._advance()
            if step is None:
                return None
            detail = step.get("detail") or {}
            if step["t"] == "batch" and aid in (detail.get("aids") or ()):
                return self.history[-1]

    def run_to_end(self) -> dict:
        """Apply everything left; returns the replay stats
        (replayed/batches/parity_mismatches/last_seq)."""
        while self._advance() is not None:
            pass
        return dict(self.stats)

    # -- inspection --------------------------------------------------------
    def books(self) -> List[int]:
        """The re-derived free-capacity books (MB per invoker row) at the
        current stop. Device pull — never call from an event loop."""
        return _host(self.balancer.state.free_mb).tolist()

    def decisions(self) -> Optional[dict]:
        """Derived-vs-recorded decision vectors of the last applied batch
        (None when the last step was structural or nothing applied)."""
        if self.current is None or self.current["t"] != "batch":
            return None
        d = dict(self.current.get("detail") or {})
        for k in ("derived", "recorded", "throttled"):
            if k in d:
                d[k] = _host(d[k]).tolist()
        return d

    def diff_books(self, captured: Optional[dict] = None) -> dict:
        """Replayed books vs a captured snapshot (the bundle's `books`
        plane by default). Rows beyond either side's pad are zero-capacity
        padding and compare as 0."""
        captured = captured if captured is not None else self.captured_books
        if not captured:
            return {"error": "no captured books to diff against"}
        replayed = _host(self.balancer.state.free_mb).astype(
            np.int64).ravel()
        frozen = np.asarray(captured.get("free_mb") or [],
                            np.int64).ravel()
        n = max(len(replayed), len(frozen))
        r = np.zeros(n, np.int64)
        c = np.zeros(n, np.int64)
        r[:len(replayed)] = replayed
        c[:len(frozen)] = frozen
        bad = np.nonzero(r != c)[0]
        conc = _host(self.balancer.state.conc_free)
        nz = {(int(i), int(j)): int(conc[i, j])
              for i, j in zip(*np.nonzero(conc))}
        frozen_nz = {(int(i), int(j)): int(v)
                     for i, j, v in captured.get("conc_nonzero") or ()}
        conc_mismatches = sum(
            1 for k in set(nz) | set(frozen_nz)
            if nz.get(k, 0) != frozen_nz.get(k, 0))
        return {
            "rows_compared": n,
            "free_mb_mismatches": [[int(i), int(r[i]), int(c[i])]
                                   for i in bad[:64]],
            "free_mb_mismatch_rows": int(len(bad)),
            "conc_mismatches": int(conc_mismatches),
            "parity_mismatches": int(
                self.stats.get("parity_mismatches", 0)),
            "replayed_seq": self.position,
            "captured_seq": captured.get("journal_seq"),
            "match": bool(len(bad) == 0 and conc_mismatches == 0),
        }

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        """End the session: runs the stepper's finalization (journal
        un-mute + host-books refresh) without applying further records."""
        self._stepper.close()
        self.done = True

    async def aclose(self) -> None:
        """close() plus teardown of a debugger-owned offline balancer."""
        self.close()
        if self._owns_balancer:
            await self.balancer.close()
