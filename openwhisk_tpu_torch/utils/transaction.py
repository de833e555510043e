"""Transaction ids: request-scoped correlation + timing markers.

Rebuilt from the behavior of the reference's TransactionId
(common/scala/.../common/TransactionId.scala:52-164): every request carries a
TransactionId; `started/finished/failed` emit a structured log marker AND a
metric sample in one call, so logs, metrics and traces stay correlated.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Optional

_counter = itertools.count(1)


@dataclass(frozen=True)
class LogMarkerToken:
    """A metric/log marker name: component_action_state (+ optional tags).

    Ref: common/scala/.../common/Logging.scala LogMarkerToken (:299-340).
    """
    component: str
    action: str
    state: str  # "start" | "finish" | "error" | "count"
    tags: tuple = ()

    def to_string(self) -> str:
        return "_".join((self.component, self.action, self.state))

    def as_start(self) -> "LogMarkerToken":
        return LogMarkerToken(self.component, self.action, "start", self.tags)

    def as_finish(self) -> "LogMarkerToken":
        return LogMarkerToken(self.component, self.action, "finish", self.tags)

    def as_error(self) -> "LogMarkerToken":
        return LogMarkerToken(self.component, self.action, "error", self.tags)

    def __str__(self) -> str:
        return self.to_string()


class TransactionId:
    """Correlation id threading a request through controller, bus and invoker.

    System ids mirror the reference's well-known ids
    (TransactionId.scala:169-183): loadbalancer, invokerHealth, etc.
    """

    __slots__ = ("id", "system", "start", "start_wallclock", "_marks")

    def __init__(self, id: Optional[str] = None, system: bool = False,
                 start_wallclock: Optional[float] = None):
        self.id = id if id is not None else f"tid_{next(_counter)}"
        self.system = system
        self.start = time.monotonic()
        self.start_wallclock = start_wallclock if start_wallclock is not None else time.time()
        self._marks: dict[str, float] = {}

    # -- timing markers ----------------------------------------------------
    def started(self, logger, marker: LogMarkerToken, message: str = "") -> float:
        now = time.monotonic()
        self._marks[marker.component + marker.action] = now
        logger.emit("info", self, f"[marker:{marker.as_start()}] {message}")
        logger.metrics.counter(str(marker.as_start()))
        return now

    def finished(self, logger, marker: LogMarkerToken, message: str = "") -> float:
        now = time.monotonic()
        t0 = self._marks.pop(marker.component + marker.action, self.start)
        dt_ms = (now - t0) * 1e3
        logger.emit("info", self, f"[marker:{marker.as_finish()}:{dt_ms:.2f}ms] {message}")
        logger.metrics.histogram(str(marker.as_finish()), dt_ms)
        return dt_ms

    def failed(self, logger, marker: LogMarkerToken, message: str = "") -> float:
        now = time.monotonic()
        t0 = self._marks.pop(marker.component + marker.action, self.start)
        dt_ms = (now - t0) * 1e3
        logger.emit("warn", self, f"[marker:{marker.as_error()}:{dt_ms:.2f}ms] {message}")
        logger.metrics.counter(str(marker.as_error()))
        return dt_ms

    def delta_ms(self) -> float:
        return (time.monotonic() - self.start) * 1e3

    def to_json(self):
        return [self.id, self.start_wallclock]

    @classmethod
    def from_json(cls, j) -> "TransactionId":
        if isinstance(j, list) and j:
            wallclock = float(j[1]) if len(j) > 1 else None
            return cls(str(j[0]), start_wallclock=wallclock)
        return cls(str(j))

    def __repr__(self) -> str:
        return f"#tid_{self.id}"

    def __str__(self) -> str:
        return self.__repr__()


# Well-known system transaction ids (ref TransactionId.scala:169-183)
TransactionId.SYSTEM = TransactionId("sid_system", system=True)
TransactionId.LOADBALANCER = TransactionId("sid_loadbalancer", system=True)
TransactionId.INVOKER_HEALTH = TransactionId("sid_invokerHealth", system=True)
TransactionId.INVOKER_NANNY = TransactionId("sid_invokerNanny", system=True)
TransactionId.CONTROLLER = TransactionId("sid_controller", system=True)
TransactionId.DB_BATCHER = TransactionId("sid_dbBatcher", system=True)
