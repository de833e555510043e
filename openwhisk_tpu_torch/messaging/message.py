"""The wire protocol between controller and invokers.

A copy of `openwhisk_tpu/messaging/message.py` (rebuild of
common/scala/.../core/connector/Message.scala), byte for byte on the wire,
so a balancer of this package and an invoker of the JAX package read each
other's messages:
  ActivationMessage (:51-120)  controller -> invoker: run this activation
  AcknowledgementMessage hierarchy (:180-268) invoker -> controller:
    ResultMessage                    result only (blocking fast path)
    CompletionMessage                slot released (+ system-error flag)
    CombinedCompletionAndResultMessage  both in one (non-blocking or when
                                       logs are already collected)
    with `shrink` to keep oversized results under the bus payload cap
  PingMessage (:124-131)       invoker -> controller health topic, 1 Hz
  EventMessage (:291-427)      user-facing metrics/activation events topic
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, Optional, Union

from ..core.entity import (ActivationId, ControllerInstanceId, Identity,
                           InvokerInstanceId, WhiskActivation)
from ..core.entity.names import FullyQualifiedEntityName
from ..utils.transaction import TransactionId


class Message:
    def serialize(self) -> bytes:
        return json.dumps(self.to_json(), separators=(",", ":")).encode()

    def to_json(self) -> dict:
        raise NotImplementedError


class ActivationMessage(Message):
    def __init__(self, transid: TransactionId, action: FullyQualifiedEntityName,
                 revision: Optional[str], user: Identity,
                 activation_id: ActivationId,
                 root_controller_index: ControllerInstanceId,
                 blocking: bool, content: Optional[Dict[str, Any]] = None,
                 init_args: Optional[Dict[str, Any]] = None,
                 cause: Optional[ActivationId] = None,
                 trace_context: Optional[Dict[str, str]] = None,
                 fence_epoch: Optional[int] = None,
                 fence_part: Optional[int] = None):
        self.transid = transid
        self.action = action
        self.revision = revision
        self.user = user
        self.activation_id = activation_id
        self.root_controller_index = root_controller_index
        self.blocking = blocking
        self.content = content
        self.init_args = init_args or {}
        self.cause = cause
        self.trace_context = trace_context
        #: HA fencing: the placement leadership epoch of the controller
        #: that dispatched this. None (the default, and the whole non-HA
        #: path) means unfenced and keeps the field off the wire.
        self.fence_epoch = fence_epoch
        #: active/active partitions: the ring partition this activation's
        #: namespace hashes to (None outside that mode, off the wire).
        self.fence_part = fence_part

    def to_json(self) -> dict:
        out = {
            "transid": self.transid.to_json(),
            "action": str(self.action),
            "revision": self.revision,
            "user": self.user.to_json(),
            "activationId": self.activation_id.to_json(),
            "rootControllerIndex": self.root_controller_index.name,
            "blocking": self.blocking,
            "content": self.content,
            "initArgs": self.init_args,
            "cause": self.cause.to_json() if self.cause else None,
            "traceContext": self.trace_context,
        }
        if self.fence_epoch is not None:
            out["fenceEpoch"] = self.fence_epoch
        if self.fence_part is not None:
            out["fencePart"] = self.fence_part
        return out

    @classmethod
    def from_json(cls, j: dict) -> "ActivationMessage":
        return cls(
            TransactionId.from_json(j["transid"]),
            FullyQualifiedEntityName.parse(j["action"]),
            j.get("revision"),
            Identity.from_json(j["user"]),
            ActivationId(j["activationId"]),
            ControllerInstanceId(j.get("rootControllerIndex", "0")),
            bool(j.get("blocking", False)),
            j.get("content"),
            j.get("initArgs") or {},
            ActivationId(j["cause"]) if j.get("cause") else None,
            j.get("traceContext"),
            j.get("fenceEpoch"),
            j.get("fencePart"),
        )

    @classmethod
    def parse(cls, raw: Union[bytes, str]) -> "ActivationMessage":
        return cls.from_json(json.loads(raw))


class AcknowledgementMessage(Message):
    """Base for invoker->controller acks (Message.scala:180-268).

    `is_slot_free` — carries a slot release for the load balancer;
    `activation_result` — carries the result for a waiting client.
    """
    kind = ""

    def __init__(self, transid: TransactionId, activation_id: ActivationId,
                 invoker: Optional[InvokerInstanceId] = None,
                 is_system_error: bool = False,
                 activation: Optional[WhiskActivation] = None):
        self.transid = transid
        self.activation_id = activation_id
        self.invoker = invoker
        self.is_system_error = is_system_error
        self.activation = activation
        #: the invoker's trace context riding the completion hop; None
        #: keeps it off the wire. Set after construction: the subclasses'
        #: signatures are wire contracts.
        self.trace_context: Optional[Dict[str, str]] = None

    @property
    def is_slot_free(self) -> bool:
        return self.invoker is not None

    def shrink(self, limit_bytes: int = 1024 * 1024) -> "AcknowledgementMessage":
        """Return an ack whose oversized result is dropped. Copies the
        activation — the caller's record (which gets persisted with its full
        result) must not lose its payload."""
        if self.activation is not None:
            shrunk_resp = self.activation.response.shrink(limit_bytes)
            if shrunk_resp is not self.activation.response:
                a = self.activation
                copy = type(a)(a.namespace, a.name, a.subject, a.activation_id,
                               a.start, a.end, shrunk_resp, list(a.logs),
                               a.annotations, a.duration, a.cause, a.version,
                               a.publish)
                out = AcknowledgementMessage(self.transid, self.activation_id,
                                             self.invoker, self.is_system_error,
                                             copy)
                out.kind = self.kind
                out.trace_context = self.trace_context
                return out
        return self

    def to_json(self) -> dict:
        out = {
            "kind": self.kind,
            "transid": self.transid.to_json(),
            "activationId": self.activation_id.to_json(),
            "invoker": self.invoker.to_json() if self.invoker else None,
            "isSystemError": self.is_system_error,
            "response": self.activation.to_json() if self.activation else None,
        }
        if self.trace_context is not None:
            out["traceContext"] = self.trace_context
        return out


class CompletionMessage(AcknowledgementMessage):
    """Slot released; no result payload (blocking calls already got theirs
    via ResultMessage)."""
    kind = "completion"

    def __init__(self, transid, activation_id, is_system_error, invoker):
        super().__init__(transid, activation_id, invoker, is_system_error, None)


class ResultMessage(AcknowledgementMessage):
    """Result payload only; slot not yet released (logs still collecting)."""
    kind = "result"

    def __init__(self, transid, activation: WhiskActivation):
        super().__init__(transid, activation.activation_id, None, False, activation)


class CombinedCompletionAndResultMessage(AcknowledgementMessage):
    kind = "combined"

    def __init__(self, transid, activation: WhiskActivation, invoker):
        super().__init__(transid, activation.activation_id, invoker,
                         activation.response.is_whisk_error, activation)


def parse_ack(raw: Union[bytes, str]) -> AcknowledgementMessage:
    j = json.loads(raw)
    kind = j.get("kind")
    transid = TransactionId.from_json(j["transid"])
    aid = ActivationId(j["activationId"])
    inv = InvokerInstanceId.from_json(j["invoker"]) if j.get("invoker") else None
    act = WhiskActivation.from_json(j["response"]) if j.get("response") else None
    if kind == "completion":
        ack = CompletionMessage(transid, aid, bool(j.get("isSystemError")), inv)
    elif kind in ("result", "combined"):
        if act is None:
            raise ValueError(f"{kind} ack without a response")
        ack = (ResultMessage(transid, act) if kind == "result"
               else CombinedCompletionAndResultMessage(transid, act, inv))
    else:
        raise ValueError(f"unknown ack kind {kind!r}")
    ack.trace_context = j.get("traceContext")
    return ack


class PingMessage(Message):
    """Invoker heartbeat on the health topic (Message.scala:124-131).

    `admin` is the invoker's scrapeable admin address, present only when an
    invoker announces one: None keeps it off the wire, and parse tolerates
    both."""

    def __init__(self, instance: InvokerInstanceId,
                 admin: Optional[str] = None):
        self.instance = instance
        self.admin = admin

    def to_json(self) -> dict:
        out = {"name": self.instance.to_json()}
        if self.admin:
            out["admin"] = self.admin
        return out

    @classmethod
    def parse(cls, raw) -> "PingMessage":
        j = json.loads(raw)
        admin = j.get("admin")
        return cls(InvokerInstanceId.from_json(j["name"]),
                   admin=admin if isinstance(admin, str) and admin else None)


class EventMessage(Message):
    """User-facing event (Message.scala:291-427): body is either an
    Activation summary or a Metric, consumed by the user-events service."""

    def __init__(self, source: str, body: dict, subject: str, namespace: str,
                 user_id: str, event_type: str, timestamp: Optional[float] = None):
        self.source = source
        self.body = body
        self.subject = subject
        self.namespace = namespace
        self.user_id = user_id
        self.event_type = event_type
        self.timestamp = timestamp if timestamp is not None else time.time()

    @classmethod
    def for_activation(cls, source: str, activation: WhiskActivation,
                       user_id: str, kind: str, conductor: bool = False,
                       memory_mb: int = 256, wait_time: int = 0,
                       init_time: int = 0) -> "EventMessage":
        body = {
            "name": f"{activation.namespace}/{activation.name}",
            "statusCode": activation.response.status_code,
            "duration": activation.duration or 0,
            "waitTime": wait_time, "initTime": init_time,
            "kind": kind, "conductor": conductor, "memory": memory_mb,
            "causedBy": activation.cause.to_json() if activation.cause else None,
        }
        return cls(source, body, str(activation.subject), str(activation.namespace),
                   user_id, "Activation")

    @classmethod
    def for_metric(cls, source: str, metric_name: str, value: int,
                   subject: str, namespace: str, user_id: str) -> "EventMessage":
        return cls(source, {"metricName": metric_name, "metricValue": value},
                   subject, namespace, user_id, "Metric")

    def to_json(self) -> dict:
        return {"source": self.source, "body": self.body, "subject": self.subject,
                "namespace": self.namespace, "userId": self.user_id,
                "eventType": self.event_type, "timestamp": int(self.timestamp * 1000)}

    @classmethod
    def parse(cls, raw) -> "EventMessage":
        j = json.loads(raw)
        return cls(j["source"], j["body"], j["subject"], j["namespace"],
                   j["userId"], j["eventType"], j.get("timestamp", 0) / 1000.0)
