"""Activations: the record of one function invocation.

Refs: ActivationResponse.scala (status codes 0..3 = success / application
error / developer error / whisk internal error, with `shrink`-able result
payloads) and WhiskActivation.scala (start/end, logs, response, annotations
incl. waitTime/initTime/kind/path/limits — the audit log of the system,
SURVEY §5.5).
"""
from __future__ import annotations

import json
import time
from typing import Any, List, Optional

from .entity import WhiskEntity
from .ids import ActivationId, Subject
from .names import EntityName, EntityPath
from .parameters import Parameters
from .semver import SemVer

# status codes (ActivationResponse.scala:42-48)
SUCCESS = 0
APPLICATION_ERROR = 1
DEVELOPER_ERROR = 2
WHISK_INTERNAL_ERROR = 3

_STATUS_NAMES = {
    SUCCESS: "success",
    APPLICATION_ERROR: "application error",
    DEVELOPER_ERROR: "action developer error",
    WHISK_INTERNAL_ERROR: "whisk internal error",
}


class ActivationResponse:
    __slots__ = ("status_code", "result", "size")

    def __init__(self, status_code: int, result: Optional[Any] = None,
                 size: Optional[int] = None):
        self.status_code = status_code
        self.result = result
        self.size = size

    # -- constructors (ref ActivationResponse.scala:60-120) ----------------
    @classmethod
    def success(cls, result: Optional[Any] = None) -> "ActivationResponse":
        return cls(SUCCESS, result)

    @classmethod
    def application_error(cls, error: Any) -> "ActivationResponse":
        return cls(APPLICATION_ERROR, {"error": error})

    @classmethod
    def developer_error(cls, error: Any) -> "ActivationResponse":
        return cls(DEVELOPER_ERROR, {"error": error})

    @classmethod
    def whisk_error(cls, error: Any) -> "ActivationResponse":
        return cls(WHISK_INTERNAL_ERROR, {"error": error})

    @classmethod
    def payload_placeholder(cls) -> "ActivationResponse":
        return cls(SUCCESS, {"error": "payload was too large to include"})

    # -- predicates --------------------------------------------------------
    @property
    def is_success(self) -> bool:
        return self.status_code == SUCCESS

    @property
    def is_app_error(self) -> bool:
        return self.status_code == APPLICATION_ERROR

    @property
    def is_whisk_error(self) -> bool:
        return self.status_code == WHISK_INTERNAL_ERROR

    @property
    def status(self) -> str:
        return _STATUS_NAMES[self.status_code]

    def shrink(self, limit_bytes: int) -> "ActivationResponse":
        """Drop an oversized result payload (ref AcknowledgementMessage.shrink,
        Message.scala — keeps the ack under the bus payload cap)."""
        if self.result is not None and len(json.dumps(self.result).encode()) > limit_bytes:
            return ActivationResponse(self.status_code, None,
                                      size=len(json.dumps(self.result).encode()))
        return self

    def to_json(self) -> dict:
        j = {"statusCode": self.status_code, "status": self.status,
             "success": self.is_success}
        if self.result is not None:
            j["result"] = self.result
        if self.size is not None:
            j["size"] = self.size
        return j

    @classmethod
    def from_json(cls, j: dict) -> "ActivationResponse":
        return cls(int(j.get("statusCode", SUCCESS)), j.get("result"), j.get("size"))

    def __eq__(self, other):
        return isinstance(other, ActivationResponse) and \
            (self.status_code, self.result) == (other.status_code, other.result)

    def __repr__(self):
        return f"ActivationResponse({self.status}, {self.result!r})"


class WhiskActivation(WhiskEntity):
    collection = "activations"

    def __init__(self, namespace: EntityPath, name: EntityName,
                 subject: Subject, activation_id: ActivationId,
                 start: float, end: float = 0.0,
                 response: Optional[ActivationResponse] = None,
                 logs: Optional[List[str]] = None,
                 annotations: Optional[Parameters] = None,
                 duration: Optional[int] = None,
                 cause: Optional[ActivationId] = None,
                 version: Optional[SemVer] = None, publish: bool = False):
        super().__init__(namespace, name, version, publish, annotations)
        self.subject = subject
        self.activation_id = activation_id
        self.start = start
        self.end = end
        self.response = response or ActivationResponse.success()
        self.logs = logs or []
        self.duration = duration
        self.cause = cause

    @property
    def docid(self) -> str:
        return f"{self.namespace}/{self.activation_id}"

    def with_logs(self, logs: List[str]) -> "WhiskActivation":
        self.logs = logs
        return self

    def without_logs(self) -> "WhiskActivation":
        """Summary view used on the wire when logs are collected later."""
        return WhiskActivation(self.namespace, self.name, self.subject,
                               self.activation_id, self.start, self.end,
                               self.response, [], self.annotations,
                               self.duration, self.cause, self.version, self.publish)

    def resulting_json(self) -> dict:
        """The `?result=true` projection (just the response result)."""
        return self.response.result if self.response.result is not None else {}

    def to_json(self) -> dict:
        j = self.base_json()
        j.update({
            "subject": self.subject.to_json(),
            "activationId": self.activation_id.to_json(),
            "start": int(self.start * 1000),
            "end": int(self.end * 1000),
            "response": self.response.to_json(),
            "logs": self.logs,
        })
        if self.duration is not None:
            j["duration"] = self.duration
        if self.cause is not None:
            j["cause"] = self.cause.to_json()
        return j

    @classmethod
    def from_json(cls, j: dict) -> "WhiskActivation":
        return cls(
            EntityPath(j["namespace"]), EntityName(j["name"]),
            Subject(j["subject"]), ActivationId(j["activationId"]),
            j.get("start", 0) / 1000.0, j.get("end", 0) / 1000.0,
            ActivationResponse.from_json(j.get("response", {})),
            list(j.get("logs", [])),
            Parameters.from_json(j.get("annotations")),
            j.get("duration"),
            ActivationId(j["cause"]) if j.get("cause") else None,
            SemVer.from_string(j.get("version", "0.0.1")),
            bool(j.get("publish", False)),
        )

    def summary_json(self) -> dict:
        """List-view projection (ref WhiskActivation.summaryFields)."""
        return {
            "namespace": self.namespace.to_json(), "name": self.name.to_json(),
            "activationId": self.activation_id.to_json(),
            "start": int(self.start * 1000), "end": int(self.end * 1000),
            "duration": self.duration,
            "statusCode": self.response.status_code,
            "version": self.version.to_json(), "cause": self.cause.to_json() if self.cause else None,
            "annotations": self.annotations.to_json(),
            "publish": self.publish,
        }


def now_ms() -> float:
    return time.time()
