"""Columnar batch wire records: one encoded frame for a whole micro-batch.
A copy of `openwhisk_tpu/messaging/columnar.py`.

The activation BATCH — not the activation — is the
unit of work on every host hop. The coalescing producer already ships one
`pubN` frame per micro-batch, but each sub-message inside it is still an
independently-JSON-encoded ActivationMessage / ack: at 1,000 activations/s
the host pays ~N `json.dumps` + N `json.loads` per hop, plus N parses of
the SAME identity/action/controller sub-objects (the host observatory
measured the serde plane at ~7.7% of wall per hop at 512/s, before
counting the per-message object construction it feeds).

This module is the wire half of the columnar hot path:

  * `ActivationBatchMessage` — N controller->invoker dispatches packed as
    ONE struct-of-arrays JSON record: per-batch dedup tables for the
    repeated heavy sub-objects (users, (action, revision) pairs,
    controller ids) and packed per-row columns (activation ids, user /
    action indices, transids, blocking bits, arg payloads — the arg
    column is the "one blob" of the packed form: a single `json.dumps`
    writes every row's args in one C-speed pass, and sparse columns
    carry the rarely-present fields). ONE serialize per batch; the
    decode side rebuilds N `ActivationMessage`s parsing each unique
    identity/action exactly once.
  * `AckBatchMessage` — the mirror record for the invoker->controller
    completion fan-in (kinds, transids, ids, invoker dedup, system-error
    bits, response payloads).
  * `is_batch_payload` / `batch_hop_of` — frame sniffing for consumers:
    every batch payload starts with the `{"whiskBatch":` magic, so a
    feed handler can route a frame to the batch decode without parsing
    it (plain per-message frames never start with that key — neither
    ActivationMessage nor the acks serialize a `whiskBatch` field
    first, and json.dumps key order is insertion order).

Off switch: the batch wire rides the coalescing producer
(`CONFIG_whisk_bus_coalesce_batchWire=false` restores one independently
encoded payload per message — the serial wire format, byte-exact).
"""
from __future__ import annotations

import json
import logging
from typing import Dict, List, Optional, Tuple

from ..core.entity import ActivationId, ControllerInstanceId, Identity
from ..core.entity.names import FullyQualifiedEntityName
from ..utils.transaction import TransactionId
from .message import (AcknowledgementMessage, ActivationMessage,
                      CombinedCompletionAndResultMessage, CompletionMessage,
                      Message, ResultMessage)

#: every batch payload leads with this key (json.dumps preserves insertion
#: order, so the magic is a stable byte prefix — the cheap routing test)
BATCH_MAGIC = b'{"whiskBatch":'
#: the lazy ack frame's exact serialized prefix (compact json.dumps puts
#: the magic key first): parse_batch sniffs THIS before paying a
#: full-payload newline scan that plain frames can never satisfy
_LAZY_PREFIX = b'{"whiskBatch":"ackL"'

KIND_ACTIVATION = "act1"
KIND_ACK = "ack1"
#: the LAZY ack frame: a JSON header (columns + respLen) then
#: one raw newline then the concatenated per-row response payloads as
#: opaque bytes. json.dumps never emits a raw newline (strings escape
#: theirs), so the first b"\n" in a batch payload is always this frame
#: delimiter and plain frames never contain one.
KIND_ACK_LAZY = "ackL"
#: the admission-funnel frame: an activation batch plus a
#: (origin, seq, epoch) routing header — one front-end process's whole
#: admission wave shipped to the device-owning balancer as one record.
KIND_FUNNEL = "fun1"
#: the funnel's per-row outcome frame back to the origin: placement /
#: refusal / completion records, columnar like the ack batch.
KIND_FUNNEL_ACK = "funA"

#: serde hop labels by batch kind (mirrors connector._SERDE_HOPS so the
#: host observatory's per-hop accounting survives the batch wire)
_BATCH_HOPS = {KIND_ACTIVATION: "activation", KIND_ACK: "completion_ack",
               KIND_ACK_LAZY: "completion_ack",
               KIND_FUNNEL: "activation",
               KIND_FUNNEL_ACK: "completion_ack"}

#: the deferred result parse books its cost under its OWN hop, so the
#: "consumer never reads the result" case is visible as a ZERO row here
#: while the frame decode stays under completion_ack
LAZY_RESULT_HOP = "ack_result"


def is_batch_payload(raw) -> bool:
    """True when `raw` is a batch wire record (magic-prefix sniff; no
    parse). Accepts bytes/bytearray/str."""
    if isinstance(raw, str):
        return raw.startswith('{"whiskBatch":')
    return bytes(raw[:len(BATCH_MAGIC)]) == BATCH_MAGIC


def batch_hop_of(kind: str) -> str:
    return _BATCH_HOPS.get(kind, "other")


def batchable_family(msg) -> Optional[str]:
    """The batch family a message coalesces into, or None for messages
    that stay per-frame (pings, events: background chatter whose framing
    is not on the hot path)."""
    if isinstance(msg, ActivationMessage):
        return KIND_ACTIVATION
    if isinstance(msg, AcknowledgementMessage):
        return KIND_ACK
    return None


class _Dedup:
    """Insertion-ordered dedup table: intern() returns the index of the
    (hashable) key, appending `value` on first sight."""

    __slots__ = ("index", "values")

    def __init__(self):
        self.index: Dict[object, int] = {}
        self.values: List[object] = []

    def intern(self, key, value) -> int:
        i = self.index.get(key)
        if i is None:
            i = len(self.values)
            self.index[key] = i
            self.values.append(value)
        return i


class ActivationBatchMessage(Message):
    """N ActivationMessages as one columnar wire record (see module doc).

    The struct-of-arrays layout: `users`/`actions`/`ctrls` are per-batch
    dedup tables (each unique identity / (fqn, revision) / controller
    encoded ONCE); `ids`, `u`, `a`, `c`, `tx`, `bl`, `args` are
    length-N columns; `cause`/`trace`/`init` are sparse {row: value}
    columns present only when some row carries the field. `fence` is the
    batch-level HA epoch (one controller's flush shares one epoch; a
    rare mixed-epoch flush falls back to a sparse per-row column)."""

    def __init__(self, msgs: List[ActivationMessage]):
        self.msgs = msgs

    #: the waterfall produce edge stamps per activation: connector
    #: stamp_produce reads this instead of .activation_id
    @property
    def activation_ids(self) -> List[str]:
        return [m.activation_id.asString for m in self.msgs]

    def to_json(self) -> dict:
        users, actions, ctrls = _Dedup(), _Dedup(), _Dedup()
        ids: List[str] = []
        u_col: List[int] = []
        a_col: List[int] = []
        c_col: List[int] = []
        tx_col: List[object] = []
        bl_col: List[int] = []
        args_col: List[Optional[dict]] = []
        cause: Dict[str, str] = {}
        trace: Dict[str, dict] = {}
        init: Dict[str, dict] = {}
        fences: Dict[str, int] = {}
        fparts: Dict[str, int] = {}
        for row, m in enumerate(self.msgs):
            ids.append(m.activation_id.asString)
            # identity dedup keys on the subject+namespace-uuid pair (the
            # stable identity key); the action table keys on (fqn, rev)
            ident = m.user
            u_col.append(users.intern(
                (ident.subject, ident.namespace.uuid.asString),
                ident.to_json()))
            a_col.append(actions.intern((str(m.action), m.revision),
                                        [str(m.action), m.revision]))
            c_col.append(ctrls.intern(m.root_controller_index.name,
                                      m.root_controller_index.name))
            tx_col.append(m.transid.to_json())
            bl_col.append(1 if m.blocking else 0)
            args_col.append(m.content)
            if m.cause is not None:
                cause[str(row)] = m.cause.to_json()
            if m.trace_context is not None:
                trace[str(row)] = m.trace_context
            if m.init_args:
                init[str(row)] = m.init_args
            if m.fence_epoch is not None:
                fences[str(row)] = m.fence_epoch
            if m.fence_part is not None:
                fparts[str(row)] = m.fence_part
        out = {
            "whiskBatch": KIND_ACTIVATION,
            "users": users.values,
            "actions": actions.values,
            "ctrls": ctrls.values,
            "ids": ids,
            "u": u_col, "a": a_col, "c": c_col,
            "tx": tx_col, "bl": bl_col,
            "args": args_col,
        }
        if cause:
            out["cause"] = cause
        if trace:
            out["trace"] = trace
        if init:
            out["init"] = init
        if fences:
            # the common case is one shared epoch: collapse to a scalar
            vals = set(fences.values())
            if len(vals) == 1 and len(fences) == len(self.msgs):
                out["fence"] = vals.pop()
            else:
                out["fences"] = fences
        if fparts:
            # active/active: per-row partition ids (a batch freely mixes
            # namespaces, so partitions rarely collapse to one scalar)
            vals = set(fparts.values())
            if len(vals) == 1 and len(fparts) == len(self.msgs):
                out["fpart"] = vals.pop()
            else:
                out["fparts"] = fparts
        return out

    @staticmethod
    def parse(raw) -> List[ActivationMessage]:
        """One json.loads + shared-subobject reconstruction: each unique
        identity/action/controller in the batch is parsed exactly once
        and the rebuilt objects are SHARED across the batch's messages
        (read-only on the consume side, like the reference's case
        classes)."""
        j = json.loads(raw)
        return ActivationBatchMessage.from_json(j)

    @staticmethod
    def from_json(j: dict) -> List[ActivationMessage]:
        users = [Identity.from_json(u) for u in j["users"]]
        actions = [(FullyQualifiedEntityName.parse(a), rev)
                   for a, rev in j["actions"]]
        ctrls = [ControllerInstanceId(c) for c in j["ctrls"]]
        cause = j.get("cause") or {}
        trace = j.get("trace") or {}
        init = j.get("init") or {}
        fence = j.get("fence")
        fences = j.get("fences") or {}
        fpart = j.get("fpart")
        fparts = j.get("fparts") or {}
        out: List[ActivationMessage] = []
        for row, (aid, u, a, c, tx, bl, args) in enumerate(zip(
                j["ids"], j["u"], j["a"], j["c"], j["tx"], j["bl"],
                j["args"])):
            key = str(row)
            fqn, rev = actions[a]
            row_cause = cause.get(key)
            out.append(ActivationMessage(
                TransactionId.from_json(tx), fqn, rev, users[u],
                ActivationId(aid), ctrls[c], bool(bl), args,
                init.get(key) or {},
                ActivationId(row_cause) if row_cause else None,
                trace.get(key),
                fence if fence is not None else fences.get(key),
                fpart if fpart is not None else fparts.get(key)))
        return out


#: ack kind -> wire code (one char per row in the kinds column)
_ACK_CODES = {"completion": "c", "result": "r", "combined": "b"}
_ACK_KINDS = {v: k for k, v in _ACK_CODES.items()}


class LazyWhiskActivation:
    """A WhiskActivation that stays raw bytes until somebody reads it.

    The lazy ack frame ships each activation's response
    payload as an opaque bytes column; the completion hot loop
    (`process_acknowledgements`) only needs the ack COLUMNS (id, invoker,
    system-error bit) — the response is dead weight there. This proxy
    carries the raw payload through the promise plumbing and parses it on
    the first attribute access, which for a blocking invoke happens on
    the API handler's own turn and for a fire-and-forget ack happens
    never. The deferred parse books its bytes + wall time under the
    `ack_result` serde hop, so skipped parses are a measurable zero."""

    __slots__ = ("raw", "_obj")

    def __init__(self, raw: bytes):
        self.raw = raw
        self._obj = None

    @property
    def materialized(self) -> bool:
        return self._obj is not None

    def _materialize(self):
        obj = self._obj
        if obj is None:
            from ..core.entity import WhiskActivation
            from ..utils.hostprof import GLOBAL_HOST_OBSERVATORY
            obs = GLOBAL_HOST_OBSERVATORY
            try:
                if obs.serde_active:
                    import time as _time
                    t0 = _time.perf_counter_ns()
                    obj = WhiskActivation.from_json(json.loads(self.raw))
                    obs.serde_observe(LAZY_RESULT_HOP, "deserialize",
                                      len(self.raw),
                                      _time.perf_counter_ns() - t0)
                else:
                    obj = WhiskActivation.from_json(json.loads(self.raw))
            except Exception as e:
                # a corrupt body behind a CONSISTENT lazy frame (header +
                # lengths fine, payload garbled) is by design undetectable
                # until this first read — the eager wire's decode-time
                # "corrupt completion ack" drop can't apply. Surface a
                # well-defined, logged error here instead of letting a
                # JSONDecodeError/KeyError escape deep inside whatever
                # consumer touched the first attribute.
                logging.warning("corrupt lazy ack result (%dB): %r",
                                len(self.raw), e)
                raise ValueError(
                    f"corrupt lazy ack result: {e!r}") from e
            self._obj = obj
        return obj

    def __getattr__(self, name):
        # only reached for names not in __slots__/class dict: every real
        # WhiskActivation attribute (activation_id, response, to_json...)
        # lands here and forces the parse
        return getattr(self._materialize(), name)

    def __repr__(self) -> str:  # no parse for logging
        state = "parsed" if self._obj is not None else f"{len(self.raw)}B raw"
        return f"LazyWhiskActivation({state})"


class AckBatchMessage(Message):
    """N invoker->controller acks as one columnar wire record. The heavy
    per-row payload (the WhiskActivation response) stays per-row — it IS
    the data — but the batch pays ONE json.dumps/loads for all of them,
    and the invoker table dedups the repeated instance id.

    `lazy_results=True` (the lazy wire) moves the response payloads
    OUT of the JSON record: the frame becomes a JSON header (columns +
    a `respLen` byte-length column) followed by one raw newline and the
    concatenated response payloads as opaque bytes. The decode side then
    never parses a response the consumer doesn't read — the controller's
    completion loop only touches the columns. False keeps the eager
    format byte-exact."""

    def __init__(self, msgs: List[AcknowledgementMessage],
                 lazy_results: bool = False):
        self.msgs = msgs
        self.lazy_results = lazy_results

    @property
    def activation_ids(self) -> List[str]:
        return [m.activation_id.asString for m in self.msgs]

    def _columns(self) -> dict:
        """The shared (response-free) ack columns: the eager record and
        the lazy header carry their responses differently, so each
        caller builds its own resp column. The sparse `trace` column
        mirrors the activation batch's: present only when
        some ack carries a trace context, so untraced batches stay
        byte-exact with the untraced frames — and because it lives HERE
        it rides both the eager record and the lazy header."""
        invs = _Dedup()
        kinds: List[str] = []
        tx_col: List[object] = []
        ids: List[str] = []
        iv_col: List[int] = []
        err_col: List[int] = []
        trace: Dict[str, dict] = {}
        for row, m in enumerate(self.msgs):
            kinds.append(_ACK_CODES.get(m.kind, "b"))
            tx_col.append(m.transid.to_json())
            ids.append(m.activation_id.asString)
            iv_col.append(-1 if m.invoker is None
                          else invs.intern(m.invoker.as_string,
                                           m.invoker.to_json()))
            err_col.append(1 if m.is_system_error else 0)
            tc = getattr(m, "trace_context", None)
            if tc is not None:
                trace[str(row)] = tc
        out = {"invs": invs.values, "kinds": "".join(kinds),
               "tx": tx_col, "ids": ids, "iv": iv_col, "err": err_col}
        if trace:
            out["trace"] = trace
        return out

    def to_json(self) -> dict:
        out = {"whiskBatch": KIND_ACK}
        out.update(self._columns())
        out["resp"] = [m.activation.to_json()
                       if m.activation is not None else None
                       for m in self.msgs]
        return out

    @staticmethod
    def _resp_bytes(m: AcknowledgementMessage) -> bytes:
        """One row's opaque response payload. A still-raw relay (a
        LazyWhiskActivation nobody parsed) passes its bytes through
        untouched — re-encoding an unread payload would be the exact
        serde cost the lazy column exists to skip."""
        act = m.activation
        if act is None:
            return b""
        if isinstance(act, LazyWhiskActivation) and not act.materialized:
            return act.raw
        return json.dumps(act.to_json(), separators=(",", ":")).encode()

    def serialize(self) -> bytes:
        if not self.lazy_results:
            return super().serialize()
        bodies = [self._resp_bytes(m) for m in self.msgs]
        header = {"whiskBatch": KIND_ACK_LAZY}
        header.update(self._columns())
        header["respLen"] = [len(b) for b in bodies]
        return (json.dumps(header, separators=(",", ":")).encode()
                + b"\n" + b"".join(bodies))

    @staticmethod
    def parse(raw) -> List[AcknowledgementMessage]:
        j = json.loads(raw)
        return AckBatchMessage.from_json(j)

    @staticmethod
    def from_json(j: dict) -> List[AcknowledgementMessage]:
        from ..core.entity import InvokerInstanceId, WhiskActivation
        invs = [InvokerInstanceId.from_json(v) for v in j["invs"]]
        trace = j.get("trace") or {}
        out: List[AcknowledgementMessage] = []
        for row, (code, tx, aid, iv, err, resp) in enumerate(zip(
                j["kinds"], j["tx"], j["ids"], j["iv"], j["err"],
                j["resp"])):
            transid = TransactionId.from_json(tx)
            inv = invs[iv] if iv >= 0 else None
            act = WhiskActivation.from_json(resp) if resp else None
            kind = _ACK_KINDS.get(code, "combined")
            if kind == "completion":
                ack = CompletionMessage(transid, ActivationId(aid),
                                        bool(err), inv)
            elif kind == "result":
                ack = ResultMessage(transid, act)
            else:
                ack = CombinedCompletionAndResultMessage(transid, act, inv)
            # set post-construction: the kind ctors are frozen contracts
            ack.trace_context = trace.get(str(row))
            out.append(ack)
        return out

    @staticmethod
    def from_lazy(header: dict, body: bytes) -> List[AcknowledgementMessage]:
        """Decode the lazy frame WITHOUT touching a single response byte
        beyond slicing: every ack field comes from the columns (the
        `err` bit was computed at encode time from the same response the
        eager path would re-derive it from), and each present response
        becomes a LazyWhiskActivation over its body slice. Building the
        base AcknowledgementMessage directly — instead of the kind
        subclasses — matters: ResultMessage reads activation_id off the
        activation and CombinedCompletionAndResultMessage reads
        response.is_whisk_error, either of which would force the parse
        this frame exists to defer."""
        from ..core.entity import InvokerInstanceId
        invs = [InvokerInstanceId.from_json(v) for v in header["invs"]]
        trace = header.get("trace") or {}
        lens = header["respLen"]
        out: List[AcknowledgementMessage] = []
        off = 0
        for row, (code, tx, aid, iv, err, ln) in enumerate(zip(
                header["kinds"], header["tx"], header["ids"], header["iv"],
                header["err"], lens)):
            raw = body[off:off + ln] if ln else b""
            off += ln
            ack = AcknowledgementMessage(
                TransactionId.from_json(tx), ActivationId(aid),
                invs[iv] if iv >= 0 else None, bool(err),
                LazyWhiskActivation(raw) if raw else None)
            ack.kind = _ACK_KINDS.get(code, "combined")
            ack.trace_context = trace.get(str(row))
            out.append(ack)
        if off != len(body):
            raise ValueError(
                f"lazy ack frame body length {len(body)} != respLen "
                f"sum {off}")
        return out


class FunnelFrame:
    """Decoded `fun1` frame: the rebuilt ActivationMessages plus the
    routing header the receiver fences/dedupes on."""

    __slots__ = ("origin", "seq", "epoch", "msgs")

    def __init__(self, origin: int, seq: int, epoch: int,
                 msgs: List[ActivationMessage]):
        self.origin = origin
        self.seq = seq
        self.epoch = epoch
        self.msgs = msgs


class FunnelBatchMessage(Message):
    """One front-end admission wave as ONE wire record — the
    `act1` struct-of-arrays columns (reused verbatim: dedup tables +
    packed per-row columns) plus three routing scalars:

      * `origin` — the front-end controller instance the per-row outcome
        frames route back to (topic `ctrlfunnelack<origin>`);
      * `seq` — the sender's frame counter. Application-level retry
        re-ships the SAME seq, and the receiver dedupes PER ROW (the
        `pubN` discipline one layer up): a replayed frame only places
        rows whose first delivery was lost;
      * `epoch` — the placement-leadership epoch the sender believes
        current. 0 = unfenced (bootstrap; the balancer's own standby /
        partition fences still apply row-by-row); nonzero must equal the
        receiving balancer's live epoch or the whole frame is refused —
        covering both the zombie sender and the demoted (stale-epoch)
        balancer."""

    def __init__(self, msgs: List[ActivationMessage], origin: int,
                 seq: int, epoch: int = 0):
        self.msgs = msgs
        self.origin = int(origin)
        self.seq = int(seq)
        self.epoch = int(epoch)

    @property
    def activation_ids(self) -> List[str]:
        return [m.activation_id.asString for m in self.msgs]

    def to_json(self) -> dict:
        # reuse the act1 columns; overwriting the kind keeps `whiskBatch`
        # in first position (dict order), so the magic-prefix sniff holds
        out = ActivationBatchMessage(self.msgs).to_json()
        out["whiskBatch"] = KIND_FUNNEL
        out["origin"] = self.origin
        out["seq"] = self.seq
        out["epoch"] = self.epoch
        return out

    @staticmethod
    def from_json(j: dict) -> FunnelFrame:
        msgs = ActivationBatchMessage.from_json(j)
        return FunnelFrame(int(j["origin"]), int(j["seq"]),
                           int(j.get("epoch", 0)), msgs)


#: funnel outcome codes (one char per row in the `k` column):
#:   p = placed (the row has a completion promise at the balancer)
#:   r = refused (sparse `exc` row carries [kind-code, exact text])
#:   c = completed (sparse `resp` row carries the activation JSON for
#:       blocking rows; non-blocking completions ship slim)
#:   f = forced completion timeout (the serial path's ActiveAckTimeout)
FUNNEL_PLACED = "p"
FUNNEL_REFUSED = "r"
FUNNEL_COMPLETED = "c"
FUNNEL_FORCED = "f"

#: refusal kind-codes: "T" rebuilds LoadBalancerThrottleException (429
#: at the front door), anything else a plain LoadBalancerException (503)
FUNNEL_EXC_THROTTLE = "T"
FUNNEL_EXC_ERROR = "L"


class FunnelOutcome:
    """One decoded `funA` row."""

    __slots__ = ("code", "aid", "err", "exc", "resp")

    def __init__(self, code: str, aid: str, err: bool = False,
                 exc: Optional[Tuple[str, str]] = None,
                 resp: Optional[dict] = None):
        self.code = code
        self.aid = aid
        self.err = err
        self.exc = exc
        self.resp = resp


class FunnelAckFrame:
    __slots__ = ("origin", "epoch", "rows")

    def __init__(self, origin: int, epoch: int, rows: List[FunnelOutcome]):
        self.origin = origin
        self.epoch = epoch
        self.rows = rows


class FunnelAckMessage(Message):
    """N funnel outcome records as one columnar record. `epoch` is the
    balancer's CURRENT placement epoch — senders adopt it, so a
    bootstrap (epoch-0) sender converges to fenced frames after its
    first outcome wave."""

    def __init__(self, origin: int, epoch: int,
                 rows: List[FunnelOutcome]):
        self.origin = int(origin)
        self.epoch = int(epoch)
        self.rows = rows

    def to_json(self) -> dict:
        exc: Dict[str, list] = {}
        resp: Dict[str, dict] = {}
        for i, r in enumerate(self.rows):
            if r.exc is not None:
                exc[str(i)] = [r.exc[0], r.exc[1]]
            if r.resp is not None:
                resp[str(i)] = r.resp
        out = {
            "whiskBatch": KIND_FUNNEL_ACK,
            "origin": self.origin,
            "epoch": self.epoch,
            "ids": [r.aid for r in self.rows],
            "k": "".join(r.code for r in self.rows),
            "err": [1 if r.err else 0 for r in self.rows],
        }
        if exc:
            out["exc"] = exc
        if resp:
            out["resp"] = resp
        return out

    @staticmethod
    def from_json(j: dict) -> FunnelAckFrame:
        exc = j.get("exc") or {}
        resp = j.get("resp") or {}
        rows = []
        for i, (aid, code, err) in enumerate(zip(j["ids"], j["k"],
                                                 j["err"])):
            key = str(i)
            e = exc.get(key)
            rows.append(FunnelOutcome(
                code, aid, bool(err),
                (e[0], e[1]) if e is not None else None,
                resp.get(key)))
        return FunnelAckFrame(int(j["origin"]), int(j.get("epoch", 0)),
                              rows)


def make_batch(family: str, msgs: list,
               lazy_results: bool = False) -> Message:
    """Wrap same-family messages into their batch record (the
    `serialize_many` entry point the coalescing producer uses).
    `lazy_results` selects the lazy ack frame for the ack
    family; activation batches ignore it (their args ARE read by every
    consumer)."""
    if family == KIND_ACTIVATION:
        return ActivationBatchMessage(msgs)
    if family == KIND_ACK:
        return AckBatchMessage(msgs, lazy_results=lazy_results)
    raise ValueError(f"not a batchable family: {family!r}")


def parse_batch(raw) -> Tuple[str, list]:
    """Decode one batch payload -> (kind, [messages]). The caller sniffs
    with is_batch_payload first; an unknown kind raises ValueError (the
    feed's corrupt-message posture). A lazy ack frame splits at its
    first raw newline (plain JSON frames never contain one) and parses
    ONLY the header — the response payloads stay opaque slices."""
    if isinstance(raw, str):
        raw = raw.encode()
    raw = bytes(raw)
    # sniff the fixed lazy prefix BEFORE scanning for the delimiter:
    # plain frames can never contain a raw newline, so the full-payload
    # memchr would be guaranteed-miss work on the completion hot loop's
    # biggest byte streams (eager ack frames carrying whole responses)
    if raw.startswith(_LAZY_PREFIX):
        nl = raw.find(b"\n")
        if nl < 0:
            raise ValueError("lazy ack frame missing its body delimiter")
        header = json.loads(raw[:nl])
        kind = header.get("whiskBatch")
        if kind != KIND_ACK_LAZY:
            raise ValueError(f"framed batch with unknown kind {kind!r}")
        return kind, AckBatchMessage.from_lazy(header, raw[nl + 1:])
    j = json.loads(raw)
    kind = j.get("whiskBatch")
    if kind == KIND_ACTIVATION:
        return kind, ActivationBatchMessage.from_json(j)
    if kind == KIND_ACK:
        return kind, AckBatchMessage.from_json(j)
    if kind == KIND_FUNNEL:
        # the funnel frame decodes to ONE header-carrying object, not a
        # message list — only the funnel receiver consumes this kind
        return kind, FunnelBatchMessage.from_json(j)
    if kind == KIND_FUNNEL_ACK:
        return kind, FunnelAckMessage.from_json(j)
    raise ValueError(f"unknown batch kind {kind!r}")
