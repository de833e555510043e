"""ContainerProxy: per-container lifecycle state machine.

Behavioral rebuild of core/invoker/.../containerpool/ContainerProxy.scala
(:64-204 state/data taxonomy, :242-559 transitions, :675-837 run pipeline,
:903-950 activation construction). The reference is an Akka FSM
(Uninitialized -> Starting -> Running -> Ready -> Pausing -> Paused ->
Removing); here the event loop serializes transitions so the proxy is a
plain async object with an explicit `state` field and timer tasks for the
pause grace and idle timeout.

Responsibilities per activation:
  cold:  factory.create -> /init -> /run
  warm:  (resume if paused) -> /run
  then:  construct WhiskActivation, send active-ack(s) (result fast-path for
         blocking, completion after log collection), collect logs into the
         record, store it.
Intra-container concurrency: up to action.limits.concurrency in-flight /run
posts share one warm container (ref :219-231).
"""
from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from ..core.entity import (ActivationResponse, EntityName, EntityPath,
                           ExecutableWhiskAction, Parameters, WhiskActivation)
from ..core.entity.parameters import ParameterValue
from ..messaging.message import ActivationMessage
from ..utils.transaction import TransactionId
from .container import Container, ContainerError, InitializationError, RunResult

# states (ref ContainerProxy.scala:64-80)
UNINITIALIZED = "uninitialized"
STARTING = "starting"
READY = "ready"
RUNNING = "running"
PAUSING = "pausing"
PAUSED = "paused"
REMOVING = "removing"


@dataclass
class ContainerData:
    """What the pool knows about a proxy's container (ref ContainerData
    hierarchy :82-204): kind+memory for prewarm matching, action+namespace
    for warm matching, activity for eviction ordering."""
    kind: Optional[str] = None
    memory_mb: int = 256
    action_id: Optional[str] = None       # fqn@rev of the initialized action
    invocation_namespace: Optional[str] = None
    last_used: float = 0.0

    def has_capacity(self, max_concurrent: int, active: int) -> bool:
        return active < max_concurrent


class ContainerProxy:
    def __init__(self, factory, active_ack, store_activation, collect_logs,
                 instance, pool_config, logger=None,
                 on_need_work: Optional[Callable] = None,
                 on_removed: Optional[Callable] = None,
                 on_reschedule: Optional[Callable] = None):
        self.factory = factory
        self.active_ack = active_ack          # async (transid, activation, blocking, controller, user, kind)
        self.store_activation = store_activation  # async (transid, activation, user)
        self.collect_logs = collect_logs      # async (transid, user, activation, container, action) -> [str]
        self.instance = instance
        self.config = pool_config
        self.logger = logger
        self.on_need_work = on_need_work or (lambda p: None)
        self.on_removed = on_removed or (lambda p: None)
        self.on_reschedule = on_reschedule or (lambda job: None)

        self.state = UNINITIALIZED
        self.container: Optional[Container] = None
        self.data = ContainerData()
        self.active_count = 0
        self.action: Optional[ExecutableWhiskAction] = None
        self._pause_task: Optional[asyncio.Task] = None
        self._idle_task: Optional[asyncio.Task] = None
        self._destroyed = False

    # -- prewarm -----------------------------------------------------------
    async def prestart(self, kind: str, image: str, memory_mb: int) -> None:
        """Start a stem-cell container (ref Start message handling :242-259)."""
        from ..core.entity import MB
        self.state = STARTING
        self.data = ContainerData(kind=kind, memory_mb=memory_mb)
        try:
            self.container = await self.factory.create_container(
                TransactionId.INVOKER_NANNY, f"prewarm-{kind.replace(':', '-')}",
                image, MB(memory_mb))
            self.state = READY
        except Exception as e:  # noqa: BLE001
            self._log_warn(f"prewarm start failed: {e!r}")
            await self._destroy(rescheduled_job=None)

    # -- main entry --------------------------------------------------------
    async def run(self, action: ExecutableWhiskAction, msg: ActivationMessage) -> None:
        """Execute one activation on this proxy's container. The pool
        guarantees scheduling constraints (capacity, warm match)."""
        self._cancel_timers()
        self.active_count += 1
        # state stays as-is here: _run_warm must still see PAUSED/PAUSING to
        # know it has to resume before posting /run
        try:
            if self.container is None:
                await self._run_cold(action, msg)
            else:
                await self._run_warm(action, msg)
        except Exception as e:  # noqa: BLE001 — NEVER lose an activation:
            # an unexpected failure still acks + stores a whisk-error record
            # (otherwise the client hangs and the invoker's feed slot leaks)
            self._log_warn(f"unexpected proxy failure: {e!r}")
            activation = self._error_activation(
                action, msg, ActivationResponse.whisk_error(
                    f"invoker error: {e}"))
            try:
                await self._finish(action, msg, activation, logs_container=None)
            finally:
                await self._destroy(rescheduled_job=None)
        finally:
            self.active_count -= 1
            if not self._destroyed and self.active_count == 0:
                self.state = READY
                self.data.last_used = time.time()
                self._arm_timers()
                self.on_need_work(self)

    # -- cold path ---------------------------------------------------------
    async def _run_cold(self, action: ExecutableWhiskAction, msg: ActivationMessage) -> None:
        self.state = STARTING
        t_create = time.time()
        try:
            image = self._image_for(action)
            self.container = await self.factory.create_container(
                msg.transid, str(action.name), image, action.limits.memory.size,
                self.config.cpu_share(action.limits.memory.size), action=action)
        except Exception as e:  # noqa: BLE001 — container start failure is a whisk error
            activation = self._error_activation(
                action, msg, ActivationResponse.whisk_error(
                    f"failed to start container: {e}"), wait_start=t_create)
            await self._finish(action, msg, activation, logs_container=None)
            await self._destroy(rescheduled_job=None)
            return
        self.data = ContainerData(kind=action.exec.kind,
                                  memory_mb=action.limits.memory.megabytes)
        await self._init_and_run(action, msg)

    async def _init_and_run(self, action: ExecutableWhiskAction,
                            msg: ActivationMessage) -> None:
        self.state = RUNNING
        init_ms = 0
        try:
            init_payload = action.container_initializer(
                env={"__OW_" + k.upper(): str(v)
                     for k, v in self._ow_env(action, msg).items()})
            init_ms = await self.container.initialize(
                init_payload, timeout=action.limits.timeout.seconds)
        except InitializationError as e:
            activation = self._error_activation(
                action, msg, ActivationResponse.developer_error(str(e)), init_ms=0)
            await self._finish(action, msg, activation, logs_container=self.container)
            await self._destroy(rescheduled_job=None)
            return
        except ContainerError as e:
            activation = self._error_activation(
                action, msg, ActivationResponse.whisk_error(str(e)))
            await self._finish(action, msg, activation, logs_container=None)
            await self._destroy(rescheduled_job=None)
            return
        self.data.action_id = _action_key(action)
        self.data.invocation_namespace = str(msg.user.namespace.name)
        self.action = action
        await self._execute(action, msg, init_ms=init_ms)

    # -- warm path ---------------------------------------------------------
    async def _run_warm(self, action: ExecutableWhiskAction, msg: ActivationMessage) -> None:
        if self.state == PAUSED or self.state == PAUSING:
            try:
                await self.container.resume()
            except Exception as e:  # noqa: BLE001 — failed resume: job back to pool
                self._log_warn(f"resume failed: {e!r}; rescheduling job")
                self.on_reschedule((action, msg))
                await self._destroy(rescheduled_job=None)
                return
        self.state = RUNNING
        if self.data.action_id is None:
            # taken from the prewarm pool: still needs /init
            await self._init_and_run(action, msg)
        else:
            await self._execute(action, msg, init_ms=0)

    # -- shared run pipeline ----------------------------------------------
    async def _execute(self, action: ExecutableWhiskAction, msg: ActivationMessage,
                       init_ms: int) -> None:
        params = action.parameters.merge(
            Parameters.from_arguments(msg.content or {}))
        env = self._ow_env(action, msg)
        result: RunResult = await self.container.run(
            params.to_arguments(), env, timeout=action.limits.timeout.seconds)
        response = _response_from_run(result)
        activation = self._construct_activation(action, msg, result, response, init_ms)
        await self._finish(action, msg, activation, logs_container=self.container)
        if response.is_whisk_error or result.timed_out:
            # system error or timeout: container state unknown -> destroy
            await self._destroy(rescheduled_job=None)

    async def _finish(self, action, msg, activation: WhiskActivation,
                      logs_container: Optional[Container]) -> None:
        """Ack + log collection + persistence ordering
        (ref ContainerProxy.scala:763-837)."""
        if msg.blocking:
            # result fast-path before log collection
            await self.active_ack(msg.transid, activation.without_logs(), True,
                                  msg.root_controller_index, msg.user, "result")
        logs: List[str] = []
        if logs_container is not None and action.limits.logs.megabytes > 0:
            try:
                logs = await self.collect_logs(msg.transid, msg.user, activation,
                                               logs_container, action)
            except Exception as e:  # noqa: BLE001 — log failure must not lose the activation
                logs = [f"Failed to collect logs: {e!r}"]
        activation.with_logs(logs)
        await self.active_ack(msg.transid, activation, msg.blocking,
                              msg.root_controller_index, msg.user,
                              "completion" if msg.blocking else "combined")
        await self.store_activation(msg.transid, activation, msg.user)

    # -- activation construction (ref :903-950) ----------------------------
    def _construct_activation(self, action: ExecutableWhiskAction,
                              msg: ActivationMessage, result: RunResult,
                              response: ActivationResponse, init_ms: int
                              ) -> WhiskActivation:
        wait_ms = max(0, int((result.start - msg.transid.start_wallclock) * 1000))
        annotations = Parameters({
            "limits": ParameterValue(action.limits.to_json()),
            "path": ParameterValue(str(action.fully_qualified_name)),
            "kind": ParameterValue(action.exec.kind),
            "waitTime": ParameterValue(wait_ms),
        })
        if init_ms:
            annotations = annotations.merge(Parameters({"initTime": ParameterValue(init_ms)}))
        if result.timed_out:
            annotations = annotations.merge(Parameters({"timeout": ParameterValue(True)}))
        return WhiskActivation(
            namespace=EntityPath(str(msg.user.namespace.name)),
            name=action.name, subject=msg.user.subject,
            activation_id=msg.activation_id,
            start=result.start, end=result.end,
            response=response, annotations=annotations,
            duration=result.interval_ms + init_ms,
            cause=msg.cause, version=action.version)

    def _error_activation(self, action, msg, response: ActivationResponse,
                          wait_start: Optional[float] = None, init_ms: int = 0
                          ) -> WhiskActivation:
        now = time.time()
        r = RunResult(wait_start or now, now, None, ok=False)
        return self._construct_activation(action, msg, r, response, init_ms)

    # -- pause / idle / destroy -------------------------------------------
    def _arm_timers(self) -> None:
        self._pause_task = asyncio.get_event_loop().create_task(self._pause_later())
        self._idle_task = asyncio.get_event_loop().create_task(self._idle_later())

    def _cancel_timers(self) -> None:
        for t in (self._pause_task, self._idle_task):
            if t is not None:
                t.cancel()
        self._pause_task = self._idle_task = None

    async def _pause_later(self) -> None:
        try:
            await asyncio.sleep(self.config.pause_grace)
            if self.state == READY and self.container is not None:
                self.state = PAUSING
                try:
                    await self.container.suspend()
                    if self.state == PAUSING:
                        self.state = PAUSED
                except Exception:  # noqa: BLE001 — failed pause -> remove
                    await self._destroy(rescheduled_job=None)
        except asyncio.CancelledError:
            pass

    async def _idle_later(self) -> None:
        try:
            await asyncio.sleep(self.config.idle_container_timeout)
            if self.state in (READY, PAUSED, PAUSING) and self.active_count == 0:
                await self._destroy(rescheduled_job=None)
        except asyncio.CancelledError:
            pass

    async def halt(self) -> None:
        """Pool-initiated removal (eviction)."""
        await self._destroy(rescheduled_job=None)

    async def _destroy(self, rescheduled_job) -> None:
        if self._destroyed:
            return
        self._destroyed = True
        self.state = REMOVING
        self._cancel_timers()
        if self.container is not None:
            try:
                await self.container.destroy()
            except Exception as e:  # noqa: BLE001
                self._log_warn(f"destroy failed: {e!r}")
            self.container = None
        if rescheduled_job is not None:
            self.on_reschedule(rescheduled_job)
        self.on_removed(self)

    # -- helpers -----------------------------------------------------------
    def _image_for(self, action: ExecutableWhiskAction) -> str:
        e = action.exec
        img = getattr(e, "image", None)
        if img:
            return img
        from ..core.entity import ExecManifest
        m = ExecManifest.runtimes().manifest_for(e.kind)
        if m is None:
            return e.kind
        return m.image.resolved

    def _ow_env(self, action: ExecutableWhiskAction,
                msg: ActivationMessage) -> Dict[str, Any]:
        """The activation context handed to the container, identical for /init
        (``__OW_``-uppercased by the caller) and /run (bare keys; the runtime
        prefixes) — ref ContainerProxy.scala:680-701 authEnvironment ++
        environment ++ deadline."""
        return {
            **self._auth_env(action, msg),
            "namespace": str(msg.user.namespace.name),
            "action_name": str(action.fully_qualified_name),
            "action_version": str(action.version),
            "activation_id": msg.activation_id.asString,
            "transaction_id": msg.transid.id,
            "deadline": str(int((time.time() + action.limits.timeout.seconds) * 1000)),
        }

    def _auth_env(self, action: ExecutableWhiskAction,
                  msg: ActivationMessage) -> Dict[str, Any]:
        """The API key for the action context, withheld when the action's
        `provide-api-key` annotation is present and not truthy; a missing
        annotation provides the key for backward compatibility
        (ref ContainerProxy.scala:688-693, Annotations.scala:26)."""
        from ..core.feature_flags import PROVIDE_API_KEY_ANNOTATION
        if not action.annotations.is_truthy(PROVIDE_API_KEY_ANNOTATION,
                                            value_for_non_existent=True):
            return {}
        return {"api_key": msg.user.authkey.compact}

    def _log_warn(self, text: str) -> None:
        if self.logger:
            self.logger.warn(TransactionId.INVOKER_NANNY, text, "ContainerProxy")


def _action_key(action: ExecutableWhiskAction) -> str:
    rev = action.rev.rev or ""
    return f"{action.fully_qualified_name}@{rev}"


def _response_from_run(result: RunResult) -> ActivationResponse:
    """Map the /run outcome to an activation response
    (ref ActivationResponse.processRunResponseContent)."""
    body = result.response or {}
    if result.timed_out:
        return ActivationResponse.developer_error(
            body.get("error", "action exceeded its allotted time"))
    if result.connection_failed:
        # the socket to the container died mid-request: whisk error, so the
        # proxy destroys the (state-unknown) container instead of letting a
        # wedged sandbox fail every subsequent warm invoke (ref Container
        # connection failures -> destroy + error activation)
        return ActivationResponse.whisk_error(
            body.get("error", "connection to the action container failed"))
    if result.ok:
        if isinstance(body, dict) and set(body.keys()) == {"error"}:
            return ActivationResponse.application_error(body["error"])
        return ActivationResponse.success(body)
    if isinstance(body, dict) and "error" in body:
        err = body["error"]
        # transport failures never reach here (connection_failed above);
        # a body with "error" is the action proxy's own HTTP response
        return ActivationResponse.application_error(err)
    return ActivationResponse.developer_error(
        "the action did not produce a valid response")
