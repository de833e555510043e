"""Process container driver: actions run in local subprocess sandboxes.

The reference's invoker shells out to the docker CLI to start runtime-image
containers (core/invoker/.../docker/DockerClient.scala:81-179). This driver
keeps the same Container contract but the sandbox is an OS subprocess running
the in-repo action proxy (openwhisk_tpu_torch/containerpool/actionproxy.py) — the
natural container primitive for a single-host/TPU-pod deployment where docker
is unavailable. Pause/resume map to SIGSTOP/SIGCONT (the same mechanism runc
pause uses underneath); memory limits map to RLIMIT_AS.

A copy of `openwhisk_tpu/containerpool/process_factory.py`, with one fault
of the reference fixed: it chose a sandbox's port by binding port 0 and
closing the socket, and the sandbox bound that port later. Another
factory (another invoker process on the host) could draw the same port in
between; the second sandbox then failed to bind and exited, and both
containers talked to the first. When the first's invoker paused it, a run
of the other waited out its time limit (502 "action exceeded its time
limit"). Here the factory binds and listens itself and hands the socket
to the sandbox, so no other process can take the port.
"""
from __future__ import annotations

import asyncio
import os
import signal
import socket
import sys
import tempfile
import uuid
from typing import List, Optional

from ..core.entity import ByteSize
from .container import ACTIVATION_LOG_SENTINEL, Container, ContainerError
from .factory import ContainerFactory


class ProcessContainer(Container):
    def __init__(self, proc: asyncio.subprocess.Process, port: int,
                 stdout_path: str, stderr_path: str, kind: str, memory: ByteSize):
        super().__init__(f"proc-{proc.pid}-{uuid.uuid4().hex[:8]}", ("127.0.0.1", port))
        self.proc = proc
        self.stdout_path = stdout_path
        self.stderr_path = stderr_path
        self.kind = kind
        self.memory = memory
        self._log_offsets = {stdout_path: 0, stderr_path: 0}

    async def suspend(self) -> None:
        if self.proc.returncode is None:
            self.proc.send_signal(signal.SIGSTOP)

    async def resume(self) -> None:
        if self.proc.returncode is None:
            self.proc.send_signal(signal.SIGCONT)

    async def destroy(self) -> None:
        await super().destroy()
        if self.proc.returncode is None:
            self.proc.send_signal(signal.SIGCONT)  # can't reap a stopped proc
            self.proc.kill()
            try:
                await asyncio.wait_for(self.proc.wait(), 5)
            except asyncio.TimeoutError:
                pass
        for p in (self.stdout_path, self.stderr_path):
            try:
                os.unlink(p)
            except OSError:
                pass

    async def logs(self, limit_bytes: int = 10 * 1024 * 1024,
                   wait_for_sentinel: bool = True) -> List[str]:
        """Drain new log lines up to (and excluding) the sentinel on each
        stream (ref DockerToActivationLogStore semantics)."""
        out: List[str] = []
        for path in (self.stdout_path, self.stderr_path):
            stream = "stdout" if path == self.stdout_path else "stderr"
            lines = await self._read_stream(path, wait_for_sentinel)
            size = 0
            for line in lines:
                size += len(line)
                if size > limit_bytes:
                    out.append(f"{stream}: Logs were truncated because the total bytes size exceeds the limit")
                    break
                out.append(f"{stream}: {line}")
        return out

    async def _read_stream(self, path: str, wait_for_sentinel: bool,
                           timeout: float = 2.0) -> List[str]:
        deadline = asyncio.get_event_loop().time() + timeout
        while True:
            try:
                with open(path, "r", errors="replace") as f:
                    f.seek(self._log_offsets[path])
                    content = f.read()
            except OSError:
                return []
            if ACTIVATION_LOG_SENTINEL in content or not wait_for_sentinel:
                head, _, _ = content.partition(ACTIVATION_LOG_SENTINEL + "\n")
                if ACTIVATION_LOG_SENTINEL in content:
                    self._log_offsets[path] += len(head) + len(ACTIVATION_LOG_SENTINEL) + 1
                else:
                    self._log_offsets[path] += len(content)
                    head = content
                return [l for l in head.splitlines() if l]
            if asyncio.get_event_loop().time() > deadline:
                return [l for l in content.splitlines() if l]
            await asyncio.sleep(0.02)


class ProcessContainerFactory(ContainerFactory):
    def __init__(self, logger=None, max_parallel_creates: int = 16):
        self.logger = logger
        self._create_sem = asyncio.Semaphore(max_parallel_creates)
        self._containers: List[ProcessContainer] = []

    async def create_container(self, transid, name: str, image: str,
                               memory: ByteSize, cpu_shares: int = 0,
                               action=None) -> ProcessContainer:
        async with self._create_sem:
            # the sandbox's socket, bound and listening before it starts
            listener = socket.socket()
            listener.bind(("127.0.0.1", 0))
            listener.listen()
            port = listener.getsockname()[1]
            fd_out, stdout_path = tempfile.mkstemp(prefix=f"ow-{name}-", suffix=".out")
            fd_err, stderr_path = tempfile.mkstemp(prefix=f"ow-{name}-", suffix=".err")
            # memory cap is applied by the proxy itself after exec (a parent
            # preexec_fn would fork() a multithreaded JAX process, which can
            # deadlock the child before exec); leave interpreter headroom
            env = dict(os.environ,
                       OW_MEMORY_LIMIT_BYTES=str(memory.bytes + 512 * 1024 * 1024),
                       OW_LISTEN_FD=str(listener.fileno()))
            # launch the proxy file directly (NOT -m): it is stdlib-only, so
            # this skips importing the parent package (aiohttp etc., ~2s)
            proxy_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                      "actionproxy.py")
            try:
                proc = await asyncio.create_subprocess_exec(
                    sys.executable, "-u", proxy_path, str(port),
                    stdout=fd_out, stderr=fd_err, start_new_session=True,
                    env=env, pass_fds=(listener.fileno(),),
                )
            finally:
                # the sandbox holds the socket now: its exit closes the port
                listener.close()
            os.close(fd_out)
            os.close(fd_err)
            c = ProcessContainer(proc, port, stdout_path, stderr_path,
                                 kind=image, memory=memory)
            self._containers.append(c)
            return c

    async def cleanup(self) -> None:
        for c in list(self._containers):
            try:
                await c.destroy()
            except (ContainerError, OSError):
                pass
        self._containers.clear()


class ProcessContainerFactoryProvider:
    @staticmethod
    def instance(invoker_name: str = "invoker0", logger=None,
                 **kwargs) -> ProcessContainerFactory:
        # invoker_name is part of the uniform SPI signature; process
        # sandboxes are per-instance, so it carries no state here
        return ProcessContainerFactory(logger=logger, **kwargs)
