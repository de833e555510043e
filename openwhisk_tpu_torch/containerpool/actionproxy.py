"""Action proxy: the HTTP server inside an action "container".

This is the framework's equivalent of the runtime images' proxy (the contract
is documented by the reference's tools/actionProxy/invoke.py and
docs/actions-new.md): POST /init receives {"value": {code, main, binary,
env}}; POST /run receives {"value": args, ...activation context} and must
return the action result as JSON. After every /run the proxy prints the log
sentinel to stdout and stderr so the log collector can frame per-activation
logs.

Runs standalone: `python -m openwhisk_tpu_torch.containerpool.actionproxy <port>`.
Kept dependency-free (stdlib only) so it can be dropped into any image.

A copy of `openwhisk_tpu/containerpool/actionproxy.py`, except that it
serves the listening socket its container factory hands it in
`OW_LISTEN_FD` (process_factory binds it, so no other sandbox can draw
the same port) and binds `<port>` itself only without one.
"""
from __future__ import annotations

import io
import json
import os
import sys
import traceback
from contextlib import redirect_stderr, redirect_stdout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

SENTINEL = "XXX_THE_END_OF_A_WHISK_ACTIVATION_XXX"

_state = {"fn": None, "env": {}, "workdir": None}


class _InitRunGate:
    """Reader-writer gate for the ThreadingHTTPServer: /run requests run
    concurrently (intra-container concurrency), but a re-/init waits for
    in-flight runs to drain and blocks new ones — it evicts the previous
    zip's modules and deletes its workdir, which a concurrently executing
    old action could still be importing from."""

    def __init__(self):
        import threading

        self._cond = threading.Condition()
        self._runs = 0
        self._initing = False

    def begin_run(self) -> None:
        with self._cond:
            while self._initing:
                self._cond.wait()
            self._runs += 1

    def end_run(self) -> None:
        with self._cond:
            self._runs -= 1
            self._cond.notify_all()

    def begin_init(self) -> None:
        with self._cond:
            while self._initing:
                self._cond.wait()
            self._initing = True
            while self._runs:
                self._cond.wait()

    def end_init(self) -> None:
        with self._cond:
            self._initing = False
            self._cond.notify_all()


_gate = _InitRunGate()


def _compile_action(code: str, main: str):
    scope: dict = {}
    exec(compile(code, "<action>", "exec"), scope)  # noqa: S102 — this IS the sandbox body
    fn = scope.get(main)
    if not callable(fn):
        raise ValueError(f"Initialization has failed: no callable {main!r}")
    return fn


def _compile_binary_action(b64_zip: str, main: str):
    """Binary action: base64 zip with __main__.py, like the reference's
    python runtime (the zip may carry a package tree; it is extracted and
    put on sys.path so imports inside it resolve)."""
    import base64
    import tempfile
    import zipfile

    workdir = tempfile.mkdtemp(prefix="ow-action-")
    zip_path = os.path.join(workdir, "action.zip")
    with open(zip_path, "wb") as f:
        f.write(base64.b64decode(b64_zip))
    with zipfile.ZipFile(zip_path) as z:
        for member in z.namelist():  # refuse path traversal
            target = os.path.realpath(os.path.join(workdir, member))
            if not target.startswith(os.path.realpath(workdir) + os.sep):
                raise ValueError("zip entry escapes the action directory")
        z.extractall(workdir)
    entry = os.path.join(workdir, "__main__.py")
    if not os.path.exists(entry):
        raise ValueError("Initialization has failed: zip has no __main__.py")
    import shutil

    # Re-init: the previous zip's path entry and modules must not shadow
    # imports of the new code — but a failed re-init must leave the old
    # action fully working, so evict recoverably and clean up only after
    # the new archive compiles.
    prev = _state.get("workdir")
    evicted: dict = {}
    prev_in_path = prev is not None and prev in sys.path
    if prev is not None:
        if prev_in_path:
            sys.path.remove(prev)
        for name, mod in list(sys.modules.items()):
            if getattr(mod, "__file__", None) and \
                    str(mod.__file__).startswith(prev + os.sep):
                evicted[name] = sys.modules.pop(name)
    sys.path.insert(0, workdir)
    try:
        with open(entry) as f:
            fn = _compile_action(f.read(), main)
    except BaseException:
        if workdir in sys.path:
            sys.path.remove(workdir)
        for name, mod in list(sys.modules.items()):
            if getattr(mod, "__file__", None) and \
                    str(mod.__file__).startswith(workdir + os.sep):
                del sys.modules[name]
        if prev_in_path:
            sys.path.insert(0, prev)
        sys.modules.update(evicted)
        shutil.rmtree(workdir, ignore_errors=True)
        raise
    if prev is not None:
        shutil.rmtree(prev, ignore_errors=True)
    _state["workdir"] = workdir
    return fn


class Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # silence request logging
        pass

    def _reply(self, status: int, body: dict) -> None:
        data = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _read_json(self) -> dict:
        n = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(n) if n else b"{}"
        try:
            return json.loads(raw)
        except json.JSONDecodeError:
            return {}

    def do_POST(self):  # noqa: N802 — http.server API
        if self.path == "/init":
            self._init(self._read_json())
        elif self.path == "/run":
            self._run(self._read_json())
        else:
            self._reply(404, {"error": "unknown path"})

    def do_GET(self):  # noqa: N802
        self._reply(200 if _state["fn"] else 503, {"ok": _state["fn"] is not None})

    def _init(self, payload: dict) -> None:
        value = payload.get("value", {})
        code = value.get("code", "")
        main = value.get("main") or "main"
        _gate.begin_init()
        try:
            if value.get("binary"):
                _state["fn"] = _compile_binary_action(code, main)
            else:
                _state["fn"] = _compile_action(code, main)
            _state["env"] = value.get("env") or {}
            # export the init environment (e.g. __OW_API_KEY) so user code
            # can read it via os.environ, as in the real runtime images
            for k, v in _state["env"].items():
                os.environ[str(k)] = str(v)
            self._reply(200, {"ok": True})
        except Exception as e:  # noqa: BLE001 — report any user-code failure
            self._reply(502, {"error": f"Initialization has failed: {e}"})
        finally:
            _gate.end_init()

    def _run(self, payload: dict) -> None:
        _gate.begin_run()
        try:
            self._run_locked(payload)
        finally:
            _gate.end_run()

    def _run_locked(self, payload: dict) -> None:
        if _state["fn"] is None:
            self._reply(502, {"error": "cannot invoke an uninitialized action"})
            return
        args = payload.get("value") or {}
        # activation context -> env vars, as the runtime containers do
        for k, v in payload.items():
            if k != "value" and isinstance(v, str):
                os.environ["__OW_" + k.upper()] = v
        out, err = io.StringIO(), io.StringIO()
        try:
            with redirect_stdout(out), redirect_stderr(err):
                result = _state["fn"](args)
            if result is None:
                result = {}
            if not isinstance(result, dict):
                self._reply(502, {"error": "the action did not return a dictionary"})
            else:
                self._reply(200, result)
        except Exception:  # noqa: BLE001 — user code error -> application error
            err.write(traceback.format_exc())
            self._reply(502, {"error": "An error has occurred while running the action."})
        finally:
            # relay user logs + sentinel framing to the real stdout/stderr
            sys.stdout.write(out.getvalue())
            sys.stdout.write(SENTINEL + "\n")
            sys.stdout.flush()
            sys.stderr.write(err.getvalue())
            sys.stderr.write(SENTINEL + "\n")
            sys.stderr.flush()


def main() -> None:
    # memory cap: the process-level analogue of docker -m. Applied here (after
    # exec) rather than via a parent preexec_fn — fork hooks are unsafe in a
    # multithreaded parent (JAX), and the limit belongs to the sandbox anyway.
    limit = os.environ.get("OW_MEMORY_LIMIT_BYTES")
    if limit:
        try:
            import resource
            resource.setrlimit(resource.RLIMIT_AS, (int(limit), int(limit)))
        except (ValueError, OSError, ImportError):
            pass
    # per-connection handler threads get 4 MB stacks instead of the ~8 MB
    # default: the virtual stack counts against RLIMIT_AS (the sandbox
    # memory cap limits ADDRESS SPACE), and bursts of fresh connections
    # were exhausting it and wedging the accept loop. Not smaller: the
    # handler thread IS the user-code execution context, and C-stack-heavy
    # actions (deep json/re/pickle recursion) must raise catchable errors,
    # not overflow the thread stack
    import threading
    threading.stack_size(4 * 1024 * 1024)
    port = int(sys.argv[1]) if len(sys.argv) > 1 else 8080
    # optional bind host: a container runtime hands each sandbox its own
    # address (e.g. per-container loopback IPs); default matches the
    # process factory's 127.0.0.1
    host = sys.argv[2] if len(sys.argv) > 2 else "127.0.0.1"
    listen_fd = os.environ.pop("OW_LISTEN_FD", None)
    if listen_fd is None:
        server = ThreadingHTTPServer((host, port), Handler)
    else:
        # the container factory bound and listens on this socket already
        # (process_factory): serve it as it is
        import socket
        server = ThreadingHTTPServer((host, port), Handler,
                                     bind_and_activate=False)
        server.socket.close()
        server.socket = socket.socket(fileno=int(listen_fd))
        host, port = server.server_address = server.socket.getsockname()[:2]
        server.server_name, server.server_port = host, port
    print(f"action proxy listening on {host}:{port}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
