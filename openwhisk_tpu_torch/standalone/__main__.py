"""CLI: python -m openwhisk_tpu_torch.standalone [--port 3233] [--db PATH]
[--device {cuda,cpu}] [--balancer-snapshot PATH] [--balancer-journal DIR].

Runs on the CUDA card unless `--device cpu` asks for the plain torch path;
without a card the default exits non-zero with the reason."""
from __future__ import annotations

import argparse
import asyncio
import json
import sys

from . import GUEST_KEY, GUEST_UUID, make_standalone
from ..utils.tasks import wait_for_shutdown


def preflight(port: int, manifest: dict = None,
              manifest_path: str = None) -> bool:
    """Boot-time environment checks (ref standalone PreFlightChecks): each
    prints one OK/FAIL line; returns False when any check fails. `manifest`
    is the already-parsed runtimes dict (main() reads the file exactly once
    and hands the same dict to the server, so what preflight validated is
    what runs)."""
    import shutil
    import socket

    from ..core.entity import ExecManifest

    ok = True

    def check(name, passed, hint=""):
        nonlocal ok
        print(f"  [{'OK' if passed else 'FAIL'}] {name}" +
              (f" — {hint}" if (hint and not passed) else ""))
        ok = ok and passed

    try:
        with socket.socket() as s:
            # match the server's bind semantics (asyncio sets SO_REUSEADDR),
            # else lingering TIME_WAIT sockets false-fail a quick restart
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", port))
        free = True
    except OSError:
        free = False
    check(f"port {port} available", free,
          "another process is listening — pick --port")
    check("python3 for action sandboxes",
          shutil.which("python3") is not None, "python3 not on PATH")
    manifest_ok = True
    if manifest is not None:
        try:
            ExecManifest.initialize(manifest)
            check(f"runtimes manifest {manifest_path or '(inline)'}", True)
        except Exception as e:  # noqa: BLE001 — ANY malformed shape is a
            # FAIL line, not a traceback (wrong structure raises
            # TypeError/AttributeError, not just ValueError)
            check(f"runtimes manifest {manifest_path or '(inline)'}", False,
                  str(e) or type(e).__name__)
            manifest_ok = False
    else:
        ExecManifest.initialize(None)
    if manifest_ok:
        print(f"  runtimes: {', '.join(ExecManifest.runtimes().kinds)}")
    return ok


def main() -> None:
    parser = argparse.ArgumentParser(
        description="Standalone OpenWhisk-TPU server (PyTorch port)")
    parser.add_argument("--port", type=int, default=3233)
    parser.add_argument("--db", type=str, default=None,
                        help="sqlite path for durable storage (default: in-memory)")
    parser.add_argument("--memory", type=int, default=2048,
                        help="invoker user memory (MB)")
    parser.add_argument("--prewarm", action="store_true",
                        help="start prewarm stem cells from the runtimes manifest")
    parser.add_argument("--balancer", choices=("tpu", "lean"), default="tpu",
                        help="load balancer: tpu (device placement kernels "
                             "on the card, the default here) or lean "
                             "(in-process dispatch, no device: the JAX "
                             "package's default)")
    parser.add_argument("--balancer-snapshot", default=None,
                        help="path for periodic balancer snapshots, "
                             "restored at boot; the final dump rides the "
                             "SIGTERM shutdown path")
    parser.add_argument("--balancer-snapshot-interval", type=float,
                        default=10.0)
    parser.add_argument("--balancer-journal", default=None,
                        help="write-ahead placement journal directory "
                             "(snapshot + tail replay at boot)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default=None,
                        help="where the balancer places: the CUDA card "
                             "(default) or the plain torch path on the CPU")
    parser.add_argument("--no-ui", action="store_true",
                        help="do not serve the /playground dev UI")
    parser.add_argument("--manifest", default=None,
                        help="runtimes manifest JSON file (default: built-in "
                             "python:3 + nodejs:14)")
    args = parser.parse_args()
    # the card unless --device cpu: fail before booting anything (the lean
    # balancer has no device)
    if args.balancer == "tpu":
        from ..ops.placement import resolve_device
        try:
            resolve_device(None if args.device == "cuda" else args.device)
        except RuntimeError as e:
            print(f"error: {e}", file=sys.stderr)
            raise SystemExit(1)

    # parse the manifest file exactly once; preflight and the server get
    # the same dict (no validate/run TOCTOU window)
    manifest = None
    if args.manifest:
        try:
            with open(args.manifest) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            print(f"error: cannot read manifest {args.manifest}: {e}",
                  file=sys.stderr)
            raise SystemExit(1)

    print("preflight:")
    if not preflight(args.port, manifest=manifest,
                     manifest_path=args.manifest):
        raise SystemExit(1)

    async def run():
        from ..utils.tracing import maybe_enable_zipkin
        zipkin = maybe_enable_zipkin("standalone")
        controller = None
        try:
            store = None
            if args.db:
                from ..database import open_store
                store = open_store(args.db)
            controller = await make_standalone(
                port=args.port, artifact_store=store,
                user_memory_mb=args.memory, prewarm=args.prewarm,
                balancer=args.balancer, ui=not args.no_ui,
                manifest=manifest, device=args.device,
                snapshot_path=args.balancer_snapshot,
                snapshot_interval=args.balancer_snapshot_interval,
                journal_dir=args.balancer_journal)
            device = getattr(controller.load_balancer, "device", "none")
            print(f"OpenWhisk-TPU standalone listening on :{args.port} "
                  f"(balancer={args.balancer}, device={device})", flush=True)
            print(f"  AUTH     {GUEST_UUID}:{GUEST_KEY}")
            print(f"  API      http://127.0.0.1:{args.port}/api/v1")
            if not args.no_ui:
                print(f"  UI       http://127.0.0.1:{args.port}/playground")
            sys.stdout.flush()
            await wait_for_shutdown()
        finally:
            if controller is not None:
                await controller.stop()
            if zipkin is not None:
                await zipkin.close()

    asyncio.run(run())


if __name__ == "__main__":
    main()
