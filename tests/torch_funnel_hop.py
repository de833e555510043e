"""Measure the shared admission funnel's hop, in either package.

    python tests/torch_funnel_hop.py --package port --rate 250 --device cpu
    python tests/torch_funnel_hop.py --package jax --rate 250
    python tests/torch_funnel_hop.py --package port --rate 1000   # the card

Runs the package's own `multiproc_fixed_rate(rate, procs=2, shared=True)`
(16 invokers, 2.5 s a worker: the JAX package's `tools/loadgen.py`, or
the port's copy with `--device`) with its processes wrapped by this
script. The funnel process counts what the hop does: frames and rows
received, steps and rows a step, host syncs a step on its event loop, the
outcome frames' send time and how many are in flight at once, the
waterfall's stage medians, and the time from a row's frame arriving to
its outcome frames' sends. Each front end stamps its rows' sends and
outcomes. One JSON line: the merged result, the funnel process's counts,
and the medians of each row's segments across the hop (the processes of
one host share the monotonic clock).

Host syncs are counted where they are syncs: the port on the card
(torch's sync debug mode on "warn", on the loop's thread inside a step)
and the JAX package (host reads of device arrays inside a step). The
port's CPU path runs the plain folds, whose host reads are no syncs:
null there.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _modules(package):
    """(loadgen, funnel, tpu_balancer) of the package."""
    if package == "jax":
        import tools.loadgen as lg
        from openwhisk_tpu.controller.loadbalancer import funnel as F
        from openwhisk_tpu.controller.loadbalancer import tpu_balancer as TB
    else:
        from openwhisk_tpu_torch.controller.loadbalancer import funnel as F
        from openwhisk_tpu_torch.controller.loadbalancer import \
            tpu_balancer as TB
        from openwhisk_tpu_torch.tools import loadgen as lg
    return lg, F, TB


def _median(xs):
    return round(statistics.median(xs), 3) if xs else None


def _serve(package, out, argv):
    """The funnel process, counted; writes OUT as the receiver stops."""
    lg, F, TB = _modules(package)
    loop = threading.main_thread()
    st = {"steps": 0, "step_rows": 0, "syncs": 0, "frames": 0, "rows": 0,
          "send_ms": [], "in_flight": 0, "in_flight_max": 0,
          "arrive": {}, "placed": {}, "done": {}}
    in_step = [False]
    bals = []

    def sync():
        if in_step[0] and threading.current_thread() is loop:
            st["syncs"] += 1

    cuda = package == "port" and "--device" in argv and \
        argv[argv.index("--device") + 1] == "cuda"
    if package == "jax":
        from jax._src import array as JA
        value = JA.ArrayImpl._value
        JA.ArrayImpl._value = property(lambda self: (sync(),
                                                     value.fget(self))[1])
    elif cuda:
        import warnings

        import torch
        show = warnings.showwarning
        warnings.showwarning = lambda m, *a, **k: (
            sync() if "ynchroniz" in str(m) else show(m, *a, **k))
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
    else:
        st["syncs"] = None
    init, dispatch = TB.TpuBalancer.__init__, TB.TpuBalancer._dispatch_batch

    def bal_init(self, *a, **k):
        init(self, *a, **k)
        bals.append(self)

    def step(self):
        st["steps"] += 1
        st["step_rows"] += min(len(self._pending), self.max_batch)
        in_step[0] = True
        try:
            return dispatch(self)
        finally:
            in_step[0] = False

    TB.TpuBalancer.__init__, TB.TpuBalancer._dispatch_batch = bal_init, step
    consume, send_frame = F.FunnelReceiver._consume, F.FrameSender.send_frame

    async def timed_consume(self, payload):
        t = time.monotonic()
        _kind, frame = F.decode_batch(payload)
        st["frames"] += 1
        st["rows"] += len(frame.msgs)
        for m in frame.msgs:
            st["arrive"].setdefault(m.activation_id.asString, t)
        return await consume(self, payload)

    def timed_send(self, topic, message, outs=(), on_error=None):
        t = time.monotonic()
        for rec in getattr(message, "rows", ()):
            if rec.code == F.FUNNEL_PLACED:
                st["placed"].setdefault(rec.aid, t)
            elif rec.code == F.FUNNEL_COMPLETED:
                st["done"].setdefault(rec.aid, t)
        st["in_flight"] += 1
        st["in_flight_max"] = max(st["in_flight_max"], st["in_flight"])
        task = send_frame(self, topic, message, outs, on_error)

        def sent(_task):
            st["in_flight"] -= 1
            st["send_ms"].append((time.monotonic() - t) * 1e3)

        task.add_done_callback(sent)
        return task

    F.FunnelReceiver._consume, F.FrameSender.send_frame = (timed_consume,
                                                           timed_send)
    stop = F.FunnelReceiver.stop

    async def dumped_stop(self):
        wf = bals[0].waterfall if bals else None
        budget = wf.budget() if wf is not None and wf.enabled else {}
        arrive = st.pop("arrive")
        doc = dict(
            st, receiver=self.export_gauges(),
            send_ms_p50=_median(st.pop("send_ms")),
            stage_medians_ms=budget.get("stage_medians_ms"),
            arrive_to_placed_send_ms_p50=_median(
                [(t - arrive[a]) * 1e3 for a, t in st["placed"].items()
                 if a in arrive]),
            arrive_to_done_send_ms_p50=_median(
                [(t - arrive[a]) * 1e3 for a, t in st["done"].items()
                 if a in arrive]),
            arrive=arrive)
        with open(out, "w") as f:
            json.dump(doc, f)
        return await stop(self)

    F.FunnelReceiver.stop = dumped_stop
    sys.argv = ["loadgen", *argv]
    return lg.main() or 0


def _worker(package, out, argv):
    """A front end, its rows' sends and outcomes stamped; writes OUT as it
    closes."""
    lg, F, _TB = _modules(package)
    st = {"send": {}, "placed": {}, "done": {}}
    publish_many, on_ack, close = (F.FunnelBalancer.publish_many,
                                   F.FunnelBalancer._on_ack,
                                   F.FunnelBalancer.close)

    def stamped_publish(self, pairs):
        t = time.monotonic()
        for _a, m in pairs:
            st["send"].setdefault(m.activation_id.asString, t)
        return publish_many(self, pairs)

    async def stamped_ack(self, payload):
        t = time.monotonic()
        _kind, frame = F.decode_batch(payload)
        for o in frame.rows:
            key = {F.FUNNEL_PLACED: "placed", F.FUNNEL_COMPLETED: "done"}
            if o.code in key:
                st[key[o.code]].setdefault(o.aid, t)
        return await on_ack(self, payload)

    async def dumped_close(self):
        with open(out, "w") as f:
            json.dump(st, f)
        return await close(self)

    F.FunnelBalancer.publish_many = stamped_publish
    F.FunnelBalancer._on_ack = stamped_ack
    F.FunnelBalancer.close = dumped_close
    sys.argv = ["loadgen", *argv]
    return lg.main() or 0


SEGMENTS = (("front end sends -> funnel receives", "w.send", "f.arrive"),
            ("funnel receives -> placed outcome sent", "f.arrive", "f.placed"),
            ("placed outcome sent -> front end has it", "f.placed",
             "w.placed"),
            ("completed outcome sent -> front end has it", "f.done",
             "w.done"),
            ("front end sends -> completed at the front end", "w.send",
             "w.done"))


def measure(package, rate, device="cpu", procs=2, duration=2.5):
    """One shared-funnel run of `package` at `rate`, counted (see the
    module docstring); returns the JSON line's dict."""
    lg, _F, _TB = _modules(package)
    tmp = tempfile.mkdtemp(prefix="funnel-hop-")
    popen = subprocess.Popen
    me = os.path.abspath(__file__)

    def wrapped(cmd, *a, **k):
        cmd = list(cmd)
        if "--serve-funnel" in cmd:
            i = cmd.index("--serve-funnel")
            cmd = [sys.executable, me, "--serve-wrap", package,
                   os.path.join(tmp, "serve.json"), *cmd[i:]]
        elif "--funnel" in cmd:
            w = cmd[cmd.index("--worker-ident") + 1]
            cmd = [sys.executable, me, "--worker-wrap", package,
                   os.path.join(tmp, f"worker{w}.json"),
                   *cmd[cmd.index("--rate"):]]
        return popen(cmd, *a, **k)

    kw = dict(rate=rate, procs=procs, duration=duration, shared=True,
              n_invokers=16)
    if package == "port":
        kw["device"] = None if device == "cuda" else device
    subprocess.Popen = wrapped
    try:
        res = lg.multiproc_fixed_rate(**kw)
    finally:
        subprocess.Popen = popen
    with open(os.path.join(tmp, "serve.json")) as f:
        serve = json.load(f)
    stamps = {"f.arrive": serve.pop("arrive"), "f.placed": serve.pop("placed"),
              "f.done": serve.pop("done")}
    workers = []
    for w in range(procs):
        with open(os.path.join(tmp, f"worker{w}.json")) as f:
            workers.append(json.load(f))
    segments = {}
    for name, a, b in SEGMENTS:
        xs = []
        for w in workers:
            src = {"w.send": w["send"], "w.placed": w["placed"],
                   "w.done": w["done"], **stamps}
            xs += [(src[b][aid] - t) * 1e3 for aid, t in src[a].items()
                   if aid in src[b]]
        segments[name] = _median(xs)
    steps = serve["steps"]
    return dict(
        package=package, device=device if package == "port" else "cpu",
        offered_rate=rate, completed=res["completed"],
        sustained=res["sustained"],
        merged_per_sec=res["fleet_merged_sustained_per_sec"],
        p50_ms=res["p50_ms"], p99_ms=res["p99_ms"],
        workers_failed=[w.get("error") for w in res["per_worker"]],
        frames=serve["frames"], rows=serve["rows"],
        rows_a_frame=serve["rows"] / serve["frames"] if serve["frames"]
        else None,
        steps=steps, rows_a_step=serve["step_rows"] / steps if steps
        else None,
        syncs_a_step=(serve["syncs"] / steps if steps and serve["syncs"]
                      is not None else None),
        outcome_frames=serve["receiver"]["funnel_acks_sent"],
        outcome_frames_in_flight_max=serve["in_flight_max"],
        outcome_send_ms_p50=serve["send_ms_p50"],
        dup_rows=serve["receiver"]["funnel_dup_rows"],
        arrive_to_placed_send_ms_p50=serve["arrive_to_placed_send_ms_p50"],
        arrive_to_done_send_ms_p50=serve["arrive_to_done_send_ms_p50"],
        stage_medians_ms=serve["stage_medians_ms"], segments_ms_p50=segments)


def main():
    if sys.argv[1:2] in (["--serve-wrap"], ["--worker-wrap"]):
        fn = _serve if sys.argv[1] == "--serve-wrap" else _worker
        return fn(sys.argv[2], sys.argv[3], sys.argv[4:])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "port"), required=True)
    ap.add_argument("--rate", type=float, required=True)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument("--repeat", type=int, default=1)
    args = ap.parse_args()
    for _ in range(args.repeat):
        print(json.dumps(measure(args.package, args.rate, args.device)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
