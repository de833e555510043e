"""owdeploy: cluster deployment tool — the ansible playbooks' role.
A copy of `openwhisk_tpu/tools/deploy.py`.

The reference deploys with ansible (ansible/openwhisk.yml:18-34: zookeeper ->
kafka -> controllers -> invokers -> nginx edge) parameterized by
ansible/group_vars/all. This tool consumes the same shape of inventory (YAML
or JSON; see deploy/cluster.yaml) and either

  up / down / status    run the whole topology as supervised local processes
                        (bus broker -> invokers -> controllers -> edge),
                        pid-tracked under <rundir>;
  render systemd        emit one unit file per service for a systemd host;
  render k8s            emit Deployment/Service manifests for a cluster.

Limits and feature tunables from the inventory's `limits:`/`config:` maps are
exported as CONFIG_whisk_* environment variables, the same override channel
the reference uses (docs/concurrency.md:28-40 convention).

The services are the port's modules (`python -m openwhisk_tpu_torch....`).
A placing controller runs on the CUDA card; the inventory key
`controllers.device` ("cuda" or "cpu") becomes its `--device` flag (the JAX
package pins a controller's platform with JAX_PLATFORMS instead).
"""
from __future__ import annotations

import argparse
import json
import os
import shlex
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

DEFAULT_INVENTORY = {
    "rundir": "ow-run",
    "db": "whisks.db",
    "bus": {"host": "127.0.0.1", "port": 4222},
    "docstore": {"enabled": False, "host": "127.0.0.1", "port": 4223},
    "controllers": {"count": 1, "base_port": 3233, "balancer": "tpu"},
    "invokers": {"count": 1, "memory_mb": 2048, "prewarm": False},
    "edge": {"enabled": True, "port": 8080, "domain": ""},
    "monitoring": {"enabled": False, "port": 9096},
    "limits": {},   # e.g. invocationsPerMinute: 60  -> CONFIG_whisk_...
    "config": {},   # raw CONFIG_whisk_* overrides
}


def load_inventory(path: Optional[str]) -> dict:
    inv = json.loads(json.dumps(DEFAULT_INVENTORY))  # deep copy
    if path:
        with open(path) as f:
            if path.endswith((".yaml", ".yml")):
                import yaml
                loaded = yaml.safe_load(f) or {}
            else:
                loaded = json.load(f)
        for key, value in loaded.items():
            if isinstance(value, dict) and isinstance(inv.get(key), dict):
                inv[key].update(value)
            else:
                inv[key] = value
    return inv


#: limit keys the controller actually reads (controller/__main__.py); the
#: env channel splits on "_", so only camelCase spellings survive the
#: round-trip through config_from_env
KNOWN_LIMIT_KEYS = ("invocationsPerMinute", "concurrentInvocations",
                    "firesPerMinute")


def _camel(key: str) -> str:
    parts = key.split("_")
    return parts[0] + "".join(p[:1].upper() + p[1:] for p in parts[1:] if p)


def _config_env(inv: dict) -> Dict[str, str]:
    """Only the inventory-derived CONFIG_* keys (what renderers persist)."""
    env: Dict[str, str] = {}
    for k, v in inv.get("limits", {}).items():
        key = _camel(k)  # accept snake_case inventories
        if key not in KNOWN_LIMIT_KEYS:
            raise ValueError(
                f"inventory limits key {k!r} is not a recognized limit "
                f"(expected one of {', '.join(KNOWN_LIMIT_KEYS)})")
        env[f"CONFIG_whisk_limits_{key}"] = str(v)
    for k, v in inv.get("config", {}).items():
        key = k if k.startswith("CONFIG_") else f"CONFIG_whisk_{k}"
        env[key] = str(v)
    return env


def _env(inv: dict) -> Dict[str, str]:
    return {**os.environ, **_config_env(inv)}


def services(inv: dict, python: str = sys.executable,
             net: Optional[Dict[str, str]] = None) -> List[dict]:
    """The topology as an ordered service list (start order = list order).

    `net` overrides how services bind and find each other, for rendered
    targets where loopback is wrong: `bus_bind` (bus listen address),
    `bus_host` (address others dial the bus at), `controller_host` (format
    string with `{i}` for the edge's upstream list)."""
    net = net or {}
    bus = inv["bus"]
    bus_addr = f"{net.get('bus_host', bus['host'])}:{bus['port']}"
    ctrl_host = net.get("controller_host", "127.0.0.1")
    db = inv["db"]
    out = [{
        "name": "bus",
        "argv": [python, "-m", "openwhisk_tpu_torch.messaging",
                 "--host", net.get("bus_bind", bus["host"]),
                 "--port", str(bus["port"])],
    }]
    ds = inv.get("docstore") or {}
    if ds.get("enabled"):
        # the shared persistence service (CouchDB-equivalent): controllers
        # and invokers dial it instead of sharing a sqlite file path, which
        # is what makes genuinely multi-host topologies possible
        out.append({
            "name": "docstore",
            "argv": [python, "-m", "openwhisk_tpu_torch.database.remote_store",
                     "--db", db,
                     "--host", net.get("docstore_bind", ds.get("host", "127.0.0.1")),
                     "--port", str(ds.get("port", 4223))],
        })
        db = f"docstore://{net.get('docstore_host', ds.get('host', '127.0.0.1'))}:{ds.get('port', 4223)}"
    for i in range(inv["invokers"]["count"]):
        argv = [python, "-m", "openwhisk_tpu_torch.invoker", "--bus", bus_addr,
                "--db", db, "--unique-name", f"invoker-{i}",
                "--memory", str(inv["invokers"]["memory_mb"])]
        if inv["invokers"].get("prewarm"):
            argv.append("--prewarm")
        factory = inv["invokers"].get("container_factory")
        if factory:
            from ..containerpool.factory import FACTORY_PROVIDERS
            if factory not in FACTORY_PROVIDERS:
                raise ValueError(
                    f"invokers.container_factory must be one of "
                    f"{'/'.join(FACTORY_PROVIDERS)}, got {factory!r}")
            argv += ["--container-factory", factory]
        out.append({"name": f"invoker{i}", "argv": argv})
    n_ctrl = inv["controllers"]["count"]
    ctrl_urls = []
    for i in range(n_ctrl):
        port = inv["controllers"]["base_port"] + i
        ctrl_urls.append(f"http://{ctrl_host.format(i=i)}:{port}")
        argv = [python, "-m", "openwhisk_tpu_torch.controller", "--bus", bus_addr,
                "--host", net.get("controller_bind", "127.0.0.1"),
                "--db", db, "--port", str(port), "--instance", str(i),
                "--cluster-size", str(n_ctrl),
                "--balancer", inv["controllers"].get("balancer", "tpu")]
        # where a placing controller places: the card unless the inventory
        # says `controllers.device: cpu` (absent: no flag, the card)
        device = inv["controllers"].get("device")
        if device is not None:
            if device not in ("cuda", "cpu"):
                raise ValueError(f"controllers.device must be cuda or cpu, "
                                 f"got {device!r}")
            argv += ["--device", device]
        if i == 0 and inv["controllers"].get("seed_guest", True):
            argv.append("--seed-guest")
        # balancer checkpoint/resume (SURVEY §5.4): per-controller snapshot
        # files under the configured directory; restarts skip the warm-up
        # window instead of double-booking in-flight capacity
        snap_dir = inv["controllers"].get("snapshot_dir")
        interval = inv["controllers"].get("snapshot_interval")
        if interval is not None:
            if float(interval) <= 0:
                raise ValueError(
                    f"controllers.snapshot_interval must be > 0, "
                    f"got {interval!r}")
            if not snap_dir:
                raise ValueError(
                    "controllers.snapshot_interval is set but "
                    "controllers.snapshot_dir is not — no snapshots would "
                    "be written")
        if snap_dir:
            argv += ["--balancer-snapshot",
                     os.path.join(snap_dir, f"controller{i}.snap")]
            if interval is not None:
                argv += ["--balancer-snapshot-interval", str(interval)]
        out.append({"name": f"controller{i}", "argv": argv})
    mon = inv.get("monitoring") or {}
    if mon.get("enabled"):
        # the user-events service (ref core/monitoring/user-events): consumes
        # the events topic, serves Prometheus series on /metrics
        out.append({"name": "monitoring",
                    "argv": [python, "-m",
                             "openwhisk_tpu_torch.controller.monitoring",
                             "--bus", bus_addr,
                             "--port", str(mon.get("port", 9096))]})
    if inv["edge"].get("enabled", True):
        argv = [python, "-m", "openwhisk_tpu_torch.edge",
                "--port", str(inv["edge"]["port"]), "--controllers", *ctrl_urls]
        if inv["edge"].get("domain"):
            argv += ["--domain", inv["edge"]["domain"]]
        out.append({"name": "edge", "argv": argv})
    return out


# ------------------------------------------------------------------ local up
def up(inv: dict) -> None:
    rundir = inv["rundir"]
    os.makedirs(rundir, exist_ok=True)
    env = _env(inv)
    env.setdefault("PYTHONPATH", os.getcwd())
    started = []
    for svc in services(inv):
        log = open(os.path.join(rundir, f"{svc['name']}.log"), "ab")
        proc = subprocess.Popen(svc["argv"], stdout=log, stderr=log, env=env,
                                start_new_session=True)
        with open(os.path.join(rundir, f"{svc['name']}.pid"), "w") as f:
            f.write(str(proc.pid))
        started.append((svc["name"], proc.pid))
        print(f"started {svc['name']} (pid {proc.pid})")
        if svc["name"] in ("bus", "docstore"):
            time.sleep(1.0)  # services connect at boot; spine must be up first
    print(f"{len(started)} services up; logs + pids in {rundir}/")


def _pids(inv: dict) -> List[tuple]:
    rundir = inv["rundir"]
    out = []
    if not os.path.isdir(rundir):
        return out
    for fn in sorted(os.listdir(rundir)):
        if fn.endswith(".pid"):
            with open(os.path.join(rundir, fn)) as f:
                out.append((fn[:-4], int(f.read().strip())))
    return out


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except OSError:
        return False


def down(inv: dict) -> None:
    # reverse *start* order (edge -> controllers -> invokers -> bus) so the
    # front stops admitting traffic before the workers go away
    order = {s["name"]: i for i, s in enumerate(services(inv))}
    tracked = sorted(_pids(inv), key=lambda p: order.get(p[0], -1))
    for name, pid in reversed(tracked):
        if _alive(pid):
            try:
                os.killpg(os.getpgid(pid), signal.SIGTERM)
            except OSError:
                try:
                    os.kill(pid, signal.SIGTERM)
                except OSError:
                    pass  # exited between the liveness check and the signal
            print(f"stopped {name} (pid {pid})")
        os.unlink(os.path.join(inv["rundir"], f"{name}.pid"))


def status(inv: dict) -> bool:
    pids = _pids(inv)
    if not pids:
        print("no services running (no pid files)")
        return False
    all_up = True
    for name, pid in pids:
        up_ = _alive(pid)
        all_up &= up_
        print(f"{name}: {'up' if up_ else 'DOWN'} (pid {pid})")
    return all_up


# ------------------------------------------------------------------ renderers
def render_systemd(inv: dict, outdir: str) -> None:
    os.makedirs(outdir, exist_ok=True)
    env_lines = "".join(f"Environment={k}={v}\n"
                        for k, v in _config_env(inv).items())
    for svc in services(inv, python="/usr/bin/python3"):
        after = "network.target" if svc["name"] == "bus" else "ow-bus.service"
        unit = (f"[Unit]\nDescription=openwhisk-tpu {svc['name']}\n"
                f"After={after}\n\n"
                f"[Service]\nExecStart={shlex.join(svc['argv'])}\n"
                f"WorkingDirectory=/opt/openwhisk-tpu\n{env_lines}"
                "Restart=on-failure\nRestartSec=2\n\n"
                "[Install]\nWantedBy=multi-user.target\n")
        path = os.path.join(outdir, f"ow-{svc['name']}.service")
        with open(path, "w") as f:
            f.write(unit)
        print(f"wrote {path}")


def render_k8s(inv: dict, outdir: str) -> None:
    import yaml
    os.makedirs(outdir, exist_ok=True)
    # controller + invoker share one store: a ReadWriteMany PVC mounted at
    # /data (the local-up equivalent of pointing every service at one
    # sqlite path)
    docs = [{"apiVersion": "v1", "kind": "PersistentVolumeClaim",
             "metadata": {"name": "ow-shared-db"},
             "spec": {"accessModes": ["ReadWriteMany"],
                      "resources": {"requests": {"storage": "1Gi"}}}}]
    ports = {"bus": inv["bus"]["port"], "edge": inv["edge"]["port"],
             "docstore": (inv.get("docstore") or {}).get("port", 4223),
             "monitoring": (inv.get("monitoring") or {}).get("port", 9096)}
    # pods find each other via their Service DNS names, not loopback
    net = {"bus_bind": "0.0.0.0", "bus_host": "ow-bus",
           "controller_bind": "0.0.0.0", "controller_host": "ow-controller{i}",
           "docstore_bind": "0.0.0.0", "docstore_host": "ow-docstore"}
    db_file = os.path.basename(inv["db"])
    for svc in services(inv, python="python3", net=net):
        name = f"ow-{svc['name']}"
        argv = list(svc["argv"])
        pod_spec: dict = {}
        # a docstore:// URL needs no volume — only file-backed --db args
        # (every service in file mode; only the docstore pod in URL mode)
        needs_db_file = ("--db" in argv and
                         not argv[argv.index("--db") + 1].startswith("docstore://"))
        if needs_db_file:
            argv[argv.index("--db") + 1] = f"/data/{db_file}"
            pod_spec["volumes"] = [{"name": "shared-db",
                                    "persistentVolumeClaim":
                                        {"claimName": "ow-shared-db"}}]
        container = {"name": name, "image": "openwhisk-tpu:latest",
                     "command": argv,
                     "env": [{"name": k, "value": v}
                             for k, v in _config_env(inv).items()]}
        if needs_db_file:
            container["volumeMounts"] = [{"name": "shared-db",
                                          "mountPath": "/data"}]
        docs.append({"apiVersion": "apps/v1", "kind": "Deployment",
                     "metadata": {"name": name},
                     "spec": {"replicas": 1,
                              "selector": {"matchLabels": {"app": name}},
                              "template": {
                                  "metadata": {"labels": {"app": name}},
                                  "spec": {"containers": [container],
                                           **pod_spec}}}})
        port = ports.get(svc["name"])
        if svc["name"].startswith("controller"):
            port = inv["controllers"]["base_port"] + int(svc["name"][10:])
        if port:
            docs.append({"apiVersion": "v1", "kind": "Service",
                         "metadata": {"name": name},
                         "spec": {"selector": {"app": name},
                                  "ports": [{"port": port,
                                             "targetPort": port}]}})
    path = os.path.join(outdir, "openwhisk-tpu.yaml")
    with open(path, "w") as f:
        yaml.safe_dump_all(docs, f, sort_keys=False)
    print(f"wrote {path} ({len(docs)} manifests)")


def render_monitoring(inv: dict, outdir: str,
                      controller_host: str = "127.0.0.1",
                      monitoring_host: str = "127.0.0.1") -> None:
    """Prometheus scrape config + Grafana dashboard for the deployment
    (ref core/monitoring/user-events/compose: prometheus + the OpenWhisk
    Grafana dashboards). Controllers expose balancer metrics on /metrics;
    the user-events service (inventory `monitoring.enabled`) exposes the
    per-action series. Host args take a `{i}` format for multi-host
    topologies (e.g. "ow-controller{i}" under the k8s renderer's DNS)."""
    os.makedirs(outdir, exist_ok=True)
    n_ctrl = inv["controllers"]["count"]
    base = inv["controllers"]["base_port"]
    targets = [f"{controller_host.format(i=i)}:{base + i}"
               for i in range(n_ctrl)]
    scrapes = [
        "  - job_name: openwhisk-controllers\n"
        "    metrics_path: /metrics\n"
        "    static_configs:\n"
        f"      - targets: {json.dumps(targets)}\n"]
    mon = inv.get("monitoring") or {}
    if mon.get("enabled"):
        scrapes.append(
            "  - job_name: openwhisk-user-events\n"
            "    metrics_path: /metrics\n"
            "    static_configs:\n"
            f"      - targets: [\"{monitoring_host}:{mon.get('port', 9096)}\"]\n")
    prom = "global:\n  scrape_interval: 5s\nscrape_configs:\n" + "".join(scrapes)
    path = os.path.join(outdir, "prometheus.yml")
    with open(path, "w") as f:
        f.write(prom)
    print(f"wrote {path}")

    def panel(pid, title, exprs, y, unit="short", width=12, x=0):
        return {
            "id": pid, "title": title, "type": "timeseries",
            "gridPos": {"h": 8, "w": width, "x": x, "y": y},
            "fieldConfig": {"defaults": {"unit": unit}},
            "targets": [{"expr": e, "legendFormat": l, "refId": chr(65 + i)}
                        for i, (e, l) in enumerate(exprs)],
        }

    dashboard = {
        "title": "OpenWhisk-TPU",
        "uid": "openwhisk-tpu",
        "schemaVersion": 39,
        "refresh": "10s",
        "time": {"from": "now-1h", "to": "now"},
        "panels": [
            panel(1, "Activations/s by action",
                  [("sum by (action) "
                    "(rate(openwhisk_userevents_activations_total[1m]))",
                    "{{action}}")], 0),
            panel(2, "Cold starts/s",
                  [("sum(rate(openwhisk_userevents_cold_starts_total[1m]))",
                    "cold starts")], 0, x=12),
            panel(3, "Mean activation duration (ms)",
                  [("sum by (action) "
                    "(rate(openwhisk_userevents_duration_ms_sum[5m]))"
                    " / sum by (action) "
                    "(rate(openwhisk_userevents_duration_ms_count[5m]))",
                    "{{action}}")], 8, unit="ms"),
            panel(4, "Throttle rejections/s",
                  [("sum by (namespace, metric) "
                    "(rate(openwhisk_userevents_rate_limit_total[1m]))",
                    "{{namespace}} {{metric}}")], 8, x=12),
            panel(5, "Placements/s (TPU balancer)",
                  [("rate(openwhisk_loadbalancer_tpu_scheduled[1m])",
                    "scheduled"),
                   ("rate(openwhisk_loadbalancer_forced_placements[1m])",
                    "forced")], 16),
            panel(6, "Device step mean (ms)",
                  [("rate(openwhisk_loadbalancer_tpu_schedule_batch_ms_sum[5m])"
                    " / rate(openwhisk_loadbalancer_tpu_schedule_batch_ms_count[5m])",
                    "step")], 16, unit="ms", x=12),
        ],
    }
    path = os.path.join(outdir, "grafana-openwhisk.json")
    with open(path, "w") as f:
        json.dump(dashboard, f, indent=2)
    print(f"wrote {path}")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="OpenWhisk-TPU deployer")
    parser.add_argument("-i", "--inventory", default=None,
                        help="inventory file (yaml or json)")
    sub = parser.add_subparsers(dest="cmd", required=True)
    sub.add_parser("up")
    sub.add_parser("down")
    sub.add_parser("status")
    render = sub.add_parser("render")
    render.add_argument("target", choices=("systemd", "k8s", "monitoring"))
    render.add_argument("-o", "--outdir", default="deploy/out")
    args = parser.parse_args(argv)

    inv = load_inventory(args.inventory)
    if args.cmd == "up":
        up(inv)
    elif args.cmd == "down":
        down(inv)
    elif args.cmd == "status":
        return 0 if status(inv) else 1
    elif args.cmd == "render":
        renderer = {"systemd": render_systemd, "k8s": render_k8s,
                    "monitoring": render_monitoring}[args.target]
        renderer(inv, args.outdir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
