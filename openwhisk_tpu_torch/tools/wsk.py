"""wsk: the user CLI, speaking the REST API.
A copy of `openwhisk_tpu/tools/wsk.py`.

The framework's counterpart of the reference's `wsk` client (driven in its
system tests via WskCliOperations): action/trigger/rule/package/activation
operations over /api/v1.

  export WSK_APIHOST=http://127.0.0.1:3233 WSK_AUTH=<uuid>:<key>
  python -m openwhisk_tpu_torch.tools.wsk action create hello hello.py
  python -m openwhisk_tpu_torch.tools.wsk action invoke hello -p name TPU -b -r
"""
from __future__ import annotations

import argparse
import asyncio
import base64
import json
import os
import sys

import aiohttp


class WskClient:
    def __init__(self, apihost: str, auth: str):
        self.base = apihost.rstrip("/") + "/api/v1"
        self.headers = {
            "Authorization": "Basic " + base64.b64encode(auth.encode()).decode(),
            "Content-Type": "application/json",
        }

    async def request(self, method: str, path: str, body=None, params=None):
        try:
            async with aiohttp.ClientSession() as s:
                async with s.request(method, self.base + path, json=body,
                                     params=params or {}, headers=self.headers) as r:
                    try:
                        data = await r.json()
                    except aiohttp.ContentTypeError:
                        data = {"raw": await r.text()}
                    return r.status, data
        except aiohttp.ClientConnectionError as e:
            return 503, {"error": f"cannot reach API host {self.base}: {e}"}


def _params_to_dict(pairs):
    out = {}
    for k, v in pairs or []:
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
    return out


def _kv_list(d):
    return [{"key": k, "value": v} for k, v in d.items()]


def _feed_action_path(feed: str, ns: str):
    """Resolve a feed name to (namespace, action path): a leading slash
    means fully qualified (`/ns/name` or `/ns/pkg/name`); without it,
    `name` and `pkg/name` are relative to the caller's namespace and three
    segments are fully qualified (packages don't nest)."""
    qualified = feed.startswith("/")
    segs = [s for s in feed.strip("/").split("/") if s]
    if qualified and len(segs) < 2:
        raise ValueError(
            f"feed {feed!r}: a fully-qualified feed needs a namespace AND "
            "an action (/ns/name or /ns/pkg/name)")
    if qualified or len(segs) == 3:
        return segs[0], "/".join(segs[1:])
    return ns, "/".join(segs)


async def _invoke_feed(client, feed: str, lifecycle_event: str,
                       trigger_name: str, auth: str, params: dict):
    """Run the feed action with the standard feed-protocol arguments
    (lifecycleEvent, triggerName, authKey — ref docs/feeds.md:59-66)."""
    try:
        feed_ns, feed_path = _feed_action_path(feed, "_")
    except ValueError as e:
        return 400, {"error": str(e)}
    body = dict(params)
    body.update({"lifecycleEvent": lifecycle_event,
                 "triggerName": trigger_name, "authKey": auth})
    return await client.request(
        "POST", f"/namespaces/{feed_ns}/actions/{feed_path}", body,
        {"blocking": "true"})


async def run(args) -> int:
    apihost = args.apihost or os.environ.get("WSK_APIHOST", "http://127.0.0.1:3233")
    auth = args.auth or os.environ.get("WSK_AUTH", "")
    if not auth:
        print("error: no credentials (--auth or WSK_AUTH)", file=sys.stderr)
        return 2
    client = WskClient(apihost, auth)
    ns = "_"

    def show(status, data):
        try:
            print(json.dumps(data, indent=2))
        except BrokenPipeError:  # downstream pager/head closed the pipe
            try:
                sys.stdout.close()
            except OSError:
                pass
        return 0 if status < 400 else 1

    e = args.entity
    if e == "action":
        if args.cmd in ("create", "update"):
            if args.sequence and args.artifact:
                print("error: --sequence and a code artifact are mutually "
                      "exclusive", file=sys.stderr)
                return 2
            if args.sequence:
                # `wsk action create seq --sequence a,b,c` (reference CLI);
                # names resolve like feed references: leading slash =
                # qualified, else relative to the caller's namespace (so
                # `pkg/name` is a package in OUR namespace, not namespace
                # `pkg`)
                comps = []
                for raw in args.sequence.split(","):
                    c = raw.strip()
                    if not c:
                        print(f"error: empty component in --sequence "
                              f"{args.sequence!r}", file=sys.stderr)
                        return 2
                    try:
                        comp_ns, path = _feed_action_path(c, "_")
                    except ValueError as err:
                        print(f"error: {err}", file=sys.stderr)
                        return 2
                    comps.append(f"{comp_ns}/{path}")
                exec_ = {"kind": "sequence", "components": comps}
            elif args.artifact:
                code = open(args.artifact).read()
                kind = args.kind or ("python:3" if args.artifact.endswith(".py")
                                     else "nodejs:14")
                exec_ = {"kind": kind, "code": code}
            elif args.cmd == "update":
                exec_ = None  # field-only update inherits the stored exec
            else:
                print("error: an artifact file or --sequence is required",
                      file=sys.stderr)
                return 2
            # an update sends only the fields the user asked to change —
            # the API inherits everything omitted from the stored action
            body = {}
            if exec_ is not None:
                body["exec"] = exec_
            if args.cmd == "create" or args.param:
                body["parameters"] = _kv_list(_params_to_dict(args.param))
            if args.cmd == "create" or args.annotation or args.web:
                body["annotations"] = _kv_list(_params_to_dict(args.annotation))
            if args.web:
                if args.cmd == "update" and not args.annotation:
                    # --web alone must merge into the stored annotations, not
                    # wipe them (the API replaces the field when present)
                    st, doc = await client.request(
                        "GET", f"/namespaces/{ns}/actions/{args.name}")
                    if st == 200:
                        body["annotations"] = [
                            a for a in doc.get("annotations", [])
                            if a.get("key") != "web-export"]
                body["annotations"].append({"key": "web-export", "value": True})
            if args.memory:
                body.setdefault("limits", {})["memory"] = args.memory
            if args.timeout:
                body.setdefault("limits", {})["timeout"] = args.timeout
            params = {"overwrite": "true"} if args.cmd == "update" else {}
            return show(*await client.request(
                "PUT", f"/namespaces/{ns}/actions/{args.name}", body, params))
        if args.cmd == "invoke":
            params = {}
            if args.blocking:
                params["blocking"] = "true"
            if args.result:
                params["result"] = "true"
            return show(*await client.request(
                "POST", f"/namespaces/{ns}/actions/{args.name}",
                _params_to_dict(args.param), params))
        if args.cmd == "get":
            return show(*await client.request(
                "GET", f"/namespaces/{ns}/actions/{args.name}"))
        if args.cmd == "delete":
            return show(*await client.request(
                "DELETE", f"/namespaces/{ns}/actions/{args.name}"))
        if args.cmd == "list":
            return show(*await client.request("GET", f"/namespaces/{ns}/actions"))
    elif e == "activation":
        if args.cmd == "list":
            return show(*await client.request(
                "GET", f"/namespaces/{ns}/activations",
                params={"limit": str(args.limit)}))
        if args.cmd in ("get", "logs", "result"):
            suffix = "" if args.cmd == "get" else f"/{args.cmd}"
            return show(*await client.request(
                "GET", f"/namespaces/{ns}/activations/{args.name}{suffix}"))
    elif e == "trigger":
        if args.cmd in ("create", "update"):
            if args.feed and args.cmd == "update":
                # changing a feed means tearing one down and creating
                # another — not an in-place update (matches the wsk CLI)
                print("error: --feed is not supported on trigger update; "
                      "delete and re-create the trigger", file=sys.stderr)
                return 2
            # omit fields the user didn't pass: the controller keeps the
            # stored values on overwrite, so a bare `trigger update -p ...`
            # cannot erase the feed annotation
            body = {}
            if args.param:
                body["parameters"] = _kv_list(_params_to_dict(args.param))
            if args.annotation or args.feed:
                body["annotations"] = _kv_list(_params_to_dict(args.annotation))
            if args.feed:
                body["annotations"].append({"key": "feed", "value": args.feed})
            params = {"overwrite": "true"} if args.cmd == "update" else {}
            status, data = await client.request(
                "PUT", f"/namespaces/{ns}/triggers/{args.name}", body, params)
            if status < 400 and args.feed and args.cmd == "create":
                # the create+feed macro (ref docs/feeds.md, CLI behavior):
                # invoke the feed action with the CREATE lifecycle event; on
                # anything but a confirmed success (200) — failure, or a 202
                # blocking-invoke timeout whose outcome is unknown — roll
                # the trigger back so the two stay atomic
                fs, fd = await _invoke_feed(client, args.feed, "CREATE",
                                            f"/{ns}/{args.name}", auth,
                                            _params_to_dict(args.param))
                if fs != 200:
                    if fs == 202:
                        # outcome unknown: the slow CREATE may yet succeed
                        # provider-side, so best-effort tear it down before
                        # the trigger document (its handle) disappears
                        try:
                            await _invoke_feed(client, args.feed, "DELETE",
                                               f"/{ns}/{args.name}", auth, {})
                        except Exception as e:  # noqa: BLE001 — rollback must proceed
                            print(f"warning: feed teardown attempt failed: {e}",
                                  file=sys.stderr)
                    await client.request(
                        "DELETE", f"/namespaces/{ns}/triggers/{args.name}")
                    print(f"error: feed action did not succeed ({fs}); "
                          "trigger rolled back", file=sys.stderr)
                    return show(fs, fd) or 1
            return show(status, data)
        if args.cmd == "fire":
            return show(*await client.request(
                "POST", f"/namespaces/{ns}/triggers/{args.name}",
                _params_to_dict(args.param)))
        if args.cmd == "delete":
            # feed-annotated triggers tear their feed down first (DELETE
            # lifecycle event), then the trigger document goes
            gs, gd = await client.request(
                "GET", f"/namespaces/{ns}/triggers/{args.name}")
            feed = None
            if gs < 400:
                feed = next((a.get("value") for a in gd.get("annotations", [])
                             if a.get("key") == "feed"), None)
            feed_failed = False
            if feed:
                fs, _fd = await _invoke_feed(client, feed, "DELETE",
                                             f"/{ns}/{args.name}", auth, {})
                if fs >= 400:
                    feed_failed = True
                    print(f"warning: feed teardown failed ({fs}); the "
                          f"provider-side feed '{feed}' may still be live",
                          file=sys.stderr)
            rc = show(*await client.request(
                "DELETE", f"/namespaces/{ns}/triggers/{args.name}"))
            return 1 if feed_failed else rc
        if args.cmd in ("get", "list"):
            path = f"/namespaces/{ns}/triggers" + \
                ("" if args.cmd == "list" else f"/{args.name}")
            return show(*await client.request("GET", path))
    elif e == "rule":
        if args.cmd == "create":
            return show(*await client.request(
                "PUT", f"/namespaces/{ns}/rules/{args.name}",
                {"trigger": f"_/{args.trigger}", "action": f"_/{args.action}"}))
        if args.cmd in ("enable", "disable"):
            status = "active" if args.cmd == "enable" else "inactive"
            return show(*await client.request(
                "POST", f"/namespaces/{ns}/rules/{args.name}", {"status": status}))
        if args.cmd in ("get", "delete", "list"):
            method = {"get": "GET", "delete": "DELETE", "list": "GET"}[args.cmd]
            path = f"/namespaces/{ns}/rules" + \
                ("" if args.cmd == "list" else f"/{args.name}")
            return show(*await client.request(method, path))
    elif e == "package":
        if args.cmd in ("create", "update"):
            body = {"parameters": _kv_list(_params_to_dict(args.param))}
            params = {"overwrite": "true"} if args.cmd == "update" else {}
            return show(*await client.request(
                "PUT", f"/namespaces/{ns}/packages/{args.name}", body, params))
        if args.cmd == "bind":
            # wsk package bind PROVIDER BOUND_NAME [-p k v]: the binding
            # inherits the provider's parameters, overridden by -p
            # (ref Packages.scala binding semantics)
            if not (args.name and args.artifact):
                print("usage: wsk package bind <provider> <name> [-p k v]",
                      file=sys.stderr)
                return 2
            segs = [s for s in args.name.strip("/").split("/") if s]
            if len(segs) == 2:
                b_ns, b_name = segs
            elif len(segs) == 1:
                b_ns, b_name = ns, segs[0]
            else:
                print(f"error: invalid provider reference {args.name!r} "
                      "(want 'package' or '/namespace/package')",
                      file=sys.stderr)
                return 2
            body = {"binding": {"namespace": b_ns, "name": b_name},
                    "parameters": _kv_list(_params_to_dict(args.param))}
            return show(*await client.request(
                "PUT", f"/namespaces/{ns}/packages/{args.artifact}", body))
        if args.cmd in ("get", "delete", "list"):
            method = {"get": "GET", "delete": "DELETE", "list": "GET"}[args.cmd]
            path = f"/namespaces/{ns}/packages" + \
                ("" if args.cmd == "list" else f"/{args.name}")
            return show(*await client.request(method, path))
    elif e == "namespace":
        if args.cmd == "list":
            return show(*await client.request("GET", "/namespaces"))
    elif e == "api":
        # reference: wsk api create BASE_PATH API_PATH VERB ACTION — here the
        # positional slots map to name=basepath, artifact=relpath, with verb
        # and action from flags (ref core/routemgmt createApi)
        if args.cmd == "create":
            if not (args.name and args.artifact and args.verb and args.action):
                print("usage: wsk api create <basepath> <relpath> "
                      "--verb get --action <web-action>", file=sys.stderr)
                return 2
            apidoc = {"gatewayBasePath": args.name,
                      "gatewayPath": args.artifact,
                      "gatewayMethod": args.verb,
                      "action": {"name": args.action, "namespace": ns},
                      "responsetype": args.response_type}
            if args.apiname:
                apidoc["apiName"] = args.apiname
            return show(*await client.request(
                "POST", f"/namespaces/{ns}/apis", {"apidoc": apidoc}))
        if args.cmd in ("get", "list"):
            params = {}
            if args.name:
                params["basepath"] = args.name
            if args.artifact:
                params["relpath"] = args.artifact
            if args.verb:
                params["operation"] = args.verb
            return show(*await client.request(
                "GET", f"/namespaces/{ns}/apis", params=params))
        if args.cmd == "delete":
            if not args.name:
                print("usage: wsk api delete <basepath> [relpath] [--verb v]",
                      file=sys.stderr)
                return 2
            params = {"basepath": args.name}
            if args.artifact:
                params["relpath"] = args.artifact
            if args.verb:
                params["operation"] = args.verb
            return show(*await client.request(
                "DELETE", f"/namespaces/{ns}/apis", params=params))
    print("unknown command", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="wsk", description="OpenWhisk-TPU CLI")
    parser.add_argument("--apihost", default=None)
    parser.add_argument("--auth", "-u", default=None)
    parser.add_argument("entity", choices=("action", "activation", "trigger",
                                           "rule", "package", "api",
                                           "namespace"))
    parser.add_argument("cmd")
    parser.add_argument("name", nargs="?")
    parser.add_argument("artifact", nargs="?")
    parser.add_argument("--param", "-p", nargs=2, action="append", metavar=("K", "V"))
    parser.add_argument("--annotation", "-a", nargs=2, action="append",
                        metavar=("K", "V"))
    parser.add_argument("--kind", default=None)
    parser.add_argument("--sequence", default=None, metavar="A,B,C",
                        help="action create/update: comma-separated component "
                             "actions (creates a sequence)")
    parser.add_argument("--web", action="store_true")
    parser.add_argument("--memory", "-m", type=int, default=None)
    parser.add_argument("--timeout", "-t", type=int, default=None)
    parser.add_argument("--blocking", "-b", action="store_true")
    parser.add_argument("--result", "-r", action="store_true")
    parser.add_argument("--limit", "-l", type=int, default=30)
    parser.add_argument("--feed", default=None,
                        help="trigger create: feed action (name, pkg/name, "
                             "or /ns/pkg/name); invoked with the CREATE/"
                             "DELETE lifecycle events")
    parser.add_argument("--trigger", default=None, help="rule create: trigger name")
    parser.add_argument("--action", default=None,
                        help="rule/api create: target action name")
    parser.add_argument("--verb", default=None,
                        help="api: HTTP verb (get/post/...)")
    parser.add_argument("--apiname", default=None, help="api create: API name")
    parser.add_argument("--response-type", default="json",
                        help="api create: json|http|text|html|svg")
    args = parser.parse_args(argv)
    return asyncio.run(run(args))


if __name__ == "__main__":
    sys.exit(main())
