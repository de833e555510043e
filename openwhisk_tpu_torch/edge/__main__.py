"""CLI: run the edge reverse-proxy as its own daemon (the nginx role).
A copy of `openwhisk_tpu/edge/__main__.py`.

  python -m openwhisk_tpu_torch.edge --port 8080 \
      --controllers http://127.0.0.1:3233 http://127.0.0.1:3234 \
      [--domain example.com] [--tls-cert c.pem --tls-key k.pem]
"""
from __future__ import annotations

import argparse
import asyncio
import ssl
from typing import Optional

from .proxy import EdgeProxy
from ..utils.tasks import wait_for_shutdown


def main() -> None:
    parser = argparse.ArgumentParser(description="OpenWhisk-TPU edge proxy")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--controllers", nargs="+", required=True,
                        help="controller base URLs, e.g. http://host:3233")
    parser.add_argument("--domain", default=None,
                        help="base domain for vanity web-action URLs")
    parser.add_argument("--tls-cert", default=None)
    parser.add_argument("--tls-key", default=None)
    parser.add_argument("--retry-attempts", type=int, default=0,
                        help="bounded upstream attempts per request "
                             "(0 = auto: two passes over the pool, min 4)")
    args = parser.parse_args()

    if bool(args.tls_cert) != bool(args.tls_key):
        parser.error("--tls-cert and --tls-key must be given together")
    ssl_ctx: Optional[ssl.SSLContext] = None
    if args.tls_cert:
        ssl_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ssl_ctx.load_cert_chain(args.tls_cert, args.tls_key)

    async def run():
        kwargs = {"domain": args.domain} if args.domain else {}
        if args.retry_attempts:
            kwargs["retry_attempts"] = args.retry_attempts
        # active/active partitioned controllers: route owner-first by the
        # same ring the controllers agree on (CONFIG_whisk_ha_activeActive;
        # --controllers must be listed in instance order). utils path, NOT
        # the loadbalancer re-export: the edge must stay torch-free
        from ..utils.partitions import ring_from_config
        ring = ring_from_config()
        if ring is not None:
            kwargs["ring"] = ring
            print(f"edge ring routing: {ring.n_partitions} partitions over "
                  f"{len(args.controllers)} controllers", flush=True)
        proxy = EdgeProxy.for_controllers(args.controllers, **kwargs)
        await proxy.start(host=args.host, port=args.port, ssl_context=ssl_ctx)
        scheme = "https" if ssl_ctx else "http"
        print(f"edge proxy on {scheme}://{args.host}:{args.port} -> "
              f"{', '.join(args.controllers)}", flush=True)
        try:
            await wait_for_shutdown()
        finally:
            await proxy.stop()

    asyncio.run(run())


if __name__ == "__main__":
    main()
