"""CLI: run the TCP bus broker. `python -m openwhisk_tpu_torch.messaging [--port]`
A copy of `openwhisk_tpu/messaging/__main__.py`.
"""
from __future__ import annotations

import argparse
import asyncio

from .tcp import TcpBusServer
from ..utils.tasks import wait_for_shutdown


def main() -> None:
    parser = argparse.ArgumentParser(description="OpenWhisk-TPU bus broker")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=4222)
    args = parser.parse_args()

    async def run():
        server = TcpBusServer(args.host, args.port)
        await server.start()
        print(f"bus broker listening on {args.host}:{args.port}", flush=True)
        try:
            await wait_for_shutdown()
        finally:
            await server.stop()

    asyncio.run(run())


if __name__ == "__main__":
    main()
