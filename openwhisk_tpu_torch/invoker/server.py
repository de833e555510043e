"""Invoker liveness HTTP server (ref BasicRasService /ping +
A copy of `openwhisk_tpu/invoker/server.py`.
DefaultInvokerServer in core/invoker)."""
from __future__ import annotations

from aiohttp import web


class InvokerServer:
    def __init__(self, invoker, port: int = 8085):
        self.invoker = invoker
        self.port = port
        self._runner = None

    async def start(self) -> None:
        app = web.Application()
        app.router.add_get("/ping", self._ping)
        self._runner = web.AppRunner(app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, "0.0.0.0", self.port)
        await site.start()

    async def _ping(self, request):
        return web.json_response("pong")

    async def stop(self) -> None:
        if self._runner:
            await self._runner.cleanup()


class DefaultInvokerServerProvider:
    @staticmethod
    def instance(invoker, port: int = 8085) -> InvokerServer:
        return InvokerServer(invoker, port)
