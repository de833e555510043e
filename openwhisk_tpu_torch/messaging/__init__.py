"""The controller <-> invoker bus: messages, the provider SPI, the
in-memory provider, the TCP bus and its broker, the gated Kafka provider
(`kafka.py`), the coalescing producer and the columnar batch wire (copies
of `openwhisk_tpu/messaging/`'s modules of the same names), and
`provider_for_bus`, the service mains' messaging bootstrap (a copy of the
JAX package's)."""
from .message import (AcknowledgementMessage, ActivationMessage,
                      CombinedCompletionAndResultMessage, CompletionMessage,
                      EventMessage, Message, PingMessage, ResultMessage,
                      parse_ack)
from .connector import (HEALTH_RETENTION_BYTES, HEALTH_TOPIC,
                        MessageConsumer, MessageFeed, MessageProducer,
                        MessagingProvider, decode_message, encode_message)
from .coalesce import (BusCoalesceConfig, CoalescingProducer,
                       export_coalesce_gauges, maybe_coalesce)
from .memory import MemoryMessagingProvider


def provider_for_bus(bus_addr: str) -> MessagingProvider:
    """Messaging bootstrap for the service mains (controller, invoker,
    monitoring): any MessagingProvider SPI override wins — an explicit
    `spi.bind()` (embedding/tests) or
    `CONFIG_whisk_spi_MessagingProvider=openwhisk_tpu_torch.messaging.kafka:KafkaMessagingProvider`
    (a module of this package; `spi` refuses the JAX package's) — with
    `--bus` handed to the implementation as its bootstrap address (Kafka:
    bootstrap servers; TCP: split host:port). Default: the built-in TCP bus
    at `--bus host:port`. A copy of the JAX package's function."""
    import inspect

    from .tcp import TcpMessagingProvider
    from .. import spi
    host, _, port = bus_addr.partition(":")
    if spi.overridden("MessagingProvider"):
        impl = spi.get("MessagingProvider")
        if isinstance(impl, MessagingProvider):
            return impl  # bound instance
        if isinstance(impl, type) and issubclass(impl, TcpMessagingProvider):
            return impl(host, int(port or 4222))
        # decide UP FRONT whether the provider takes a bootstrap address —
        # calling impl(bus_addr) and retrying impl() on TypeError would
        # swallow genuine TypeErrors raised INSIDE the constructor (bad
        # config) and silently instantiate without the address
        try:
            params = inspect.signature(impl).parameters.values()
            takes_addr = any(
                p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD,
                           p.VAR_POSITIONAL) for p in params)
        except (TypeError, ValueError):
            takes_addr = True  # C-level callables without signatures
        return impl(bus_addr) if takes_addr else impl()
    return TcpMessagingProvider(host, int(port or 4222))


__all__ = [n for n in dir() if not n.startswith("_")]
