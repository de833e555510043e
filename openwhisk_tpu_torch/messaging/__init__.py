"""The controller <-> invoker bus: messages, the provider SPI, the
in-memory provider, the coalescing producer and the columnar batch wire
(copies of `openwhisk_tpu/messaging/`'s modules of the same names)."""
from .message import (AcknowledgementMessage, ActivationMessage,
                      CombinedCompletionAndResultMessage, CompletionMessage,
                      EventMessage, PingMessage, ResultMessage, parse_ack)
from .connector import (HEALTH_RETENTION_BYTES, HEALTH_TOPIC,
                        MessageConsumer, MessageFeed, MessageProducer,
                        MessagingProvider, decode_message, encode_message)
from .coalesce import (BusCoalesceConfig, CoalescingProducer,
                       export_coalesce_gauges, maybe_coalesce)
from .memory import MemoryMessagingProvider
