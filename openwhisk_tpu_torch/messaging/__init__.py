"""The controller <-> invoker bus: messages, the provider SPI and the
in-memory provider (copies of `openwhisk_tpu/messaging/`'s modules of the
same names)."""
from .message import (AcknowledgementMessage, ActivationMessage,
                      CombinedCompletionAndResultMessage, CompletionMessage,
                      PingMessage, ResultMessage, parse_ack)
from .connector import (HEALTH_RETENTION_BYTES, HEALTH_TOPIC,
                        MessageConsumer, MessageFeed, MessageProducer,
                        MessagingProvider, decode_message, encode_message)
from .memory import MemoryMessagingProvider
