"""The port's gated Kafka provider, run against the JAX package's.

Every case of `tests/test_kafka_backend.py` on both packages (`pkg`; see
`tests/torch_ported_cases.py`): the import gate (without `aiokafka` every
Kafka class raises the reference's RuntimeError), and the contract against
the fake aiokafka client. The real-client class keeps the `kafka` marker
and skips for the reference's reason. Besides: the provider resolves
through each package's SPI under the path its docs name.
"""
import importlib

import pytest

from tests.torch_ported_cases import ported

ported(globals(), "test_kafka_backend")


def test_the_spi_resolves_the_kafka_provider(pkg, monkeypatch):
    path = f"{pkg}.messaging.kafka:KafkaMessagingProvider"
    monkeypatch.setenv("CONFIG_whisk_spi_MessagingProvider", path)
    spi = importlib.import_module(f"{pkg}.spi")
    kafka = importlib.import_module(f"{pkg}.messaging.kafka")
    assert spi.get("MessagingProvider") is kafka.KafkaMessagingProvider
    if not kafka.HAVE_KAFKA:
        with pytest.raises(RuntimeError, match=rf"no kafka client library.*"
                           rf"Use the TCP bus \({pkg}\.messaging\.tcp\)"):
            kafka.KafkaMessagingProvider("127.0.0.1:9092")
