"""SPI (service provider interface) machinery.
A copy of `openwhisk_tpu/spi.py`, with the defaults naming the port's
modules and a refusal of any implementation inside the JAX package.

Rebuild of the reference's SpiLoader (common/scala/.../spi/SpiLoader.scala:31-51
+ reference.conf:20-31): each extension point is a named key resolved to an
implementation factory. The ten reference extension points are reproduced so a
deployment can swap, e.g., the load balancer (`LoadBalancerProvider`) between
the CPU sharding balancer, the lean balancer, and the TPU balancer without
touching the controller (docs/spi.md:20-75).

Resolution order: explicit `bind()` > env var `CONFIG_whisk_spi_<Name>` >
registered default. Implementations are addressed as "module.path:AttrName".
"""
from __future__ import annotations

import importlib
import os
from typing import Any, Callable, Dict

# the reference extension points (reference.conf:20-31), plus the
# AttachmentStore seam (reference: S3AttachmentStoreProvider wired into the
# artifact store's attachment slot)
SPI_NAMES = (
    "AttachmentStoreProvider",
    "ArtifactStoreProvider",
    "ActivationStoreProvider",
    "MessagingProvider",
    "ContainerFactoryProvider",
    "LogStoreProvider",
    "LoadBalancerProvider",
    "EntitlementSpiProvider",
    "AuthenticationDirectiveProvider",
    "InvokerProvider",
    "InvokerServerProvider",
)

_DEFAULTS: Dict[str, str] = {
    "AttachmentStoreProvider": "openwhisk_tpu_torch.database.attachment_store:MemoryAttachmentStoreProvider",
    "ArtifactStoreProvider": "openwhisk_tpu_torch.database.memory_store:MemoryArtifactStoreProvider",
    "ActivationStoreProvider": "openwhisk_tpu_torch.database.activation_store:ArtifactActivationStoreProvider",
    "MessagingProvider": "openwhisk_tpu_torch.messaging.memory:MemoryMessagingProvider",
    "ContainerFactoryProvider": "openwhisk_tpu_torch.containerpool.process_factory:ProcessContainerFactoryProvider",
    "LogStoreProvider": "openwhisk_tpu_torch.containerpool.logstore:ContainerLogStoreProvider",
    "LoadBalancerProvider": "openwhisk_tpu_torch.controller.loadbalancer.tpu_balancer:TpuBalancerProvider",
    "EntitlementSpiProvider": "openwhisk_tpu_torch.controller.entitlement:LocalEntitlementProvider",
    "AuthenticationDirectiveProvider": "openwhisk_tpu_torch.controller.authentication:BasicAuthenticationProvider",
    "InvokerProvider": "openwhisk_tpu_torch.invoker.reactive:InvokerReactiveProvider",
    "InvokerServerProvider": "openwhisk_tpu_torch.invoker.server:DefaultInvokerServerProvider",
}

_bindings: Dict[str, Any] = {}


class SpiResolutionError(Exception):
    pass


def overridden(name: str) -> bool:
    """True when `name` resolves to something other than the library
    default — an explicit bind() or the CONFIG_whisk_spi_<Name> env var."""
    return name in _bindings or \
        bool(os.environ.get(f"CONFIG_whisk_spi_{name}"))


def bind(name: str, impl: Any) -> None:
    """Explicitly bind an SPI to an implementation (object or 'mod:attr')."""
    _bindings[name] = impl


def unbind(name: str) -> None:
    _bindings.pop(name, None)


def reset() -> None:
    _bindings.clear()


def _load(path: str) -> Any:
    mod, _, attr = path.partition(":")
    if not attr:
        raise SpiResolutionError(f"invalid SPI path {path!r} (want 'module:Attr')")
    if mod == "openwhisk_tpu" or mod.startswith("openwhisk_tpu."):
        # the port never imports the JAX package: name the port's module
        raise SpiResolutionError(
            f"SPI impl {path!r} lies in the JAX package openwhisk_tpu; "
            "openwhisk_tpu_torch loads only its own modules (name the "
            "openwhisk_tpu_torch counterpart, if it is ported)")
    try:
        return getattr(importlib.import_module(mod), attr)
    except (ImportError, AttributeError) as e:
        raise SpiResolutionError(f"cannot load SPI impl {path!r}: {e}") from e


def get(name: str) -> Any:
    """Resolve an SPI extension point to its implementation object.

    Mirrors SpiLoader.get[T] (SpiLoader.scala:31-43): singletons addressed by
    a config key, here CONFIG_whisk_spi_<Name>.
    """
    if name in _bindings:
        impl = _bindings[name]
        return _load(impl) if isinstance(impl, str) else impl
    env = os.environ.get(f"CONFIG_whisk_spi_{name}")
    if env:
        return _load(env)
    default = _DEFAULTS.get(name)
    if default is None:
        raise SpiResolutionError(f"unknown SPI extension point {name!r}")
    return _load(default)


def register_default(name: str, path: str) -> None:
    _DEFAULTS[name] = path
