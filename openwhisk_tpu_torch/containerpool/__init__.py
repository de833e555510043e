"""The invoker's container plane: copies of `openwhisk_tpu/containerpool/`'s
modules of the same names, with the subprocess container factory. The
docker, kubernetes, YARN and Mesos factories are not ported yet."""
from .container import (Container, ContainerError, InitializationError,
                        RunResult, ACTIVATION_LOG_SENTINEL)
from .factory import ContainerFactory, ContainerPoolConfig
from .process_factory import (ProcessContainer, ProcessContainerFactory,
                              ProcessContainerFactoryProvider)
from .pool import ContainerPool, Run
from .proxy import ContainerProxy, ContainerData
from .logstore import ContainerLogStore, ContainerLogStoreProvider

__all__ = [n for n in dir() if not n.startswith("_")]
