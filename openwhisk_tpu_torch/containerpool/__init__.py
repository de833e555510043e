"""The invoker's container plane: the pool, the proxy and the container
factories (process, docker, kubernetes, YARN, Mesos). A copy of
`openwhisk_tpu/containerpool/__init__.py`."""
from .container import (Container, ContainerError, InitializationError,
                        RunResult, ACTIVATION_LOG_SENTINEL)
from .factory import ContainerFactory, ContainerPoolConfig
from .process_factory import (ProcessContainer, ProcessContainerFactory,
                              ProcessContainerFactoryProvider)
from .docker_factory import DockerContainerFactory, docker_available
from .kubernetes_factory import (KubernetesClient, KubernetesClientConfig,
                                 KubernetesContainer,
                                 KubernetesContainerFactory, WhiskPodBuilder)
from .yarn_factory import YARNConfig, YARNContainerFactory
from .mesos_factory import MesosConfig, MesosContainerFactory
from .pool import ContainerPool, Run
from .proxy import ContainerProxy, ContainerData
from .logstore import ContainerLogStore, ContainerLogStoreProvider

__all__ = [n for n in dir() if not n.startswith("_")]
