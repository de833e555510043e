"""The domain model the load balancer and its messages need.

Copies of the modules of `openwhisk_tpu/core/entity/` (ids, sizes, names,
parameters, versions, limits, execs, actions, activations, identities):
plain Python, carried over unchanged so that the port never imports the
JAX package and its messages serialize byte for byte as the JAX
package's do.
"""
from .size import B, KB, MB, GB, ByteSize
from .semver import SemVer
from .ids import (ActivationId, BasicAuthenticationAuthKey, ControllerInstanceId,
                  DocInfo, DocRevision, InstanceId, InvokerInstanceId, Secret,
                  Subject, UUID)
from .names import (DEFAULT_NAMESPACE, EntityName, EntityPath,
                    FullyQualifiedEntityName)
from .parameters import MalformedEntity, Parameters, ParameterValue
from .limits import (ActionLimits, ConcurrencyLimit, LimitViolation, LogLimit,
                     MemoryLimit, TimeLimit)
from .exec import (BLACKBOX_KIND, SEQUENCE_KIND, BlackBoxExec, CodeExec, Exec,
                   ExecMetaData, SequenceExec)
from .entity import WhiskEntity
from .action import ExecutableWhiskAction, WhiskAction
from .activation import (APPLICATION_ERROR, DEVELOPER_ERROR, SUCCESS,
                         WHISK_INTERNAL_ERROR, ActivationResponse,
                         WhiskActivation)
from .identity import (ACTIVATE, ALL_RIGHTS, DELETE, PUT, READ, REJECT,
                       Identity, Namespace, UserLimits, WhiskAuthRecord)

__all__ = [n for n in dir() if not n.startswith("_")]
