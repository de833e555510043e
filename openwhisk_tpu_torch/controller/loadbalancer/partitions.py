"""Active/active partition ring — implementation in utils/partitions.py.
A copy of `openwhisk_tpu/controller/loadbalancer/partitions.py`.

The ring is shared by the edge proxy, controller membership, and the
balancers; it lives in utils so the EDGE can import it without loading
the torch balancer stack this package's init pulls in. Controller-side
code keeps this import path for locality with membership/spillover.
"""
from ...utils.partitions import (ActiveActiveConfig, PartitionRing,
                                 active_active_config, ring_from_config)

__all__ = ["ActiveActiveConfig", "PartitionRing", "active_active_config",
           "ring_from_config"]
