"""Placement policy models.

`sharding_policy` is the CPU implementation of the reference's
ShardingContainerPoolBalancer scheduling math: the lean and sharding
balancers' policy and the oracle the batched placement in
`openwhisk_tpu_torch.ops` is held against. Exports the names the JAX
package's `openwhisk_tpu.models` does.
"""
from .sharding_policy import (ShardingPolicyState, generate_hash,
                              pairwise_coprimes, schedule)

__all__ = ["ShardingPolicyState", "generate_hash", "pairwise_coprimes",
           "schedule"]
