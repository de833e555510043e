"""Sharding of the balancer's books over a fleet mesh of devices.

The counterpart of `openwhisk_tpu/parallel/`: the invoker axis of the
placement books is split over the devices of a mesh; each shard probes
its own rows, small exchanges onto the lead device elect the global
placement and read the winning cells' occupancy, and only the owner shard
commits. One process drives every shard (a single-controller mesh, as
the JAX package's `shard_map` is), so the balancer's event loop needs no
follower processes.
"""
from .sharded_state import (make_mesh, make_sharded_schedule,
                            make_sharded_release, shard_state)
from .fleet_mesh import (FLEET_AXIS, fleet_pair, make_fleet_mesh,
                         make_fleet_release_vector,
                         make_fleet_repair_schedule, mesh_axis, mesh_shards,
                         mesh_topology)

__all__ = ["make_mesh", "make_sharded_schedule", "make_sharded_release",
           "shard_state", "FLEET_AXIS", "make_fleet_mesh", "fleet_pair",
           "make_fleet_repair_schedule", "make_fleet_release_vector",
           "mesh_axis", "mesh_shards", "mesh_topology"]
