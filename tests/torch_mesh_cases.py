"""Shared cases of the fleet-mesh tests (`test_torch_fleet_mesh.py` on the
CPU, `test_torch_fleet_mesh_cuda.py` on the card): each package's
entities, `tests/test_fleet_mesh.py`'s balancer traffic with fixed
activation ids, and the books of any balancer as numpy. Imports neither
package at module level.
"""
import asyncio
import types

import numpy as np
import torch


def books_of(st):
    """(free, conc [N, A], health) as numpy from JAX books, port books or
    the port's sharded books."""
    from openwhisk_tpu_torch.parallel.sharded_state import (ShardedState,
                                                            gather_state)
    if isinstance(st, ShardedState):
        st = gather_state(st)
    return tuple(np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t)
                 for t in (st.free_mb, st.conc_free, st.health))


def entities(side):
    if side == "jax":
        from openwhisk_tpu.controller.loadbalancer import HEALTHY
        from openwhisk_tpu.core import entity as E
        from openwhisk_tpu.messaging import (ActivationMessage,
                                             MemoryMessagingProvider)
        from openwhisk_tpu.utils.transaction import TransactionId
    else:
        from openwhisk_tpu_torch.controller.loadbalancer.base import HEALTHY
        from openwhisk_tpu_torch.core import entity as E
        from openwhisk_tpu_torch.messaging import (ActivationMessage,
                                                   MemoryMessagingProvider)
        from openwhisk_tpu_torch.utils.transaction import TransactionId
    return types.SimpleNamespace(E=E, HEALTHY=HEALTHY,
                                 Msg=ActivationMessage,
                                 Provider=MemoryMessagingProvider,
                                 Tx=TransactionId)


async def drive(side, bal, n_invokers=12, waves=3, per_wave=40, base=0):
    """`tests/test_fleet_mesh.py`'s `_drive`: register a fleet directly,
    publish the same traffic (fixed activation ids), and return the
    placements in publish order and the books."""
    x = entities(side)
    E = x.E
    placed = {}

    async def fake_send(msg, invoker):
        placed[msg.activation_id.asString] = invoker.instance

    bal.send_activation_to_invoker = fake_send
    for i in range(n_invokers):
        bal._status_change(E.InvokerInstanceId(i, user_memory=E.MB(2048)),
                           x.HEALTHY)
    ident = E.Identity.from_json({
        "subject": "guest", "namespace": {
            "name": "guest", "uuid": "23bc46b1-71f6-4ed5-8c54-816aa4f8c502"},
        "authkey": {"api_key": "23bc46b1-71f6-4ed5-8c54-816aa4f8c502:"
                               + "k" * 64},
        "rights": ["ACTIVATE"], "limits": {}})
    actions = []
    for i in range(10):
        a = E.ExecutableWhiskAction(
            E.EntityPath("guest"), E.EntityName(f"fm{i}"),
            E.CodeExec(kind="python:3", code="x"),
            limits=E.ActionLimits(E.TimeLimit(5000), E.MemoryLimit(
                E.MB([128, 256, 512][i % 3]))))
        a.rev = E.DocRevision("1-b")
        actions.append(a)
    ordered, k = [], base
    for _ in range(waves):
        msgs = []
        for i in range(per_wave):
            k += 1
            a = actions[i % 10]
            msgs.append(x.Msg(x.Tx(f"t{k}", start_wallclock=1.0),
                              a.fully_qualified_name, a.rev.rev, ident,
                              E.ActivationId(f"{k:032x}"),
                              E.ControllerInstanceId("0"), False, {}))
        ordered += [m.activation_id.asString for m in msgs]
        await asyncio.gather(*[bal.publish(actions[i % 10], m)
                               for i, m in enumerate(msgs)])
    return [placed[a] for a in ordered], books_of(bal.state)[0].tolist()
