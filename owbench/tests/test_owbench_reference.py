"""The NumPy reference against the port's plain CPU `BalancerCore`, driven
through the benchmark's own loop on a small fleet of each configuration's
shape: the same rows, decisions, forced flags and books, step by step."""
import json
import math

import numpy as np
import pytest

from conftest import BENCH
from owbench.lib.drive import Loop, StepInputs
from owbench.lib.traffic import Traffic
from owbench.reference import sharding
from owbench.reference.sharding import Reference, coprime_steps

SHAPES = ("ow10k-conc", "ow64k-default")


def _small(shape, n):
    cfg = json.loads((BENCH / "configs" / f"{shape}.json").read_text())
    cfg.update(invokers=n, action_slots=512, actions=300, namespaces=30,
               max_batch=64)
    return cfg


def _drive(shape, occupancy, n=300, steps=120, seed=2**33 + 5):
    from openwhisk_tpu_torch.controller.loadbalancer.tpu_balancer import (
        BalancerCore)
    cfg = _small(shape, n)
    mix = json.loads((BENCH / "traffic" / "fanout.json").read_text())
    mix.update(occupancy=occupancy, burst_rows=[4, 100], flap_every_steps=5,
               flap_down_share=0.02)
    traffic = Traffic(cfg, mix, seed)
    fleet = [cfg["invoker_memory_mb"]] * n
    kw = dict(managed_fraction=0.9, blackbox_fraction=0.1, max_batch=64,
              action_slots=512)
    inputs = StepInputs(traffic)
    port = Loop(BalancerCore(fleet, device="cpu", **kw), inputs,
                traffic.table)
    port.run(steps)
    ref = Reference(fleet, **kw)
    mirror = Loop(ref, inputs.replay(), traffic.table)
    mirror.run(steps)
    return port, mirror, ref


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("occupancy", (0.35, 1.2))
def test_reference_matches_port(shape, occupancy):
    port, mirror, ref = _drive(shape, occupancy)
    for k, (p, r) in enumerate(zip(port.results, mirror.results)):
        assert np.array_equal(p[2], r[2]), f"rows of step {k}"
        assert np.array_equal(p[0], r[0]), f"chosen of step {k}"
        assert np.array_equal(p[1], r[1]), f"forced of step {k}"
    free, conc, health = port.core.books()
    rf, rc, rh = ref.books()
    n = len(rf)
    assert np.array_equal(free[:n], rf) and not free[n:].any()
    assert np.array_equal(conc[:, :n], rc) and not conc[:, n:].any()
    assert np.array_equal(health[:n], rh) and not health[n:].any()
    forced = sum(int(r[1].sum()) for r in mirror.results)
    assert (forced > 0) == (occupancy > 1)


def test_resumed_walks_equal_walks_from_home(monkeypatch):
    """A walk that resumes where its pool's last one stopped places as a
    walk from home does, in an overloaded fleet where walks go deep."""
    _, resumed, ref = _drive("ow10k-conc", 1.2, steps=80)
    assert any(w[0] >= sharding.DEEP_WALK for w in ref._walks.values())
    monkeypatch.setattr(sharding, "DEEP_WALK", 1 << 40)
    _, fresh, _ = _drive("ow10k-conc", 1.2, steps=80)
    for a, b in zip(resumed.results, fresh.results):
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def _greedy(x):
    out = []
    for cur in range(1, x + 1):
        if math.gcd(cur, x) == 1 and all(math.gcd(cur, p) == 1 for p in out):
            out.append(cur)
    return out or [1]


@pytest.mark.parametrize("x", [1, 2, 9, 10, 64, 90, 97, 900, 1000, 4096])
def test_coprime_steps_equal_the_greedy_definition(x):
    assert coprime_steps(x) == _greedy(x)


def test_control_breaks_the_sequential_guarantee():
    """The control places every row of a step against the books of the
    step's start: in a hot fleet it over-commits invokers that the
    reference does not."""
    cfg = _small("ow10k-conc", 200)
    mix = json.loads((BENCH / "traffic" / "fanout.json").read_text())
    mix.update(occupancy=0.9, burst_rows=[4, 100])
    traffic = Traffic(cfg, mix, 11)
    fleet = [cfg["invoker_memory_mb"]] * 200
    kw = dict(managed_fraction=0.9, blackbox_fraction=0.1, max_batch=64,
              action_slots=512)
    inputs = StepInputs(traffic)
    exact = Loop(Reference(fleet, **kw), inputs, traffic.table)
    exact.run(40)
    control = Loop(Reference(fleet, sequential=False, **kw),
                   inputs.replay(), traffic.table)
    control.run(40)
    differ = sum(int((a[0] != b[0]).sum())
                 for a, b in zip(exact.results, control.results))
    assert differ > 0
    assert (control.core.free < 0).any() and not (exact.core.free < 0).any()


@pytest.mark.parametrize("down", [0, 3, 6, 7, 40, 18])
def test_forced_rotation_takes_the_first_healthy_invoker(down):
    """The rotation from a row's random start over an 18-invoker managed
    slice, with the first `down` invokers of it unhealthy: the scalar
    probes and the vectorised rest agree with the rotation's definition."""
    ref = Reference([1024] * 20, managed_fraction=0.9, blackbox_fraction=0.1,
                    max_batch=8, action_slots=4)
    rand = 11
    for t in range(down):
        ref.health[(rand + t) % 18] = ref._health[(rand + t) % 18] = False
    got = ref._rotate(0, 18, rand)
    assert got == (((rand + down) % 18, down) if down < 18 else (-1, 18))
