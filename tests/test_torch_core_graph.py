"""`BalancerCore`'s step graphs (`BalancerCore._graphed_step`) on the CPU.

The graphed step reads its clock from an int32 slot of its static input,
as a 0-d float32 view of the slot's bits (`_static_args`): `admit_batch`,
and the whole packed admit step, decide and refill from that view as they
do from the float, clocks at float32 rounding boundaries included. The
graph counters exist and stay 0 on the CPU.

The graphs' bookkeeping (static input and staging, one graph an (R, H, B)
on the live books, the bucket state copied back, recapture after a books
swap, the eager fallback) runs here under a stand-in for `torch.cuda`:
its graph "captures" the step against the books and buckets it saw and
replays exactly that, so a replay into stale books would show. A CPU core
takes that path when its (card-only) dict of step graphs is set. The
card's own graphs: `test_torch_core_graph_cuda.py`.
"""
import contextlib
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openwhisk_tpu_torch.controller.loadbalancer import \
    tpu_balancer as TB  # noqa: E402
from openwhisk_tpu_torch.ops import placement as T  # noqa: E402
from openwhisk_tpu_torch.ops.throttle import (TokenBucketState,  # noqa: E402
                                              admit_batch, init_buckets)
from torch_graph_cases import (BATCHES, SWAP_AT, assert_same_run,  # noqa: E402
                               counter_steps, drive, expected_captures,
                               make_core, swap_books)

F32 = torch.float32
GRAPH_COUNTERS = ("graph_captures", "graph_replays", "graph_fallbacks")

#: clocks in seconds, as Python floats: plain ones, float32 ties (rounded
#: to even both ways), one float32 ulp above a value, and large magnitudes
CLOCKS = [0.0, 0.1, 1 / 3, 7.25,
          1.0 + 2.0 ** -24, 1.0 + 3 * 2.0 ** -24,
          16777216.0 + 1.0, 16777216.0 + 3.0,
          float(np.nextafter(np.float32(5.0), np.float32(6.0))),
          1e6 + 1 / 64 + 1e-9, 123456.789]


def _buckets(last_refill: float) -> TokenBucketState:
    base = init_buckets(8, 600, device="cpu")
    tokens = torch.tensor([0.5, 3.2, 599.0, 0.0, 1.999999, 7.0, 2.5, 600.0],
                          dtype=F32)
    return TokenBucketState(tokens, base.rate_per_s, base.burst,
                            torch.tensor(last_refill, dtype=F32))


def _bits(now) -> int:
    """The clock's float32 bits as the int32 its slot holds."""
    return int(np.float32(now).view(np.int32))


def _static(buf: np.ndarray, now) -> torch.Tensor:
    return torch.from_numpy(np.concatenate(
        [buf, np.array([_bits(now)], np.int32)]))


@pytest.mark.parametrize("now", CLOCKS)
def test_admit_batch_reads_the_clock_from_its_int32_slot(now):
    ns = torch.tensor([0, 1, 1, 2, 4, 4, 4, 3, 9, 1, 5, 6], dtype=torch.int32)
    valid = torch.ones(ns.shape[0], dtype=torch.bool)
    valid[3] = False
    prev = float(np.float32(now) - np.float32(0.75)) if now >= 1 else 0.0
    static = _static(np.zeros(5, np.int32), now)
    buf, view = TB._static_args(static, True)
    assert view.dim() == 0 and view.dtype == F32
    assert view.data_ptr() == static.data_ptr() + 5 * 4
    assert float(view) == float(np.float32(now))
    want, want_ok = admit_batch(_buckets(prev), now, ns, valid)
    got, got_ok = admit_batch(_buckets(prev), view, ns, valid)
    assert torch.equal(got_ok, want_ok)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the slot's next bits are the next clock the same view reads
    static[-1] = _bits(now + 1.0)
    assert float(view) == float(np.float32(now + 1.0))
    assert buf.shape == (5,)


def test_step_args_without_admission_pass_the_whole_input():
    static = torch.arange(7, dtype=torch.int32)
    buf, now = TB._static_args(static, False)
    assert buf is static and now is None


@pytest.mark.parametrize("now", [0.013, 16777216.0 + 1.0, 1.0 + 2.0 ** -24])
def test_packed_admit_step_reads_its_clock_slot(now):
    """The packed admit step on a static input (buffer, then the clock's
    bits) decides, books and refills as on the buffer and the float."""
    R = H = 8
    B = 16
    core = make_core("cpu", True)
    rows = [core.build_row(f"ns{k % 3}", f"ns{k % 3}/a{k % 5}", 128, 1,
                           False)[0] for k in range(B)]
    req = np.array(rows, np.int32).T
    rel = np.zeros((5, R), np.int32)
    rel[3] = 1
    buf = np.concatenate([rel.ravel(), np.zeros(3 * H, np.int32),
                          req.ravel()])
    step = T.make_fused_admit_step_packed()
    outs = []
    for args in ((torch.from_numpy(buf), np.float32(now)),
                 TB._static_args(_static(buf, now), True)):
        state = T.init_state(300, [2048] * 300, n_pad=512,
                             action_slots=64, device="cpu")
        buckets = init_buckets(TB.RATE_NS_BUCKETS, 3, device="cpu")
        (state, buckets), out = step((state, buckets), *args, R, H, B)
        outs.append((out, state, buckets))
    (o1, s1, b1), (o2, s2, b2) = outs
    assert torch.equal(o1, o2)
    assert all(torch.equal(x, y) for x, y in zip(s1, s2))
    assert all(torch.equal(x, y) for x, y in zip(b1, b2))
    assert ((o1[:B] >> 1) & 1).sum() > 0   # some rows were throttled


@pytest.mark.parametrize("admit", [False, True])
def test_graph_counters_exist_and_stay_zero_on_the_cpu(admit):
    core = make_core("cpu", admit)
    assert core._graph_shapes is None
    log = drive(core)
    assert all(log[-1][3][k] == 0 for k in GRAPH_COUNTERS)
    assert log[-1][3]["steps"] == len(BATCHES)


class _Graph:
    """A stand-in for `torch.cuda.CUDAGraph`: what `_packed_step` is asked
    while it "captures" is recorded against the books, buckets and step
    function of that moment, and each replay runs exactly that into the
    static output."""

    recording = None
    refuse = False

    def __init__(self):
        self.fn = self.out = None

    def capture_begin(self, capture_error_mode="global"):
        _Graph.recording = self

    def capture_end(self):
        _Graph.recording = None
        if _Graph.refuse:
            raise RuntimeError("stand-in capture refused")

    def replay(self):
        got = self.fn()
        self.out.resize_(got.shape).copy_(got)


class _Stream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def stand_in_cuda(monkeypatch):
    real_step = TB.BalancerCore._packed_step

    def packed_step(core, static, R, H, B):
        graph = _Graph.recording
        if graph is None:
            return real_step(core, static, R, H, B)
        seen = SimpleNamespace(state=core.state, _buckets=core._buckets,
                               _packed_fn=core._packed_fn)
        graph.fn = lambda: real_step(seen, static, R, H, B)
        graph.out = torch.empty(0, dtype=torch.int32)
        return graph.out

    monkeypatch.setattr(TB.BalancerCore, "_packed_step", packed_step)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(_Graph, "refuse", False)
    monkeypatch.setattr(_Graph, "recording", None)
    return _Graph


def _graphed_cpu_core(admit):
    core = make_core("cpu", admit)
    core._graph_shapes = {}
    return core


@pytest.mark.parametrize("admit", [False, True])
def test_stand_in_graphs_replay_the_eager_steps(stand_in_cuda, admit):
    kept = {}

    def swap(core, step):
        if step == SWAP_AT:
            kept["old"] = swap_books(core)
            kept["copy"] = tuple(t.clone() for t in kept["old"])

    got = drive(_graphed_cpu_core(admit), swap)
    want = drive(make_core("cpu", admit))
    assert_same_run(got, want)
    captures = expected_captures(got)
    assert counter_steps(got, "graph_captures") == captures
    assert counter_steps(got, "graph_replays") == [1 - c for c in captures]
    assert got[-1][3]["graph_fallbacks"] == 0
    if admit:
        assert got[-1][3]["throttled"] > 0
    # the books left behind at the swap were never written again
    assert all(torch.equal(a, b) for a, b in zip(kept["old"], kept["copy"]))


def test_a_refused_capture_runs_its_shape_eagerly(stand_in_cuda):
    stand_in_cuda.refuse = True
    core = _graphed_cpu_core(True)
    got = drive(core)
    assert_same_run(got, drive(make_core("cpu", True)))
    assert counter_steps(got, "graph_fallbacks") == [1] * len(BATCHES)
    assert got[-1][3]["graph_captures"] == got[-1][3]["graph_replays"] == 0
    assert {k[2] for k in core._capture_errors} == {
        b for *_, b in got}
