"""The port's journal, replay and snapshot on a CUDA card. Every test here
needs a card and `nvcc` (the placement kernels build from
openwhisk_tpu_torch/csrc at first use); without a card the whole file is
skipped with the reason printed. Run it on the card with
    python -m pytest tests/test_torch_journal_cuda.py -q
Comparisons are bit-exact.
"""
import asyncio
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openwhisk_tpu_torch.controller.loadbalancer import \
    checkpoint as TC  # noqa: E402
from openwhisk_tpu_torch.controller.loadbalancer import \
    journal as TJ  # noqa: E402
from openwhisk_tpu_torch.controller.loadbalancer.tpu_balancer import \
    TpuBalancer  # noqa: E402
from openwhisk_tpu_torch.core import entity as E  # noqa: E402
from openwhisk_tpu_torch.messaging import MemoryMessagingProvider  # noqa: E402
from openwhisk_tpu_torch.ops import placement_cuda as K  # noqa: E402
from openwhisk_tpu_torch.messaging import PingMessage  # noqa: E402
from test_torch_balancer_front import (CTRL, INITIAL_PAD, MAX_BATCH,  # noqa: E402
                                       RATE, SLOTS, _port_package, _scenario,
                                       make_action, make_msg, run)

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")


async def _card_balancer(n_invokers=4, **kw):
    """A balancer on the card with `n_invokers` healthy rows (pings only:
    nothing acks)."""
    provider = MemoryMessagingProvider()
    bal = TpuBalancer(provider, CTRL, device="cuda", managed_fraction=1.0,
                      blackbox_fraction=0.0, **kw)
    await bal.start()
    producer = provider.get_producer()
    for i in range(n_invokers):
        await producer.send("health", PingMessage(
            E.InvokerInstanceId(i, user_memory=E.MB(4096))))
    while not (len(bal._registry) == n_invokers and all(bal._healthy)):
        await asyncio.sleep(0.01)
    return bal


def _offline(device):
    return TpuBalancer(MemoryMessagingProvider(), E.ControllerInstanceId("1"),
                       device=device, managed_fraction=0.75,
                       blackbox_fraction=0.25, max_batch=MAX_BATCH,
                       action_slots=SLOTS, initial_pad=INITIAL_PAD)


@pytest.mark.parametrize("rate", [None, RATE], ids=["no_rate", "rate"])
def test_card_journal_replays_on_the_card_and_the_cpu(rate, tmp_path,
                                                      monkeypatch):
    """The front's scenario on the card with a journal: its full history
    replays through the card's kernels and through the plain versions on
    the CPU to the live books, with no parity mismatch; on the card every
    replayed batch launches one schedule kernel (the scenario's buckets
    stay below 32, so the scan)."""
    monkeypatch.setattr(E.ConcurrencyLimit, "MAX", 16)
    jdir = str(tmp_path / "wal")
    card = types.SimpleNamespace(**vars(_port_package()))
    card.make = lambda provider, **kw: TpuBalancer(provider, CTRL,
                                                   device="cuda", **kw)
    live = run(_scenario(card, rate, True, 38,
                         setup=lambda bal: bal.attach_journal(
                             TJ.PlacementJournal(jdir)),
                         inspect=lambda bal: bal.journal.close()), 120)

    async def replay(device):
        bal = _offline(device)
        K.reset_launch_counts()
        stats = bal.replay_journal(TJ.PlacementJournal(jdir).records(0))
        torch.cuda.synchronize()
        launches = (K.schedule_batch_cuda.launches,
                    K.schedule_batch_repair_cuda.launches)
        books = [t.cpu().numpy() for t in (bal.state.free_mb,
                                           bal.state.conc_free)]
        await bal.close()
        return stats, books, launches

    for device in ("cuda", "cpu"):
        stats, books, launches = run(replay(device))
        assert stats["parity_mismatches"] == 0 and stats["batches"] > 0
        np.testing.assert_array_equal(books[0], live["free"])
        np.testing.assert_array_equal(books[1], live["conc"])
        if device == "cuda":
            assert sum(launches) == stats["batches"] and launches[0] > 0, \
                launches
        else:
            assert launches == (0, 0)


def test_snapshot_parts_between_two_dispatched_steps_on_the_card(
        monkeypatch):
    monkeypatch.setattr(E.ConcurrencyLimit, "MAX", 16)
    conc = make_action("conc", memory=256)
    conc.limits.concurrency = E.ConcurrencyLimit(4)
    plain = make_action("plain", memory=128)

    async def go():
        bal = await _card_balancer(max_batch=8, pipeline_depth=4)
        ident = E.Identity.generate("guest")
        bal.publish_many([(a, make_msg(a, ident))
                          for a in [conc] * 5 + [plain] * 3])
        after_first = [t.clone() for t in (bal.state.free_mb,
                                           bal.state.conc_free)]
        parts = bal.snapshot_parts()
        bal.publish_many([(a, make_msg(a, ident))
                          for a in [conc] * 5 + [plain] * 3])
        assert bal._inflight_steps == 2
        after_second = bal.state.free_mb.clone()
        doc = await asyncio.to_thread(bal.snapshot, parts)
        await bal.close()
        return [t.cpu().numpy() for t in after_first], \
            after_second.cpu().numpy(), doc

    (free1, conc1), free2, doc = run(go())
    assert doc["free_mb"] == free1.tolist()
    assert doc["free_mb"] != free2.tolist()
    assert doc["conc_nonzero"] == [[int(i), int(j), int(conc1[i, j])]
                                   for i, j in zip(*np.nonzero(conc1))]
    assert doc["conc_nonzero"]


def test_conc_nonzero_round_trip_through_the_transposed_storage(tmp_path):
    """Random books on the card: the snapshot lists the non-zero
    concurrency cells in row-major (invoker, slot) order, and restore
    installs [A, N] storage with the [N, A] view on top."""
    path = str(tmp_path / "bal.snap")
    rng = np.random.RandomState(5)

    async def go():
        bal = _offline("cuda")
        n, a = bal._n_pad, bal.action_slots
        conc = np.where(rng.rand(n, a) < 0.2, rng.randint(1, 9, (n, a)), 0)
        bal.state.conc_free.copy_(torch.from_numpy(conc.astype(np.int32)))
        TC.write_snapshot(bal, path)
        cold = _offline("cuda")
        ok = TC.load_snapshot(cold, path)
        same = torch.equal(cold.state.conc_free, bal.state.conc_free)
        layout = (cold.state.conc_free.T.is_contiguous()
                  and cold.state.conc_free.is_cuda)
        await bal.close()
        await cold.close()
        return conc, ok, same, layout

    conc, ok, same, layout = run(go())
    assert ok and same and layout
    doc = json.load(open(path))
    assert doc["conc_nonzero"] == [[int(i), int(j), int(conc[i, j])]
                                   for i, j in zip(*np.nonzero(conc))]
