"""The quality plane's shadow pass on a card, against its plain version.

Every test here needs a CUDA device and `nvcc` (the kernels build from
openwhisk_tpu_torch/csrc at first use); without a card each test skips
with the reason printed. Run it on the card with

    python -m pytest tests/test_torch_quality_cuda.py -q

The shadow pass of the balancer's penalized schedule (the repair kernel
under "auto"/"repair", the scan kernel under "scan") leaves the live books
bit-identical, counts its launches in the wrappers' `penalized_launches`,
and its decision vector equals the plain shadow's on the same inputs,
bit for bit. The scorer on the card makes no host sync and agrees with
the NumPy twin: integers exact, float sums within rtol 1e-5, atol 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openwhisk_tpu_torch.controller.loadbalancer import \
    tpu_balancer as TB  # noqa: E402
from openwhisk_tpu_torch.ops import decision_quality as Q  # noqa: E402
from openwhisk_tpu_torch.ops import placement as T  # noqa: E402
from openwhisk_tpu_torch.ops import placement_cuda as K  # noqa: E402
from torch_placement_cases import random_batch, random_books  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")


def _packed(rng, n, r, h, b):
    cols = random_batch(n, b, rng)
    rel = np.zeros((5, r), np.int32)
    rel[3] = 1
    health = np.zeros((3, h), np.int32)
    req = np.stack([np.asarray(c, np.int32) for c in cols])
    return np.concatenate([rel.ravel(), health.ravel(), req.ravel()])


@pytest.mark.parametrize("resolved,b", [("repair", 8), ("repair", 256),
                                        ("scan", 16)])
def test_shadow_pass_on_the_card(resolved, b):
    rng = np.random.RandomState(b)
    n, r, h = 5000, b, 8
    books = random_books(n, rng)
    live = T.placement_state_from_numpy(*books, device="cuda")
    before = [t.clone() for t in live]
    buf = torch.from_numpy(_packed(rng, n, r, h, b)).cuda()
    pen = torch.from_numpy(rng.randint(0, 2, n).astype(np.int32)).cuda()
    release = T.release_batch_vector if resolved == "repair" else \
        T.release_batch
    card = T.make_shadow_step_packed(
        release, TB.penalized_schedule(torch.device("cuda"), resolved))
    plain = T.make_shadow_step_packed(
        release, TB.penalized_schedule(torch.device("cpu"), resolved))
    K.reset_launch_counts()
    scratch = T.empty_books_like(live)
    got = card(live, buf, pen, r, h, b, scratch=scratch)
    torch.cuda.synchronize()
    kernel = (K.schedule_batch_repair_cuda if resolved == "repair"
              else K.schedule_batch_cuda)
    assert kernel.penalized_launches == kernel.launches == 1
    for t, t0 in zip(live, before):
        assert torch.equal(t, t0)
    want = plain(live, buf, pen, r, h, b)  # plain torch ops on the card
    torch.cuda.synchronize()
    assert kernel.launches == 1
    assert torch.equal(got, want)


def test_scorer_on_the_card_matches_the_twin():
    rng = np.random.RandomState(3)
    n, a, b, nb = 16384, 64, 256, 24
    free = rng.randint(0, 8192, n).astype(np.int32)
    conc = np.where(rng.rand(n, a) < 0.05, rng.randint(1, 4, (n, a)),
                    0).astype(np.int32)
    health = rng.rand(n) < 0.95
    ewma = np.where(rng.rand(n) < 0.7, rng.rand(n) * 500.0,
                    0.0).astype(np.float32)
    cap = np.full(n, 8192, np.int32)
    req = np.stack([np.asarray(c, np.int32)
                    for c in random_batch(n, b, rng)])
    req[5] %= a
    out = ((rng.randint(-1, n, b) + 1) << 2).astype(np.int32)
    sh = ((rng.randint(-1, n, b) + 1) << 2).astype(np.int32)
    dev = [torch.from_numpy(np.array(x)).cuda()
           for x in (free, conc, health, ewma, cap, req, out, sh)]
    step = Q.make_quality_step(nb)
    qs0 = Q.init_quality_state(n, nb, device="cuda")
    step(qs0, *dev)  # the first call copies the bucket bounds over
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # the step never syncs
    try:
        qs, summary = step(qs0, *dev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ref, ref_summary = Q.quality_step_np(
        Q.init_quality_state(n, nb, numpy=True), free, conc, health, ewma,
        cap, req, out, sh)
    host = Q.host_state(qs)
    for name in ("regret_hist", "counters", "inv_divergence"):
        np.testing.assert_array_equal(getattr(host, name),
                                      getattr(ref, name))
    np.testing.assert_allclose(host.inv_regret_ms, ref.inv_regret_ms,
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(summary.cpu().numpy(), ref_summary,
                               rtol=1e-5, atol=1e-4)
