"""Hand-written Hopper kernels for the placement schedule.

The counterpart of `openwhisk_tpu/ops/placement_pallas.py`:

  `schedule_batch_cuda`        — csrc/placement_scan.cu, the sequential scan
                                 on one thread-block cluster, each invoker
                                 column owned by one thread (replaces
                                 `schedule_batch_pallas`)
  `schedule_batch_repair_cuda` — csrc/placement_repair.cu, speculate-and-
                                 repair on a persistent cooperative grid
                                 (replaces `schedule_batch_repair_pallas`)

Both take the state in the kernel layout (`to_transposed`: conc as [A, N],
read through its strides, so one slot's row is contiguous) and keep the
Pallas functions' contracts: (state, chosen, forced) for the scan and
(state, chosen, forced, rounds) for the repair, bit-exact with the plain
`schedule_batch` / `schedule_batch_repair` in ops/placement.py. The books
are updated IN PLACE (the Pallas kernels aliased them); `penalty` is an
optional int32[N] passed to the kernel as a nullable pointer.

For a CUDA tensor a wrapper launches its kernel or raises; it takes the
plain version only for tensors on the CPU. Each wrapper counts its
launches in `.launches`.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import _build
from .placement import (I32, PlacementState, RequestBatch, schedule_batch,
                        schedule_batch_repair)

#: per-row shared memory of the repair kernel (REPAIR_ROW_INTS +
#: LIST_ROW_INTS int32s in csrc/placement_repair.cu), its per-row scratch in
#: device memory (REPAIR_SCRATCH_ROW_BYTES there, plus a 12-byte header),
#: and the rows its block 0 holds (one thread each)
REPAIR_ROW_BYTES = (22 + 2) * 4
REPAIR_SCRATCH_ROW_BYTES = 28
REPAIR_MAX_BATCH = REPAIR_THREADS = 1024
#: the scan's largest fleet (SCAN_MAX_N in csrc/placement_scan.cu): the
#: `_mulmod` contract's 2^17 invokers, 8 columns a thread on a cluster of
#: 16 blocks x 1,024 threads
SCAN_MAX_N = 1 << 17
SCAN_THREADS = 1024
#: shared memory one block may opt into on sm_90 (227 KB), less the
#: kernel's static shared memory and the list's one extra int
SMEM_BLOCK_BYTES = 232448 - 256

_VOIDP, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "scan": ("placement_scan", "placement_scan_launch",
             [_VOIDP, _INT, _VOIDP, _VOIDP, _VOIDP, _LL, _LL, _INT, _INT,
              _VOIDP, _VOIDP, _VOIDP, _VOIDP, ctypes.POINTER(_INT)]),
    "repair": ("placement_repair", "placement_repair_launch",
               [_VOIDP, _INT, _VOIDP, _VOIDP, _VOIDP, _LL, _LL, _INT, _INT,
                _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP,
                ctypes.POINTER(_INT)]),
}
_launchers: Dict[str, ctypes._CFuncPtr] = {}

#: the csrc sources of the kernels, for a caller that builds them up front
SOURCES = tuple(sig[0] for sig in _SIGNATURES.values())


def fits_scan(n: int) -> bool:
    """Can the scan kernel take a fleet of `n` invokers? Any batch width
    B >= 1 fits: the kernel stages the request matrix in chunks."""
    return 0 < n <= SCAN_MAX_N


def fits_smem_repair(batch: int) -> bool:
    """Can the repair kernel take a batch of `batch` rows? Its block 0
    keeps one thread and every block REPAIR_ROW_BYTES of shared memory per
    row."""
    return (0 < batch <= REPAIR_MAX_BATCH
            and batch * REPAIR_ROW_BYTES <= SMEM_BLOCK_BYTES)


def to_transposed(state: PlacementState) -> PlacementState:
    """Standard [N, A] state <-> kernel layout ([A, N] conc), as views.
    Involution."""
    return PlacementState(state.free_mb, state.conc_free.T, state.health)


def _launcher(kind: str):
    fn = _launchers.get(kind)
    if fn is None:
        lib_name, symbol, argtypes = _SIGNATURES[kind]
        fn = getattr(_build.load(lib_name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _launchers[kind] = fn
    return fn


def _check(state: PlacementState, batch: RequestBatch, penalty):
    """Validate what the kernels take; returns (n, a, b, reqs int32[9,B])."""
    free, conc, health = state
    dev = free.device
    n = free.shape[0]
    if conc.dim() != 2 or conc.shape[1] != n:
        raise ValueError(f"conc must be [A, N={n}] (kernel layout), got "
                         f"{tuple(conc.shape)}")
    for name, t, dtype in (("free_mb", free, I32), ("conc", conc, I32),
                           ("health", health, torch.bool)):
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} on {dev}, got "
                             f"{t.dtype} on {t.device}")
    if not (free.is_contiguous() and health.is_contiguous()
            and health.shape == (n,)):
        raise ValueError("free_mb and health must be contiguous [N]")
    if penalty is not None and (penalty.device != dev or penalty.dtype != I32
                                or penalty.shape != (n,)
                                or not penalty.is_contiguous()):
        raise ValueError(f"penalty must be contiguous int32[{n}] on {dev}")
    cols = list(batch[:8]) + [batch.valid.to(I32)]
    b = batch.valid.shape[0]
    for c in cols:
        if c.device != dev or c.shape != (b,) or c.dtype != I32:
            raise ValueError(f"request columns must be int32[{b}] on {dev}")
    return n, conc.shape[0], b, torch.stack(cols).contiguous()


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def schedule_batch_cuda(state: PlacementState, batch: RequestBatch,
                        penalty=None):
    """The scan schedule on the card (one launch of placement_scan.cu, one
    thread-block cluster); state in the kernel layout, books updated in
    place. Returns (state, chosen int32[B], forced bool[B]). Raises for a
    fleet the kernel cannot take (`fits_scan`) and for a launch the card
    refuses. `.cluster` holds the last launch's shape: blocks, threads a
    block, invoker columns a thread and prefetch depth."""
    if not state.free_mb.is_cuda:
        ts, chosen, forced = schedule_batch(to_transposed(state), batch,
                                            penalty)
        return to_transposed(ts), chosen, forced
    n, a, b, reqs = _check(state, batch, penalty)
    if not fits_scan(n):
        raise ValueError(f"scan kernel takes 1..{SCAN_MAX_N} invokers "
                         f"(SCAN_MAX_N, the _mulmod contract), got N={n}")
    chosen = torch.empty((b,), dtype=I32, device=reqs.device)
    forced = torch.empty((b,), dtype=I32, device=reqs.device)
    if b:
        shape = (_INT * 3)()
        rc = _launcher("scan")(
            reqs.data_ptr(), b, state.health.data_ptr(),
            state.free_mb.data_ptr(), state.conc_free.data_ptr(),
            state.conc_free.stride(0), state.conc_free.stride(1), n, a,
            _ptr(penalty), chosen.data_ptr(), forced.data_ptr(),
            torch.cuda.current_stream(reqs.device).cuda_stream, shape)
        if rc != 0:
            raise RuntimeError(f"placement_scan launch failed: CUDA error "
                               f"{rc}")
        schedule_batch_cuda.launches += 1
        schedule_batch_cuda.cluster = {
            "blocks": shape[0], "threads": SCAN_THREADS,
            "columns_per_thread": shape[1], "prefetch_depth": shape[2]}
    return state, chosen, forced.bool()


schedule_batch_cuda.launches = 0
schedule_batch_cuda.cluster = None


def schedule_batch_repair_cuda(state: PlacementState, batch: RequestBatch,
                               penalty=None):
    """The speculate-and-repair schedule on the card (one cooperative
    launch of placement_repair.cu, the whole round loop on the device);
    state in the kernel layout, books updated in place. Returns (state,
    chosen int32[B], forced bool[B], rounds int32 scalar). Raises for a
    batch the kernel cannot hold (`fits_smem_repair`) and for a launch the
    card refuses. `.grid` holds the last launch's blocks and threads."""
    if not state.free_mb.is_cuda:
        ts, chosen, forced, rounds = schedule_batch_repair(
            to_transposed(state), batch, penalty)
        return to_transposed(ts), chosen, forced, rounds
    n, a, b, reqs = _check(state, batch, penalty)
    if not fits_smem_repair(b):
        raise ValueError(f"repair kernel takes 1..{REPAIR_MAX_BATCH} rows "
                         f"({REPAIR_ROW_BYTES} B of shared memory each), "
                         f"got B={b}")
    dev = reqs.device
    chosen = torch.empty((b,), dtype=I32, device=dev)
    forced = torch.empty((b,), dtype=I32, device=dev)
    rounds = torch.empty((1,), dtype=I32, device=dev)
    scratch = torch.empty(((REPAIR_SCRATCH_ROW_BYTES * b + 12 + 7) // 8,),
                          dtype=torch.int64, device=dev)
    blocks = ctypes.c_int(0)
    rc = _launcher("repair")(
        reqs.data_ptr(), b, state.health.data_ptr(),
        state.free_mb.data_ptr(), state.conc_free.data_ptr(),
        state.conc_free.stride(0), state.conc_free.stride(1), n, a,
        _ptr(penalty), chosen.data_ptr(), forced.data_ptr(),
        rounds.data_ptr(), scratch.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"placement_repair launch failed: CUDA error {rc}")
    schedule_batch_repair_cuda.launches += 1
    schedule_batch_repair_cuda.grid = {"blocks": blocks.value,
                                       "threads": REPAIR_THREADS}
    return state, chosen, forced.bool(), rounds.reshape(())


schedule_batch_repair_cuda.launches = 0
schedule_batch_repair_cuda.grid = None


def reset_launch_counts() -> None:
    schedule_batch_cuda.launches = 0
    schedule_batch_repair_cuda.launches = 0
