"""Hand-written Hopper kernels for the placement schedule.

The counterpart of `openwhisk_tpu/ops/placement_pallas.py`:

  `schedule_batch_cuda`        — csrc/placement_scan.cu, the sequential scan
                                 on one thread-block cluster, each invoker
                                 column owned by one thread (replaces
                                 `schedule_batch_pallas`)
  `schedule_batch_repair_cuda` — csrc/placement_repair.cu, speculate-and-
                                 repair on a persistent cooperative grid
                                 (replaces `schedule_batch_repair_pallas`)
  `release_batch_cuda`         — csrc/release_fold.cu, the release fold in
                                 one launch (replaces no Pallas kernel: the
                                 JAX package folds releases inside its XLA
                                 step; in torch ops the fold cost the loop
                                 milliseconds a step)

The schedules take the state in the kernel layout (`to_transposed`: conc
as [A, N], read through its strides, so one slot's row is contiguous) and
keep the Pallas functions' contracts: (state, chosen, forced) for the scan
and (state, chosen, forced, rounds) for the repair, bit-exact with the
plain `schedule_batch` / `schedule_batch_repair` in ops/placement.py;
`penalty` is an optional int32[N] passed to the kernel as a nullable
pointer. The release fold takes the books' [N, A] view and R release rows,
bit-exact with `release_batch`. The books are updated IN PLACE (the Pallas
kernels aliased them).

For a CUDA tensor a wrapper launches its kernel or raises; it takes the
plain version only for tensors on the CPU. Each wrapper counts its
launches in `.launches`, and of them the launches that carry a penalty
(the quality plane's shadow pass) in `.penalized_launches`.

`empty_launch_cuda` is a measurement hook, not part of any path: it
launches an empty kernel from the release kernel's library through the
same ctypes path, the floor that a fold's launch is timed against.

A kernel is built (nvcc) and loaded at its first launch, or ahead of it by
`prewarm()`: one worker-thread job a process that builds both sources,
loads them and resolves each launcher (the balancer's early build, which
then warms its step with launches inside `uncounted()`).
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import threading
from typing import Dict, Optional

import torch

from . import _build
from .placement import (I32, PlacementState, RequestBatch, release_batch,
                        schedule_batch, schedule_batch_repair)

#: per-row shared memory of the repair kernel (REPAIR_ROW_INTS +
#: LIST_ROW_INTS int32s in csrc/placement_repair.cu), its per-row scratch in
#: device memory (REPAIR_SCRATCH_ROW_BYTES there, plus a 12-byte header),
#: and the rows its block 0 holds (one thread each)
REPAIR_ROW_BYTES = (22 + 2) * 4
REPAIR_SCRATCH_ROW_BYTES = 28
REPAIR_MAX_BATCH = REPAIR_THREADS = 1024
#: the scan's largest padded fleet (SCAN_MAX_N in csrc/placement_scan.cu):
#: int32 indexing, with n + 2 (the no-key sentinel) still an int32. The
#: `_mulmod` contract bounds the partition (2^17), not the fleet; above
#: REGISTER_MAX_N the kernel's wide instance keeps each thread's further
#: columns in shared memory and streams the rest
SCAN_MAX_N = (1 << 31) - 3
REGISTER_MAX_N = 1 << 17
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
    "release": ("release_fold", "release_fold_launch",
                [_VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP, _INT, _VOIDP,
                 _VOIDP, _LL, _LL, _INT, _INT, _VOIDP]),
    "empty": ("release_fold", "release_fold_empty_launch", [_VOIDP]),
}
_launchers: Dict[str, ctypes._CFuncPtr] = {}

#: the csrc sources of the kernels, for a caller that builds them up front
SOURCES = tuple(dict.fromkeys(sig[0] for sig in _SIGNATURES.values()))
#: the release kernel keys a concurrency row by its cell, inv * A + slot,
#: in 53 bits (NO_CELL in csrc/release_fold.cu)
RELEASE_MAX_CELLS = 1 << 53


def fits_scan(n: int) -> bool:
    """Can the scan kernel take a padded fleet of `n` invokers? Any `n`
    that int32 indexing addresses, and any batch width B >= 1: the kernel
    stages the request matrix in chunks."""
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


def load_all() -> None:
    """Build every placement kernel (one nvcc a source, all started
    together), load each library and resolve each launcher, so that no
    later launch enters the build."""
    _build.build(SOURCES)
    for kind in _SIGNATURES:
        _launcher(kind)


#: per thread: launches made inside `uncounted()` add nothing to the counts
_counting = threading.local()


@contextlib.contextmanager
def uncounted():
    """Launches of this thread inside the block do not count (the early
    build's warm step on dummy books is no placement)."""
    _counting.off = True
    try:
        yield
    finally:
        _counting.off = False


def _counts() -> bool:
    return not getattr(_counting, "off", False)


_prewarm_lock = threading.Lock()
_prewarm_job: Optional[concurrent.futures.Future] = None


def prewarm() -> concurrent.futures.Future:
    """The process's early build: `load_all` on a daemon worker thread,
    started by the first call; every later call (another balancer of the
    same process) gets the same future. A failed build stays failed: its
    future carries the error to every caller."""
    global _prewarm_job
    with _prewarm_lock:
        if _prewarm_job is None:
            fut: concurrent.futures.Future = concurrent.futures.Future()
            fut.set_running_or_notify_cancel()

            def run():
                try:
                    load_all()
                except BaseException as e:  # noqa: BLE001 — to the waiters
                    fut.set_exception(e)
                else:
                    fut.set_result(None)

            threading.Thread(target=run, name="kernel-prewarm",
                             daemon=True).start()
            _prewarm_job = fut
        return _prewarm_job


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
    block, invoker columns a thread (of them in registers, in shared
    memory and streamed from global memory) and prefetch depth."""
    if not state.free_mb.is_cuda:
        ts, chosen, forced = schedule_batch(to_transposed(state), batch,
                                            penalty)
        return to_transposed(ts), chosen, forced
    n, a, b, reqs = _check(state, batch, penalty)
    if not fits_scan(n):
        raise ValueError(f"scan kernel takes 1..{SCAN_MAX_N} padded "
                         f"invokers (int32 indexing with the sentinel "
                         f"N + 2), got N={n}")
    chosen = torch.empty((b,), dtype=I32, device=reqs.device)
    forced = torch.empty((b,), dtype=I32, device=reqs.device)
    if b:
        shape = (_INT * 6)()
        rc = _launcher("scan")(
            reqs.data_ptr(), b, state.health.data_ptr(),
            state.free_mb.data_ptr(), state.conc_free.data_ptr(),
            state.conc_free.stride(0), state.conc_free.stride(1), n, a,
            _ptr(penalty), chosen.data_ptr(), forced.data_ptr(),
            torch.cuda.current_stream(reqs.device).cuda_stream, shape)
        if rc != 0:
            raise RuntimeError(f"placement_scan launch failed: CUDA error "
                               f"{rc}")
        if _counts():
            schedule_batch_cuda.launches += 1
            schedule_batch_cuda.penalized_launches += int(
                penalty is not None)
        schedule_batch_cuda.cluster = {
            "blocks": shape[0], "threads": SCAN_THREADS,
            "columns_per_thread": shape[1], "register_columns": shape[2],
            "prefetch_depth": shape[3], "smem_columns": shape[4],
            "streamed_columns": shape[5]}
    return state, chosen, forced.bool()


schedule_batch_cuda.launches = 0
schedule_batch_cuda.penalized_launches = 0
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
    if _counts():
        schedule_batch_repair_cuda.launches += 1
        schedule_batch_repair_cuda.penalized_launches += int(
            penalty is not None)
    schedule_batch_repair_cuda.grid = {"blocks": blocks.value,
                                       "threads": REPAIR_THREADS}
    return state, chosen, forced.bool(), rounds.reshape(())


schedule_batch_repair_cuda.launches = 0
schedule_batch_repair_cuda.penalized_launches = 0
schedule_batch_repair_cuda.grid = None


def release_batch_cuda(state: PlacementState, inv, slot, need_mb, max_conc,
                       valid) -> PlacementState:
    """The release fold on the card (one launch of release_fold.cu, no host
    read), bit-exact with `release_batch`; books in the standard [N, A]
    layout, updated in place. Rows: int32[R] columns and a bool[R] valid
    mask on the books' device. Raises for what the kernel does not take
    and for a launch the card refuses."""
    if not state.free_mb.is_cuda:
        return release_batch(state, inv, slot, need_mb, max_conc, valid)
    free, conc = state.free_mb, state.conc_free
    dev = free.device
    n = free.shape[0]
    if (free.dtype != I32 or not free.is_contiguous() or conc.dtype != I32
            or conc.dim() != 2 or conc.shape[0] != n or conc.device != dev):
        raise ValueError("books must be int32 free[N] (contiguous) and "
                         f"conc[N={n}, A] on one device")
    r = valid.shape[0]
    cols = [c.contiguous() for c in (inv, slot, need_mb, max_conc)]
    for c in cols:
        if c.device != dev or c.dtype != I32 or c.shape != (r,):
            raise ValueError(f"release columns must be int32[{r}] on {dev}")
    if valid.device != dev or valid.dtype != torch.bool or valid.shape != (r,):
        raise ValueError(f"valid must be bool[{r}] on {dev}")
    if n * conc.shape[1] >= RELEASE_MAX_CELLS:
        raise ValueError(f"books of {n} x {conc.shape[1]} cells exceed the "
                         f"release kernel's {RELEASE_MAX_CELLS} cell keys")
    valid = valid.contiguous()
    # a mesh's shards may sit on other cards than the current one: the
    # launch goes to the books' card
    with _on_card(dev):
        rc = _launcher("release")(
            *(c.data_ptr() for c in cols), valid.data_ptr(), r,
            free.data_ptr(), conc.data_ptr(), conc.stride(0),
            conc.stride(1), n, conc.shape[1],
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"release_fold launch failed: CUDA error {rc}")
    if r and _counts():
        release_batch_cuda.launches += 1
    return state


release_batch_cuda.launches = 0


def _on_card(dev: torch.device):
    """The device guard for a launch on `dev`: none when it is current."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def empty_launch_cuda(device=None) -> None:
    """One launch of an empty kernel from the release kernel's library, on
    the current stream of `device` (default: the current card), through
    the same ctypes path as the fold: the floor under a fold's launch.
    Counts nothing."""
    dev = torch.device(device if device is not None else "cuda")
    with _on_card(dev):
        rc = _launcher("empty")(torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"empty launch failed: CUDA error {rc}")


def reset_launch_counts() -> None:
    for fn in (schedule_batch_cuda, schedule_batch_repair_cuda):
        fn.launches = fn.penalized_launches = 0
    release_batch_cuda.launches = 0
