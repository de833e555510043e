// Sequential placement scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `schedule_batch_pallas`
// (openwhisk_tpu/ops/placement_pallas.py, body `_kernel_body`, and its
// penalized variant `_kernel_penalized`): B requests placed one after the
// other, each with a fleet-wide probe-rank argmin (eligible = in the
// partition, healthy, and holding a concurrency permit or enough free
// memory; lowest index breaks ties), a forced random-rotation fallback
// over usable invokers, and the NestedSemaphore update of free[sel] and
// conc[slot, sel]. Bit-exact with ops/placement.py::schedule_batch.
//
// What bounds it on this card. Per request the kernel reads free (4N
// bytes), health (N bytes) and the request's concurrency row (4N bytes);
// over a batch the bytes a kernel must move are free and health once, each
// DISTINCT conc row touched once (at most B rows of 64 KiB at N = 16,384)
// and the writes (chosen, forced, the changed cells): at B = 16 about
// 1.1 MB, some 0.3 us at 3.35 TB/s. What actually limits it is the serial
// depth: B dependent rounds of two block-wide reductions on ONE SM, each
// request waiting for the previous one's capacity update.
//
// What the design does about it. One block of 1,024 threads (the whole
// fleet is strided over it, 16 invokers a thread at N = 16,384), the
// books stay in device memory (the TPU kernel held them in VMEM; here the
// 256 MiB conc matrix cannot fit on chip, and each request touches one
// 64 KiB row of it, read coalesced from the [A, N] layout). Both argmins
// reduce a packed (key << 32 | idx) uint64 through warp shuffles and one
// shared-memory pass, so the serial chain per request is two barriers and
// one thread's capacity update. Spreading a request over several SMs, and
// CUDA graphs over the step, are later work.
#include "placement_common.cuh"

constexpr int SCAN_THREADS = 1024;

__global__ void __launch_bounds__(SCAN_THREADS, 1)
placement_scan_kernel(const int* __restrict__ reqs, int b,
                      const unsigned char* __restrict__ health,
                      int* free_mb, int* conc, long long sa, long long sn,
                      int n, int a, const int* __restrict__ penalty,
                      int* __restrict__ chosen, int* __restrict__ forced) {
  __shared__ uint64_t red_key[SCAN_THREADS / 32];
  __shared__ uint64_t red_fkey[SCAN_THREADS / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  // the penalized rank can exceed n + 2 (one probe-ring lap per level)
  const int big = penalty ? (1 << 30) : n + 2;

  for (int i = 0; i < b; ++i) {
    const int offset = reqs[R_OFFSET * b + i];
    const int size = reqs[R_SIZE * b + i];
    const int home = reqs[R_HOME * b + i];
    const int step_inv = reqs[R_STEP_INV * b + i];
    const int need = reqs[R_NEED * b + i];
    const int slot_raw = reqs[R_SLOT * b + i];
    const int max_conc = reqs[R_MAX_CONC * b + i];
    const int rnd = reqs[R_RAND * b + i];
    const bool valid = reqs[R_VALID * b + i] != 0;
    // an out-of-range slot reads the clamped row, and its write is dropped
    const bool slot_ok = slot_raw >= 0 && slot_raw < a;
    const int slot = min(max(slot_raw, 0), a - 1);
    const int m = max(size, 1);
    const int* crow = conc + (long long)slot * sa;

    uint64_t best = ~0ull, fbest = ~0ull;
    for (int idx = tid; idx < n; idx += blockDim.x) {
      const int local = idx - offset;
      const bool usable = local >= 0 && local < size && health[idx];
      int key = big, fkey = big;
      if (usable) {
        fkey = floormod(local - rnd, m);
        if (load_book(crow + idx * sn) > 0 ||
            load_book(free_mb + idx) >= need) {
          key = mulmod(local - home, step_inv, m);
          if (penalty) key = wadd(key, wmul(penalty[idx], m));
        }
      }
      const uint64_t k = pack_key(key, idx), f = pack_key(fkey, idx);
      best = k < best ? k : best;
      fbest = f < fbest ? f : fbest;
    }
    best = warp_min_u64(best);
    fbest = warp_min_u64(fbest);
    if (lane == 0) {
      red_key[warp] = best;
      red_fkey[warp] = fbest;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane < nwarps ? red_key[lane] : ~0ull;
      fbest = lane < nwarps ? red_fkey[lane] : ~0ull;
      best = warp_min_u64(best);
      fbest = warp_min_u64(fbest);
      if (lane == 0) {
        const bool found = key_of(best) < big;
        const bool have_usable = key_of(fbest) < big;
        const int sel = found ? idx_of(best) : idx_of(fbest);
        const bool placed = valid && (found || have_usable);
        int* cell = conc + (long long)slot * sa + (long long)sel * sn;
        const int cell_val = load_book(cell);
        const bool use_conc = placed && cell_val > 0;
        const bool take_mem = placed && !use_conc;
        if (take_mem) free_mb[sel] = load_book(free_mb + sel) - need;
        const int delta = use_conc ? -1
                          : (take_mem && max_conc > 1 ? max_conc - 1 : 0);
        if (slot_ok && delta != 0) *cell = cell_val + delta;
        chosen[i] = placed ? sel : -1;
        forced[i] = (valid && !found && have_usable) ? 1 : 0;
      }
    }
    // the next request reads the books thread 0 just wrote
    __syncthreads();
  }
}

extern "C" int placement_scan_launch(const int* reqs, int b,
                                     const unsigned char* health,
                                     int* free_mb, int* conc, long long sa,
                                     long long sn, int n, int a,
                                     const int* penalty, int* chosen,
                                     int* forced, void* stream) {
  placement_scan_kernel<<<1, SCAN_THREADS, 0, (cudaStream_t)stream>>>(
      reqs, b, health, free_mb, conc, sa, sn, n, a, penalty, chosen, forced);
  return (int)cudaGetLastError();
}
