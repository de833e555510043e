// Speculate-and-repair placement for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `schedule_batch_repair_pallas`
// (openwhisk_tpu/ops/placement_pallas.py, body `_repair_kernel_body`, and
// its penalized variant `_repair_kernel_penalized`). Each round probes
// every row of the batch against the current books, evaluates the shared
// conflict rules (ops/placement.py::repair_commit_masks, pairwise form),
// commits the settled rows and repeats while rows are pending and
// rounds <= B. Bit-exact with ops/placement.py::schedule_batch_repair:
// chosen, forced, rounds and the books.
//
// What bounds it on this card. The bytes a call must move are free and
// health once (5N bytes), each DISTINCT concurrency row the batch touches
// once (at most B rows of 64 KiB at N = 16,384: up to 16 MiB at B = 256)
// and the writes. The work that actually limits it is serial: every round
// is four barrier-separated phases on ONE SM (probe, conflict rules,
// commit set, commit), and the probe phase evaluates B x N keys per round
// with 1,024 threads.
//
// What the design does about it. One persistent block of 1,024 threads
// runs the whole round loop, so no round pays a host round trip (what
// the Pallas kernel got from its VMEM-resident books). The probe is a
// warp per row (rows strided over 32 warps) reading the row's conc[slot,:]
// directly, coalesced from the [A, N] layout, and reducing a packed
// (key << 32 | idx) argmin with shuffles: the [B, N] scratch the Pallas
// kernel materialises is never built. Per-row results live in shared
// memory (REPAIR_ROW_INTS ints a row, which is what bounds B: the wrapper
// checks it), the conflict rules run one thread per row looping over the
// earlier rows, first_bad is a shared-memory atomicMin, and the commit is
// integer atomicAdd on free[sel] and conc[slot, sel] (exact in any order;
// an out-of-range slot's write is dropped). More SMs per probe, staging
// conc rows with cp.async/TMA and probing only pending rows are later
// work.
#include "placement_common.cuh"

constexpr int REPAIR_THREADS = 1024;
// per-row shared-memory ints; ops/placement_cuda.py REPAIR_ROW_BYTES = 4x
constexpr int REPAIR_ROW_INTS = 26;

struct Rows {
  // request fields (slot clamped to [0, A), slot_ok = it was in range)
  int *off, *size, *home, *sinv, *need, *slot, *maxc, *rnd, *valid, *slot_ok;
  // loop-invariant forced choice
  int *fchoice, *have_usable;
  // this round's speculation
  int *sel, *placed, *forced, *use_conc, *take_mem, *col_conc, *free_at_sel;
  // loop state
  int *pending, *chosen, *forced_acc;
  // conflict-rule intermediates
  int *hard, *prior_mem, *grow_pot, *safe;
};

__device__ __forceinline__ Rows carve(int* p, int b) {
  Rows r;
  int** fields[REPAIR_ROW_INTS] = {
      &r.off, &r.size, &r.home, &r.sinv, &r.need, &r.slot, &r.maxc,
      &r.rnd, &r.valid, &r.slot_ok, &r.fchoice, &r.have_usable, &r.sel,
      &r.placed, &r.forced, &r.use_conc, &r.take_mem, &r.col_conc,
      &r.free_at_sel, &r.pending, &r.chosen, &r.forced_acc, &r.hard,
      &r.prior_mem, &r.grow_pot, &r.safe};
  for (int f = 0; f < REPAIR_ROW_INTS; ++f) *fields[f] = p + f * b;
  return r;
}

__global__ void __launch_bounds__(REPAIR_THREADS, 1)
placement_repair_kernel(const int* __restrict__ reqs, int b,
                        const unsigned char* __restrict__ health,
                        int* free_mb, int* conc, long long sa, long long sn,
                        int n, int a, const int* __restrict__ penalty,
                        int* __restrict__ chosen_out,
                        int* __restrict__ forced_out,
                        int* __restrict__ rounds_out) {
  extern __shared__ int smem[];
  __shared__ int first_bad;
  const Rows r = carve(smem, b);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int big = penalty ? (1 << 30) : n + 2;

  for (int i = tid; i < b; i += blockDim.x) {
    r.off[i] = reqs[R_OFFSET * b + i];
    r.size[i] = reqs[R_SIZE * b + i];
    r.home[i] = reqs[R_HOME * b + i];
    r.sinv[i] = reqs[R_STEP_INV * b + i];
    r.need[i] = reqs[R_NEED * b + i];
    const int s = reqs[R_SLOT * b + i];
    r.slot_ok[i] = (s >= 0 && s < a) ? 1 : 0;
    r.slot[i] = min(max(s, 0), a - 1);
    r.maxc[i] = reqs[R_MAX_CONC * b + i];
    r.rnd[i] = reqs[R_RAND * b + i];
    r.valid[i] = reqs[R_VALID * b + i] != 0 ? 1 : 0;
    r.pending[i] = r.valid[i];
    r.chosen[i] = -1;
    r.forced_acc[i] = 0;
  }
  __syncthreads();

  // setup: the forced choice ignores capacity and health is fixed inside
  // a batch, so fchoice/have_usable are computed once (a warp per row)
  for (int i = warp; i < b; i += nwarps) {
    const int off = r.off[i], size = r.size[i], m = max(size, 1);
    const int rnd = r.rnd[i];
    uint64_t fbest = ~0ull;
    for (int idx = lane; idx < n; idx += 32) {
      const int local = idx - off;
      const bool usable = local >= 0 && local < size && health[idx];
      const uint64_t f = pack_key(usable ? floormod(local - rnd, m) : big,
                                  idx);
      fbest = f < fbest ? f : fbest;
    }
    fbest = warp_min_u64(fbest);
    if (lane == 0) {
      r.fchoice[i] = idx_of(fbest);
      r.have_usable[i] = key_of(fbest) < big ? 1 : 0;
    }
  }
  int rounds = 0;
  int any_pending = __syncthreads_or(tid < b ? r.pending[tid] : 0);

  while (any_pending && rounds <= b) {
    // A. probe every row against the current books (a warp per row)
    if (tid == 0) first_bad = b;
    for (int i = warp; i < b; i += nwarps) {
      const int off = r.off[i], size = r.size[i], m = max(size, 1);
      const int home = r.home[i], sinv = r.sinv[i], need = r.need[i];
      const int* crow = conc + (long long)r.slot[i] * sa;
      uint64_t best = ~0ull;
      bool anyc = false;
      for (int idx = lane; idx < n; idx += 32) {
        const int local = idx - off;
        int key = big;
        if (local >= 0 && local < size && health[idx]) {
          const bool has_conc = load_book(crow + idx * sn) > 0;
          anyc |= has_conc;
          if (has_conc || load_book(free_mb + idx) >= need) {
            key = mulmod(local - home, sinv, m);
            if (penalty) key = wadd(key, wmul(penalty[idx], m));
          }
        }
        const uint64_t k = pack_key(key, idx);
        best = k < best ? k : best;
      }
      best = warp_min_u64(best);
      anyc = __any_sync(0xffffffffu, anyc);
      if (lane == 0) {
        const bool found = key_of(best) < big;
        const int sel = found ? idx_of(best) : r.fchoice[i];
        const bool valid = r.valid[i] != 0;
        const bool have_usable = r.have_usable[i] != 0;
        const bool placed = valid && (found || have_usable);
        const bool use_conc = placed && load_book(crow + sel * sn) > 0;
        r.sel[i] = sel;
        r.placed[i] = placed;
        r.forced[i] = valid && !found && have_usable;
        r.use_conc[i] = use_conc;
        r.take_mem[i] = placed && !use_conc;
        r.col_conc[i] = anyc;
        r.free_at_sel[i] = load_book(free_mb + sel);
      }
    }
    __syncthreads();

    // B. conflict rules, one thread per row over the earlier rows
    if (tid < b) {
      const int i = tid;
      const int sel_i = r.sel[i], slot_i = r.slot[i];
      bool hard_c = false, grow_pot = false;
      int prior = 0;
      for (int j = 0; j < b; ++j) {
        const bool pend = r.pending[j] != 0;
        const bool simple_j = r.maxc[j] <= 1;
        const bool same_slot = r.slot_ok[j] && r.slot[j] == slot_i;
        if (j < i) {
          const bool writer = pend && r.placed[j];
          const bool tm = r.take_mem[j] != 0;
          const bool cascade = writer && tm && simple_j;
          const bool same_sel = r.sel[j] == sel_i;
          // an earlier non-cascade writer on my invoker, or an earlier
          // container-opener on my conc column
          if ((writer && !cascade && same_sel) ||
              (writer && tm && !simple_j && same_slot))
            hard_c = true;
          if (cascade && same_sel) prior = wadd(prior, r.need[j]);
        }
        if (pend && !simple_j && same_slot) grow_pot = true;
      }
      const bool mem_c = r.take_mem[i] && !r.forced[i] &&
                         (r.free_at_sel[i] - prior < r.need[i]);
      r.hard[i] = hard_c;
      r.prior_mem[i] = prior;
      r.grow_pot[i] = grow_pot;
      if (r.pending[i] && (hard_c || mem_c)) atomicMin(&first_bad, i);
    }
    __syncthreads();

    // C. the commit set: the prefix before first_bad, unplaceable rows,
    // and the provably order-independent commits past it
    if (tid < b) {
      const int i = tid;
      const int fb = first_bad;
      const int slot_i = r.slot[i];
      bool impure_before = false, slot_probed_before = false;
      int demand_before = 0, max_need_before = 0;
      for (int j = fb; j < i; ++j) {
        if (!(r.pending[j] && r.placed[j])) continue;  // not a straggler
        const bool pure = r.maxc[j] <= 1 && !r.col_conc[j] && !r.grow_pot[j];
        if (!pure) impure_before = true;
        demand_before = wadd(demand_before, r.need[j]);
        max_need_before = max(max_need_before, r.need[j]);
        if (r.slot_ok[j] && r.slot[j] == slot_i) slot_probed_before = true;
      }
      const bool pend = r.pending[i] != 0, placed = r.placed[i] != 0;
      const bool tm = r.take_mem[i] != 0;
      const bool budget_ok =
          !tm || (r.free_at_sel[i] - r.prior_mem[i] - demand_before -
                      max_need_before >= r.need[i]);
      const bool conc_write = r.use_conc[i] || (tm && r.maxc[i] > 1);
      const bool ooo = pend && placed && !r.forced[i] && !r.hard[i] &&
                       !impure_before && budget_ok &&
                       !(conc_write && slot_probed_before);
      r.safe[i] = pend && (i < fb || !placed || ooo);
    }
    __syncthreads();

    // D. commit the settled rows and retire them
    int still = 0;
    if (tid < b) {
      const int i = tid;
      if (r.safe[i]) {
        const int sel = r.sel[i];
        if (r.placed[i]) {
          const bool tm = r.take_mem[i] != 0;
          if (tm) atomicAdd(free_mb + sel, -r.need[i]);
          const int delta = r.use_conc[i] ? -1
                            : (tm && r.maxc[i] > 1 ? r.maxc[i] - 1 : 0);
          if (r.slot_ok[i] && delta != 0)
            atomicAdd(conc + (long long)r.slot[i] * sa + (long long)sel * sn,
                      delta);
        }
        r.chosen[i] = r.placed[i] ? sel : -1;
        if (r.forced[i]) r.forced_acc[i] = 1;
        r.pending[i] = 0;
      }
      still = r.pending[i];
    }
    ++rounds;
    any_pending = __syncthreads_or(still);
  }

  if (tid < b) {
    chosen_out[tid] = r.chosen[tid];
    forced_out[tid] = r.forced_acc[tid];
  }
  if (tid == 0) *rounds_out = rounds;
}

extern "C" int placement_repair_launch(const int* reqs, int b,
                                       const unsigned char* health,
                                       int* free_mb, int* conc, long long sa,
                                       long long sn, int n, int a,
                                       const int* penalty, int* chosen,
                                       int* forced, int* rounds,
                                       void* stream) {
  const size_t smem = (size_t)REPAIR_ROW_INTS * sizeof(int) * b;
  cudaError_t err = cudaFuncSetAttribute(
      placement_repair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  placement_repair_kernel<<<1, REPAIR_THREADS, smem, (cudaStream_t)stream>>>(
      reqs, b, health, free_mb, conc, sa, sn, n, a, penalty, chosen, forced,
      rounds);
  return (int)cudaGetLastError();
}
