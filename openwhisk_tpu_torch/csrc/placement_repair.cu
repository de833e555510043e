// Speculate-and-repair placement for Hopper (sm_90a), on the whole card.
//
// Replaces the Pallas TPU kernel `schedule_batch_repair_pallas`
// (openwhisk_tpu/ops/placement_pallas.py, body `_repair_kernel_body`, and
// its penalized variant `_repair_kernel_penalized`). Each round probes the
// pending rows against the current books, evaluates the shared conflict
// rules (ops/placement.py::repair_commit_masks, pairwise form), commits the
// settled rows and repeats while rows are pending and rounds <= B.
// Bit-exact with ops/placement.py::schedule_batch_repair: chosen, forced,
// rounds and the books.
//
// What bounds it on this card. A round's probe reads health, free and the
// row's conc row over each pending row's partition window: at B = 256 rows
// on a 9,000-invoker partition that is up to 2.3M keys and ~20 MB in the
// first round, fewer later, all from L2 (the books a batch touches stay in
// the 50 MB L2 between rounds). The rest of a round is serial: two
// grid-wide barriers and the conflict rules on one block, whose pairwise
// loops grow with B times the pending rows.
//
// What the design does about it.
//  * A persistent cooperative grid (cudaLaunchCooperativeKernel with as
//    many 1,024-thread blocks as are co-resident, at least one per SM) runs
//    the whole round loop; cooperative_groups grid barriers separate the
//    phases, so no round pays a host round trip.
//  * Phase A, over the whole grid, one warp per work item: the items are
//    (pending row, PROBE_CHUNK invokers of its window: the part of
//    [offset, offset+size) inside [0, N)). Only pending rows are probed: a settled row's speculation
//    never reaches the commit rules (every use is masked by `pending`),
//    and an index outside the window carries the sentinel key, so it never
//    wins the probe. A warp starts all of an item's book loads first (one
//    memory latency an item), steps each lane's ranks by an add where that
//    is exact (one mulmod a lane, not one a key), reduces a packed
//    (key << 32 | idx) argmin with shuffles and merges it into the row's
//    word in global scratch with atomicMin (anyc with atomicOr): both
//    merges are order-free, so the result does not depend on the blocks'
//    order. The first round also computes the forced-rotation argmin of
//    each valid row the same way; finish_forced adds the fleet's lowest
//    index outside the window, so a row with nothing usable gets index 0,
//    as the plain argmin over a row of sentinels does.
//  * Phases B-D on block 0: use_conc and free_at_sel at the final sel (a
//    thread a row); the conflict rules and the commit set with `lanes`
//    threads a row, each looping over a share of the pending rows only and
//    reduced with shuffles (or, sum, max: exact in any order); the integer
//    atomicAdd commits (exact in any order; an out-of-range slot's write
//    is dropped); then the next round's list of pending rows and the first
//    work item of each, written to scratch for phase A.
//  * Books and scratch are read with ld.global.cg (L2), so every block sees
//    the commits and the list of the round before.
// Scratch (REPAIR_SCRATCH_ROW_BYTES a row plus a header) comes from the
// wrapper. Block 0 keeps REPAIR_ROW_INTS ints a row in shared memory and
// every block LIST_ROW_INTS more for its copy of the list; one thread a row
// in block 0 bounds B at 1,024.
#include <cooperative_groups.h>

#include "placement_common.cuh"

namespace cg = cooperative_groups;

constexpr int REPAIR_THREADS = 1024;
constexpr int REPAIR_WARPS = REPAIR_THREADS / 32;
constexpr int REPAIR_MAX_BATCH = REPAIR_THREADS;
// invokers of one window per work item: 8 a lane
constexpr int PROBE_PER_LANE = 8;
constexpr int PROBE_CHUNK = 32 * PROBE_PER_LANE;
// shared-memory ints per row (ops/placement_cuda.py REPAIR_ROW_BYTES is
// 4 * (REPAIR_ROW_INTS + LIST_ROW_INTS)) and scratch bytes per row
// (REPAIR_SCRATCH_ROW_BYTES there)
constexpr int REPAIR_ROW_INTS = 22;
constexpr int LIST_ROW_INTS = 2;
constexpr int REPAIR_SCRATCH_ROW_BYTES = 28;
constexpr int MAX_DEVICES = 64;

// block 0's per-row state
struct Rows {
  // request fields (slot clamped to [0, A), slot_ok = it was in range) and
  // the row's count of work items
  int *need, *slot, *maxc, *valid, *slot_ok, *nitems;
  // loop-invariant forced choice
  int *fchoice, *have_usable;
  // this round's speculation
  int *sel, *placed, *forced, *use_conc, *take_mem, *col_conc, *free_at_sel;
  // loop state
  int *pending, *chosen, *forced_acc;
  // conflict-rule intermediates
  int *hard, *prior_mem, *grow_pot, *safe;
};

__device__ __forceinline__ Rows carve_rows(int* p, int b) {
  Rows r;
  int** fields[REPAIR_ROW_INTS] = {
      &r.need, &r.slot, &r.maxc, &r.valid, &r.slot_ok, &r.nitems,
      &r.fchoice, &r.have_usable, &r.sel, &r.placed, &r.forced,
      &r.use_conc, &r.take_mem, &r.col_conc, &r.free_at_sel, &r.pending,
      &r.chosen, &r.forced_acc, &r.hard, &r.prior_mem, &r.grow_pot, &r.safe};
  for (int f = 0; f < REPAIR_ROW_INTS; ++f) *fields[f] = p + f * b;
  return r;
}

// state the blocks share, in global memory
struct Scratch {
  unsigned long long *best;   // [B] this round's probe argmin per row
  unsigned long long *fbest;  // [B] forced-rotation argmin per row
  int *anyc;                  // [B] a usable window column holds a permit
  int *list;                  // [B] pending rows, in batch order
  int *first;                 // [B + 1] first item of each; [count] = total
  int *ctrl;                  // [0] listed rows, [1] another round runs
};

__device__ __forceinline__ Scratch carve_scratch(void* p, int b) {
  Scratch s;
  auto* u = static_cast<unsigned long long*>(p);
  s.best = u;
  s.fbest = u + b;
  int* q = reinterpret_cast<int*>(u + 2 * b);
  s.anyc = q;
  s.list = q + b;
  s.first = q + 2 * b;
  s.ctrl = q + 3 * b + 1;
  return s;
}
static_assert(REPAIR_SCRATCH_ROW_BYTES ==
                  2 * sizeof(unsigned long long) + 3 * sizeof(int),
              "scratch per row: best, fbest, anyc, list, first");

// a request's window [lo, hi) of [0, n): local = idx - off in [0, size)
__device__ __forceinline__ void window(int off, int size, int n, int& lo,
                                       int& hi) {
  const long long l = max((long long)off, 0ll);
  const long long h = min((long long)off + size, (long long)n);
  lo = (int)min(l, (long long)n);
  hi = (int)max(h, (long long)lo);
}

// exclusive prefix sum of v over the block; *total gets the block's sum
__device__ int block_exclusive_sum(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  const int excl = x - v + (warp ? warp_sums[warp - 1] : 0);
  *total = warp_sums[REPAIR_WARPS - 1];
  __syncthreads();
  return excl;
}

// threads a row in phases B-C: the largest power of two up to 32 with
// lanes * b <= REPAIR_THREADS
__device__ __forceinline__ int row_lanes(int b) {
  int l = 32;
  while (l > 1 && l * b > REPAIR_THREADS) l >>= 1;
  return l;
}

// block 0: list the pending rows in batch order, with the first work item
// of each (a row with an empty window has none), and say whether another
// round runs
__device__ void publish_list(const Rows& r, const Scratch& s, int b,
                             int* warp_sums, bool go) {
  const int i = threadIdx.x;
  const bool listed = i < b && r.pending[i];
  int count, total;
  const int pos = block_exclusive_sum(listed ? 1 : 0, warp_sums, &count);
  const int first =
      block_exclusive_sum(listed ? r.nitems[i] : 0, warp_sums, &total);
  if (listed) {
    s.list[pos] = i;
    s.first[pos] = first;
  }
  if (i == 0) {
    s.first[count] = total;
    s.ctrl[0] = count;
    s.ctrl[1] = go ? 1 : 0;
  }
}

// phase A for one work item, by one warp
__device__ __forceinline__ void probe_item(
    const int* __restrict__ reqs, int b, int i, int chunk,
    const unsigned char* __restrict__ health, const int* free_mb,
    const int* conc, long long sa, long long sn, int n, int a, int big,
    const int* __restrict__ penalty, bool setup, const Scratch& s) {
  const int lane = threadIdx.x & 31;
  const int off = __ldg(reqs + R_OFFSET * b + i);
  const int size = __ldg(reqs + R_SIZE * b + i), m = max(size, 1);
  const int home = __ldg(reqs + R_HOME * b + i);
  const int sinv = __ldg(reqs + R_STEP_INV * b + i);
  const int need = __ldg(reqs + R_NEED * b + i);
  const int rnd = __ldg(reqs + R_RAND * b + i);
  const int slot = min(max(__ldg(reqs + R_SLOT * b + i), 0), a - 1);
  const int* crow = conc + (long long)slot * sa;
  int lo, hi;
  window(off, size, n, lo, hi);
  const int start = lo + chunk * PROBE_CHUNK;
  const int end = min(start + PROBE_CHUNK, hi);
  // every load of the item starts before any key is computed, so the
  // item costs one memory latency, not one per invoker
  unsigned hbits = 0;
  int cv[PROBE_PER_LANE], fv[PROBE_PER_LANE];
#pragma unroll
  for (int k = 0; k < PROBE_PER_LANE; ++k) {
    const int idx = start + lane + 32 * k;
    const bool in = idx < end;
    hbits |= (in && health[idx] ? 1u : 0u) << k;
    cv[k] = in ? load_book(crow + idx * sn) : 0;
    fv[k] = in ? load_book(free_mb + idx) : 0;
  }
  // a lane's ranks step by 32 * step_inv mod m; where mulmod is the true
  // modular product (0 <= step_inv < m <= 2^17, see placement_common.cuh)
  // one mulmod a lane and an add a key give the same values
  const bool stepped = sinv >= 0 && sinv < m && m <= (1 << 17);
  const int rank_step = mulmod(32, sinv, m);
  int rank = mulmod(start + lane - off - home, sinv, m);
  uint64_t best = ~0ull, fbest = ~0ull;
  bool anyc = false;
#pragma unroll
  for (int k = 0; k < PROBE_PER_LANE; ++k) {
    const int idx = start + lane + 32 * k;
    if (idx >= end) break;
    const int local = idx - off;
    if (k > 0) {
      rank = stepped ? rank + rank_step : mulmod(local - home, sinv, m);
      if (stepped && rank >= m) rank -= m;
    }
    int key = big, fkey = big;
    if (hbits >> k & 1u) {
      const bool has_conc = cv[k] > 0;
      anyc |= has_conc;
      if (has_conc || fv[k] >= need)
        key = penalty ? wadd(rank, wmul(penalty[idx], m)) : rank;
      fkey = floormod(local - rnd, m);
    }
    const uint64_t kp = pack_key(key, idx);
    best = kp < best ? kp : best;
    if (setup) {
      const uint64_t f = pack_key(fkey, idx);
      fbest = f < fbest ? f : fbest;
    }
  }
  best = warp_min_u64(best);
  anyc = __any_sync(0xffffffffu, anyc);
  if (setup) fbest = warp_min_u64(fbest);
  if (lane == 0) {
    // a key at or above the sentinel is "not found" and its index unused
    if (key_of(best) < big) atomicMin(s.best + i, best);
    if (anyc) atomicOr(s.anyc + i, 1);
    if (setup) atomicMin(s.fbest + i, fbest);
  }
}

// The forced choice of row i from its window's argmin: every index outside
// the window carries the sentinel too, so the plain argmin over [0, n)
// also sees (big, lowest index outside the window).
__device__ __forceinline__ void finish_forced(const int* __restrict__ reqs,
                                              int b, int i, int n, int big,
                                              const Scratch& s, Rows& r) {
  int lo, hi;
  window(reqs[R_OFFSET * b + i], reqs[R_SIZE * b + i], n, lo, hi);
  uint64_t f = __ldcg(s.fbest + i);
  const uint64_t outside =
      lo > 0 ? pack_key(big, 0) : (hi < n ? pack_key(big, hi) : ~0ull);
  f = outside < f ? outside : f;
  r.fchoice[i] = idx_of(f);
  r.have_usable[i] = key_of(f) < big ? 1 : 0;
}

__global__ void __launch_bounds__(REPAIR_THREADS, 1)
placement_repair_kernel(const int* __restrict__ reqs, int b,
                        const unsigned char* __restrict__ health,
                        int* free_mb, int* conc, long long sa, long long sn,
                        int n, int a, const int* __restrict__ penalty,
                        int* __restrict__ chosen_out,
                        int* __restrict__ forced_out,
                        int* __restrict__ rounds_out, void* scratch) {
  extern __shared__ int smem[];
  __shared__ int first_bad;
  __shared__ int warp_sums[REPAIR_WARPS];
  cg::grid_group grid = cg::this_grid();
  const Scratch s = carve_scratch(scratch, b);
  int* s_list = smem;        // [b]
  int* s_first = smem + b;   // [b + 1]
  Rows r = carve_rows(smem + 2 * b + 1, b);  // block 0's
  const int tid = threadIdx.x;
  const bool leader = blockIdx.x == 0;
  const int big = penalty ? (1 << 30) : n + 2;
  const int lanes = row_lanes(b);

  if (leader) {
    int valid = 0;
    if (tid < b) {
      const int i = tid;
      r.need[i] = reqs[R_NEED * b + i];
      const int sl = reqs[R_SLOT * b + i];
      r.slot_ok[i] = (sl >= 0 && sl < a) ? 1 : 0;
      r.slot[i] = min(max(sl, 0), a - 1);
      r.maxc[i] = reqs[R_MAX_CONC * b + i];
      valid = reqs[R_VALID * b + i] != 0 ? 1 : 0;
      r.valid[i] = valid;
      int lo, hi;
      window(reqs[R_OFFSET * b + i], reqs[R_SIZE * b + i], n, lo, hi);
      r.nitems[i] = valid ? (hi - lo + PROBE_CHUNK - 1) / PROBE_CHUNK : 0;
      r.pending[i] = valid;
      r.chosen[i] = -1;
      r.forced_acc[i] = 0;
      r.fchoice[i] = r.have_usable[i] = 0;
      r.sel[i] = r.placed[i] = r.forced[i] = r.use_conc[i] = 0;
      r.take_mem[i] = r.col_conc[i] = r.free_at_sel[i] = 0;
      s.best[i] = s.fbest[i] = ~0ull;
      s.anyc[i] = 0;
    }
    publish_list(r, s, b, warp_sums, __syncthreads_or(valid));
  }
  grid.sync();

  int rounds = 0;
  while (__ldcg(s.ctrl + 1)) {
    // A. probe the listed rows' windows over the whole grid
    const bool setup = rounds == 0;
    const int count = __ldcg(s.ctrl);
    for (int t = tid; t <= count; t += blockDim.x) {
      s_first[t] = __ldcg(s.first + t);
      if (t < count) s_list[t] = __ldcg(s.list + t);
    }
    __syncthreads();
    const int total = s_first[count];
    for (int item = blockIdx.x * REPAIR_WARPS + (tid >> 5); item < total;
         item += gridDim.x * REPAIR_WARPS) {
      // the row owning this item: the last k with first[k] <= item (rows
      // without items share their first with the next row)
      int k = 0, kh = count - 1;
      while (k < kh) {
        const int mid = (k + kh + 1) >> 1;
        if (s_first[mid] <= item) k = mid; else kh = mid - 1;
      }
      probe_item(reqs, b, s_list[k], item - s_first[k], health, free_mb,
                 conc, sa, sn, n, a, big, penalty, setup, s);
    }
    grid.sync();

    if (leader) {
      // the round's speculation per pending row, from the merged argmins
      if (tid < b) {
        const int i = tid;
        if (setup && r.valid[i]) finish_forced(reqs, b, i, n, big, s, r);
        if (r.pending[i]) {
          const uint64_t bv = __ldcg(s.best + i);
          const bool found = key_of(bv) < big;
          const int sel = found ? idx_of(bv) : r.fchoice[i];
          const bool have_usable = r.have_usable[i] != 0;
          const bool placed = found || have_usable;
          const int* crow = conc + (long long)r.slot[i] * sa;
          const bool use_conc = placed && load_book(crow + sel * sn) > 0;
          r.sel[i] = sel;
          r.placed[i] = placed;
          r.forced[i] = !found && have_usable;
          r.use_conc[i] = use_conc;
          r.take_mem[i] = placed && !use_conc;
          r.col_conc[i] = __ldcg(s.anyc + i) != 0;
          r.free_at_sel[i] = load_book(free_mb + sel);
          s.best[i] = ~0ull;
          s.anyc[i] = 0;
        }
      }
      if (tid == 0) first_bad = b;
      __syncthreads();

      // B. conflict rules: `lanes` threads a row, each over every lanes-th
      // pending row, then an order-free reduction across them
      {
        const int i = tid / lanes;
        const bool mine = i < b && r.pending[i];
        bool hard_c = false, grow_pot = false;
        int prior = 0;
        if (mine) {
          const int sel_i = r.sel[i], slot_i = r.slot[i];
          for (int k = tid % lanes; k < count; k += lanes) {
            const int j = s_list[k];
            const bool simple_j = r.maxc[j] <= 1;
            const bool same_slot = r.slot_ok[j] && r.slot[j] == slot_i;
            if (j < i && r.placed[j]) {
              const bool tm = r.take_mem[j] != 0;
              const bool cascade = tm && simple_j;
              const bool same_sel = r.sel[j] == sel_i;
              // an earlier non-cascade writer on my invoker, or an earlier
              // container-opener on my conc column
              if ((!cascade && same_sel) || (tm && !simple_j && same_slot))
                hard_c = true;
              if (cascade && same_sel) prior = wadd(prior, r.need[j]);
            }
            if (!simple_j && same_slot) grow_pot = true;
          }
        }
        for (int o = lanes >> 1; o > 0; o >>= 1) {
          hard_c |= __shfl_xor_sync(0xffffffffu, hard_c, o);
          grow_pot |= __shfl_xor_sync(0xffffffffu, grow_pot, o);
          prior = wadd(prior, __shfl_xor_sync(0xffffffffu, prior, o));
        }
        if (mine && tid % lanes == 0) {
          const bool mem_c = r.take_mem[i] && !r.forced[i] &&
                             (r.free_at_sel[i] - prior < r.need[i]);
          r.hard[i] = hard_c;
          r.prior_mem[i] = prior;
          r.grow_pot[i] = grow_pot;
          if (hard_c || mem_c) atomicMin(&first_bad, i);
        }
      }
      __syncthreads();

      // C. the commit set: the prefix before first_bad, unplaceable rows,
      // and the provably order-independent commits past it (stragglers:
      // the pending placed rows from first_bad on)
      {
        const int i = tid / lanes;
        const bool mine = i < b && r.pending[i];
        const int fb = first_bad;
        bool impure_before = false, slot_probed_before = false;
        int demand_before = 0, max_need_before = 0;
        if (mine && i > fb) {
          const int slot_i = r.slot[i];
          for (int k = tid % lanes; k < count; k += lanes) {
            const int j = s_list[k];
            if (j >= i) break;
            if (j < fb || !r.placed[j]) continue;
            const bool pure =
                r.maxc[j] <= 1 && !r.col_conc[j] && !r.grow_pot[j];
            if (!pure) impure_before = true;
            demand_before = wadd(demand_before, r.need[j]);
            max_need_before = max(max_need_before, r.need[j]);
            if (r.slot_ok[j] && r.slot[j] == slot_i)
              slot_probed_before = true;
          }
        }
        for (int o = lanes >> 1; o > 0; o >>= 1) {
          impure_before |= __shfl_xor_sync(0xffffffffu, impure_before, o);
          slot_probed_before |=
              __shfl_xor_sync(0xffffffffu, slot_probed_before, o);
          demand_before = wadd(demand_before,
                               __shfl_xor_sync(0xffffffffu, demand_before, o));
          max_need_before = max(
              max_need_before, __shfl_xor_sync(0xffffffffu, max_need_before, o));
        }
        if (i < b && tid % lanes == 0) {
          const bool placed = r.placed[i] != 0;
          const bool tm = r.take_mem[i] != 0;
          const bool budget_ok =
              !tm || (r.free_at_sel[i] - r.prior_mem[i] - demand_before -
                          max_need_before >= r.need[i]);
          const bool conc_write = r.use_conc[i] || (tm && r.maxc[i] > 1);
          const bool ooo = placed && !r.forced[i] && !r.hard[i] &&
                           !impure_before && budget_ok &&
                           !(conc_write && slot_probed_before);
          r.safe[i] = mine && (i < fb || !placed || ooo);
        }
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
              atomicAdd(conc + (long long)r.slot[i] * sa +
                            (long long)sel * sn,
                        delta);
          }
          r.chosen[i] = r.placed[i] ? sel : -1;
          if (r.forced[i]) r.forced_acc[i] = 1;
          r.pending[i] = 0;
        }
        still = r.pending[i];
      }
      const bool any_pending = __syncthreads_or(still);
      publish_list(r, s, b, warp_sums, any_pending && rounds + 1 <= b);
    }
    ++rounds;
    grid.sync();
  }

  if (leader) {
    if (tid < b) {
      chosen_out[tid] = r.chosen[tid];
      forced_out[tid] = r.forced_acc[tid];
    }
    if (tid == 0) *rounds_out = rounds;
  }
}

static size_t repair_smem_bytes(int b) {
  return sizeof(int) * ((size_t)(REPAIR_ROW_INTS + LIST_ROW_INTS) * b + 1);
}

// per device: SM count and co-resident blocks per SM at the largest batch
static int g_grid[MAX_DEVICES];

extern "C" int placement_repair_launch(const int* reqs, int b,
                                       const unsigned char* health,
                                       int* free_mb, int* conc, long long sa,
                                       long long sn, int n, int a,
                                       const int* penalty, int* chosen,
                                       int* forced, int* rounds,
                                       void* scratch, void* stream,
                                       int* grid_blocks) {
  if (b < 1 || b > REPAIR_MAX_BATCH) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!g_grid[dev]) {
    const int smem_max = (int)repair_smem_bytes(REPAIR_MAX_BATCH);
    err = cudaFuncSetAttribute(placement_repair_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_max);
    if (err != cudaSuccess) return (int)err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, placement_repair_kernel, REPAIR_THREADS, smem_max);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    g_grid[dev] = per_sm * sms;
  }
  const int blocks = g_grid[dev];
  void* args[] = {&reqs, &b, &health, &free_mb, &conc, &sa, &sn, &n, &a,
                  &penalty, &chosen, &forced, &rounds, &scratch};
  err = cudaLaunchCooperativeKernel((const void*)placement_repair_kernel,
                                    dim3(blocks), dim3(REPAIR_THREADS), args,
                                    repair_smem_bytes(b),
                                    (cudaStream_t)stream);
  *grid_blocks = blocks;
  return (int)err;
}
