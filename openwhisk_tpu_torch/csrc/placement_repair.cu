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
//    as the plain argmin over a row of sentinels does. Warp w of block k
//    takes items w * G + k, + 32 G, ... (G blocks): a round of few items
//    gets an SM each, where 32 warps of gathers on one SM would queue.
//  * From round 1 on, a row whose fitting set can only have shrunk since
//    the round before resumes its walk: one work item probes the ranks
//    from `from`, the rank its probe found then, in rank order (idx = off
//    + (home + t * step) mod m, step = step_inv^-1 mod m from an extended
//    Euclid in round 0), RESUME_CHUNK ranks at a time up to
//    RESUME_CHUNKS of them, until a chunk holds a fit. A resumed
//    row that finds no fit there and has ranks left (a miss) raises a
//    grid-wide flag; after one more grid barrier every block lists the
//    missed rows and the grid probes their whole windows (phase A2). A
//    row that fit nowhere the round before fits nowhere now, and loads
//    nothing. Its anyc (col_conc) is carried over.
//  * Phases B-D on block 0: use_conc and free_at_sel at the final sel (a
//    thread a row); the conflict rules and the commit set with `lanes`
//    threads a row, each looping over a share of the pending rows only and
//    reduced with shuffles (or, sum, max: exact in any order); the integer
//    atomicAdd commits (exact in any order; an out-of-range slot's write
//    is dropped) and the next round's resets; then the next round's list
//    of pending rows, where each probe starts, and the first work item of
//    each, written to scratch for phase A.
//  * Books and scratch are read with ld.global.cg (L2), so every block sees
//    the commits and the list of the round before.
//
// Why resuming is exact. In an unpenalized launch row i's key at invoker x
// is its rank, finite exactly when x is healthy, in the window and
// conc[slot_i][x] > 0 || free[x] >= need_i (slot_i the clamped read slot).
// Within a launch health is fixed, free only falls (a commit subtracts a
// non-negative need without wrapping), and conc[slot_i] changes only
// through the commit of a row j with slot_ok_j, slot_j == slot_i and a
// nonzero delta. So where no such commit and no rise of free happened in
// the round before, the set of invokers that fit row i only shrank: its
// argmin's rank is at or above the round before's, and its anyc is
// unchanged. Where 0 <= step_inv < m <= 2^17, gcd(step_inv, m) == 1 and
// 0 <= home < m, rank = (local - home) * step_inv mod m is the true
// product and a bijection of [0, m), so no two invokers tie and rank t
// sits at local (home + t * step) mod m. The minimum over the first pass
// and, on a miss, the whole window is then the full probe's. Block 0
// decides the reset in phase D, from the commits it makes: a row whose
// read slot's permit column took a nonzero delta, every row when a commit
// may have raised free memory (a negative need, or a free value it read
// within the launch's summed needs of INT_MIN, where the sum could wrap),
// every row of a penalized launch and every row outside the contract
// above takes the whole-window probe instead.
//
// Scratch (REPAIR_SCRATCH_ROW_BYTES a row plus a header) comes from the
// wrapper. Block 0 keeps REPAIR_ROW_INTS ints a row in shared memory and
// every block LIST_ROW_INTS more for its copy of the list (rows, first
// items, where each probe starts, probe steps); one thread a row
// in block 0 bounds B at 1,024. Beside the rounds the kernel returns three
// sums over the launch: rows probed (listed), of them resumed, and resumed
// rows that missed the first pass.
#include <climits>

#include <cooperative_groups.h>

#include "placement_common.cuh"

namespace cg = cooperative_groups;

constexpr int REPAIR_THREADS = 1024;
constexpr int REPAIR_WARPS = REPAIR_THREADS / 32;
constexpr int REPAIR_MAX_BATCH = REPAIR_THREADS;
// invokers of one window per work item: 8 a lane
constexpr int PROBE_PER_LANE = 8;
constexpr int PROBE_CHUNK = 32 * PROBE_PER_LANE;
// a resumed row's first pass, in its one work item: up to RESUME_CHUNKS
// chunks of RESUME_CHUNK ranks, RESUME_PER_LANE a lane (ops/placement_cuda.py
// RESUME_RANKS is their product)
constexpr int RESUME_PER_LANE = 8;
constexpr int RESUME_CHUNK = 32 * RESUME_PER_LANE;
constexpr int RESUME_CHUNKS = 4;
// the mulmod contract (placement_common.cuh): partitions up to 2^17
constexpr int MULMOD_MAX_M = 1 << 17;
// shared-memory ints per row (ops/placement_cuda.py REPAIR_ROW_BYTES is
// 4 * (REPAIR_ROW_INTS + LIST_ROW_INTS)) and scratch bytes per row
// (REPAIR_SCRATCH_ROW_BYTES there)
constexpr int REPAIR_ROW_INTS = 29;
constexpr int LIST_ROW_INTS = 4;
constexpr int REPAIR_SCRATCH_ROW_BYTES = 40;
constexpr int MAX_DEVICES = 64;
// a row's `from` when it takes the whole-window probe
constexpr int FULL_PROBE = -1;

// block 0's per-row state
struct Rows {
  // request fields (slot clamped to [0, A), slot_ok = it was in range;
  // m = max(size, 1)), the row's count of work items over its whole
  // window, and its probe step (step_inv's inverse mod m; -1 where the
  // row never resumes)
  int *need, *slot, *maxc, *valid, *slot_ok, *m, *nitems, *step;
  // loop-invariant forced choice
  int *fchoice, *have_usable;
  // this round's probe as merged: its key (the rank found) in rank, its
  // index in sel, and in flags anyc (bit 0) and a resumed probe's miss
  // (bit 1); then the round's speculation, rank becoming the rank found
  // (m where none fit)
  int *flags;
  int *sel, *placed, *forced, *use_conc, *take_mem, *col_conc, *free_at_sel,
      *rank;
  // loop state; from: where this round's probe starts (FULL_PROBE or a
  // rank)
  int *pending, *chosen, *forced_acc, *from;
  // conflict-rule intermediates; wslot: the permit columns this round's
  // commits wrote, compacted
  int *hard, *prior_mem, *grow_pot, *safe, *wslot;
  // the row's rounds resumed (low 16 bits) and missed (high), for the
  // launch's sums
  int *counts;
};

__device__ __forceinline__ Rows carve_rows(int* p, int b) {
  Rows r;
  int** fields[REPAIR_ROW_INTS] = {
      &r.need, &r.slot, &r.maxc, &r.valid, &r.slot_ok, &r.m, &r.nitems,
      &r.step, &r.fchoice, &r.have_usable, &r.flags, &r.sel, &r.placed,
      &r.forced, &r.use_conc, &r.take_mem, &r.col_conc, &r.free_at_sel,
      &r.rank, &r.pending, &r.chosen, &r.forced_acc, &r.from, &r.hard,
      &r.prior_mem, &r.grow_pot, &r.safe, &r.wslot, &r.counts};
  for (int f = 0; f < REPAIR_ROW_INTS; ++f) *fields[f] = p + f * b;
  return r;
}

// state the blocks share, in global memory
struct Scratch {
  unsigned long long *best;   // [B] this round's probe argmin per row
  unsigned long long *fbest;  // [B] forced-rotation argmin per row
  int *anyc;                  // [B] a usable window column holds a permit
  int *miss;                  // [B] a resumed probe found no fit in time
  int *list;                  // [B] pending rows, in batch order
  int *from;                  // [B] where each listed row's probe starts
  int *step;                  // [B] each listed row's probe step
  int *first;                 // [B + 1] first item of each; [count] = total
  int *ctrl;                  // [0] listed rows, [1] another round runs,
                              // [2] some resumed row missed
};

__device__ __forceinline__ Scratch carve_scratch(void* p, int b) {
  Scratch s;
  auto* u = static_cast<unsigned long long*>(p);
  s.best = u;
  s.fbest = u + b;
  int* q = reinterpret_cast<int*>(u + 2 * b);
  s.anyc = q;
  s.miss = q + b;
  s.list = q + 2 * b;
  s.from = q + 3 * b;
  s.step = q + 4 * b;
  s.first = q + 5 * b;
  s.ctrl = q + 6 * b + 1;
  return s;
}
static_assert(REPAIR_SCRATCH_ROW_BYTES ==
                  2 * sizeof(unsigned long long) + 6 * sizeof(int),
              "scratch per row: best, fbest, anyc, miss, list, from, step, "
              "first");

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

// the inverse of a mod m (0 <= a < m), or -1 where gcd(a, m) != 1
__device__ int inverse_mod(int a, int m) {
  int t = 0, nt = 1, r = m, nr = a;
  while (nr != 0) {
    const int q = r / nr;
    int x = t - q * nt;
    t = nt;
    nt = x;
    x = r - q * nr;
    r = nr;
    nr = x;
  }
  if (r != 1) return -1;
  return t < 0 ? t + m : t;
}

// block 0: list the pending rows in batch order, with the first work item
// of each (a whole-window probe takes its window's items, none for an
// empty window; a resumed probe one, none where it starts past the last
// rank), where each probe starts and its step, and say whether another
// round runs
__device__ void publish_list(const Rows& r, const Scratch& s, int b,
                             int* warp_sums, bool go) {
  const int i = threadIdx.x;
  const bool listed = i < b && r.pending[i];
  int items = 0;
  if (listed) {
    const int from = r.from[i];
    items = from == FULL_PROBE ? r.nitems[i] : (from < r.m[i] ? 1 : 0);
  }
  int count, total;
  const int pos = block_exclusive_sum(listed ? 1 : 0, warp_sums, &count);
  const int first = block_exclusive_sum(items, warp_sums, &total);
  if (listed) {
    s.list[pos] = i;
    s.first[pos] = first;
    s.from[pos] = r.from[i];
    s.step[pos] = r.step[i];
  }
  if (i == 0) {
    s.first[count] = total;
    s.ctrl[0] = count;
    s.ctrl[1] = go ? 1 : 0;
  }
}

// the listed row that owns work item `item`: the last k with first[k] <=
// item (rows without items share their first with the next row)
__device__ __forceinline__ int item_owner(const int* s_first, int count,
                                          int item) {
  int k = 0, kh = count - 1;
  while (k < kh) {
    const int mid = (k + kh + 1) >> 1;
    if (s_first[mid] <= item) k = mid; else kh = mid - 1;
  }
  return k;
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

// phase A for a resumed row: its one work item, by one warp, probes the
// ranks [from, from + RESUME_CHUNKS * RESUME_CHUNK) below m in rank order,
// a chunk at a time, and stops at the first chunk that holds a fit. Rank t
// sits at local (home + t * step) mod m; a lane's locals step by 32 * step
// mod m. No fit there with ranks left is a miss: the row's whole window
// follows in phase A2. Not inlined, which keeps the round loop's register
// use down (measured: phases B-D 0.8 us a round faster on the H100).
__device__ __noinline__ void probe_resumed(
    const int* __restrict__ reqs, int b, int i, int from, int step,
    const unsigned char* __restrict__ health, const int* free_mb,
    const int* conc, long long sa, long long sn, int n, int a, int big,
    const Scratch& s) {
  const int lane = threadIdx.x & 31;
  const int off = __ldg(reqs + R_OFFSET * b + i);
  const int m = __ldg(reqs + R_SIZE * b + i);  // >= 1 where a row resumes
  const int home = __ldg(reqs + R_HOME * b + i);
  const int need = __ldg(reqs + R_NEED * b + i);
  const int slot = min(max(__ldg(reqs + R_SLOT * b + i), 0), a - 1);
  const int* crow = conc + (long long)slot * sa;
  int lo, hi;
  window(off, m, n, lo, hi);
  const int local_step = mulmod(32, step, m);
  int local = home + mulmod(from + lane, step, m);
  if (local >= m) local -= m;
  uint64_t best = ~0ull;
  int start = from;
  for (int c = 0; c < RESUME_CHUNKS && start < m; ++c) {
    // every load of the chunk first, as in probe_item; the second loop
    // steps the same locals again
    const int local0 = local;
    int hv[RESUME_PER_LANE], cv[RESUME_PER_LANE], fv[RESUME_PER_LANE];
#pragma unroll
    for (int k = 0; k < RESUME_PER_LANE; ++k) {
      const long long x = (long long)off + local;
      const bool in = start + lane + 32 * k < m && x >= lo && x < hi;
      const int xi = in ? (int)x : 0;
      hv[k] = in ? health[xi] : 0;
      cv[k] = in ? load_book(crow + xi * sn) : 0;
      fv[k] = in ? load_book(free_mb + xi) : 0;
      local += local_step;
      if (local >= m) local -= m;
    }
    local = local0;
#pragma unroll
    for (int k = 0; k < RESUME_PER_LANE; ++k) {
      if (hv[k] && (cv[k] > 0 || fv[k] >= need)) {
        const uint64_t kp = pack_key(start + lane + 32 * k, off + local);
        best = kp < best ? kp : best;
      }
      local += local_step;
      if (local >= m) local -= m;
    }
    best = warp_min_u64(best);
    if (key_of(best) < big) break;
    start += RESUME_CHUNK;
  }
  if (lane == 0) {
    if (key_of(best) < big) {
      atomicMin(s.best + i, best);
    } else if (start < m) {
      s.miss[i] = 1;
      s.ctrl[2] = 1;
    }
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

// phase A2, by every block: list the resumed rows that missed from their
// flags (every block the same way, over its copy of the round's list) and
// probe their whole windows. Not inlined: it runs in few rounds, and its
// registers stay out of the round loop's.
__device__ __noinline__ void second_pass(
    const int* __restrict__ reqs, int b, int count, const int* s_list,
    int* s_first, int* warp_sums, const unsigned char* __restrict__ health,
    const int* free_mb, const int* conc, long long sa, long long sn, int n,
    int a, int big, const int* __restrict__ penalty, const Scratch& s) {
  const int tid = threadIdx.x;
  int items = 0;
  if (tid < count) {
    const int i = s_list[tid];
    if (__ldcg(s.miss + i)) {
      int lo, hi;
      window(__ldg(reqs + R_OFFSET * b + i), __ldg(reqs + R_SIZE * b + i),
             n, lo, hi);
      items = (hi - lo + PROBE_CHUNK - 1) / PROBE_CHUNK;
    }
  }
  int total;
  const int first = block_exclusive_sum(items, warp_sums, &total);
  if (tid < count) s_first[tid] = first;
  if (tid == 0) s_first[count] = total;
  __syncthreads();
  for (int item = (tid >> 5) * gridDim.x + blockIdx.x; item < total;
       item += gridDim.x * REPAIR_WARPS) {
    const int k = item_owner(s_first, count, item);
    probe_item(reqs, b, s_list[k], item - s_first[k], health, free_mb,
               conc, sa, sn, n, a, big, penalty, false, s);
  }
}

__global__ void __launch_bounds__(REPAIR_THREADS, 1)
placement_repair_kernel(const int* __restrict__ reqs, int b,
                        const unsigned char* __restrict__ health,
                        int* free_mb, int* conc, long long sa, long long sn,
                        int n, int a, const int* __restrict__ penalty,
                        int* __restrict__ chosen_out,
                        int* __restrict__ forced_out,
                        int* __restrict__ stats_out, void* scratch) {
  extern __shared__ int smem[];
  __shared__ int first_bad, n_writes, free_rose;
  // block 0: rows listed, summed over the rounds
  __shared__ int n_probed;
  __shared__ int warp_sums[REPAIR_WARPS];
  // block 0: the needs of the launch's valid rows, summed (each from 0)
  __shared__ unsigned long long need_sum;
  cg::grid_group grid = cg::this_grid();
  const Scratch s = carve_scratch(scratch, b);
  int* s_list = smem;            // [b]
  int* s_first = smem + b;       // [b + 1]
  int* s_from = smem + 2 * b + 1;  // [b]
  int* s_step = smem + 3 * b + 1;  // [b]
  Rows r = carve_rows(smem + 4 * b + 1, b);  // block 0's
  const int tid = threadIdx.x;
  const bool leader = blockIdx.x == 0;
  const int big = penalty ? (1 << 30) : n + 2;
  const int lanes = row_lanes(b);

  if (leader) {
    if (tid == 0) {
      need_sum = 0;
      n_probed = 0;
    }
    __syncthreads();
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
      const int size = reqs[R_SIZE * b + i], home = reqs[R_HOME * b + i];
      const int sinv = reqs[R_STEP_INV * b + i];
      int lo, hi;
      window(reqs[R_OFFSET * b + i], size, n, lo, hi);
      r.m[i] = max(size, 1);
      r.nitems[i] = valid ? (hi - lo + PROBE_CHUNK - 1) / PROBE_CHUNK : 0;
      // a row resumes only inside the contract of the note above
      int step = -1;
      if (!penalty && valid && size >= 1 && size <= MULMOD_MAX_M &&
          home >= 0 && home < size && sinv >= 0 && sinv < size)
        step = inverse_mod(sinv, size);
      r.step[i] = step;
      r.from[i] = FULL_PROBE;
      r.rank[i] = 0;
      r.pending[i] = valid;
      r.chosen[i] = -1;
      r.forced_acc[i] = 0;
      r.fchoice[i] = r.have_usable[i] = 0;
      r.sel[i] = r.placed[i] = r.forced[i] = r.use_conc[i] = 0;
      r.take_mem[i] = r.col_conc[i] = r.free_at_sel[i] = 0;
      r.counts[i] = 0;
      s.best[i] = s.fbest[i] = ~0ull;
      s.anyc[i] = s.miss[i] = 0;
    }
    unsigned long long need = valid ? max(r.need[tid], 0) : 0;
    for (int o = 16; o > 0; o >>= 1)
      need += __shfl_xor_sync(0xffffffffu, need, o);
    if ((tid & 31) == 0 && need) atomicAdd(&need_sum, need);
    if (tid == 0) s.ctrl[2] = 0;
    publish_list(r, s, b, warp_sums, __syncthreads_or(valid));
  }
  grid.sync();

  int rounds = 0;
  while (__ldcg(s.ctrl + 1)) {
    // A. probe the listed rows over the whole grid: a whole window in
    // PROBE_CHUNK items, or a resumed walk's first pass in one
    const bool setup = rounds == 0;
    const int count = __ldcg(s.ctrl);
    for (int t = tid; t <= count; t += blockDim.x) {
      s_first[t] = __ldcg(s.first + t);
      if (t < count) {
        s_list[t] = __ldcg(s.list + t);
        s_from[t] = __ldcg(s.from + t);
        s_step[t] = __ldcg(s.step + t);
      }
    }
    __syncthreads();
    const int total = s_first[count];
    for (int item = (tid >> 5) * gridDim.x + blockIdx.x; item < total;
         item += gridDim.x * REPAIR_WARPS) {
      const int k = item_owner(s_first, count, item);
      if (s_from[k] == FULL_PROBE)
        probe_item(reqs, b, s_list[k], item - s_first[k], health, free_mb,
                   conc, sa, sn, n, a, big, penalty, setup, s);
      else
        probe_resumed(reqs, b, s_list[k], s_from[k], s_step[k], health,
                      free_mb, conc, sa, sn, n, a, big, s);
    }
    grid.sync();

    // block 0 reads its rows' merged probes, and a miss among them is the
    // grid's miss flag; the other blocks read the flag
    const bool held = leader && tid < b && r.pending[tid];
    bool second = false;
    if (leader) {
      int miss = 0;
      if (held) {
        const uint64_t bv = __ldcg(s.best + tid);
        r.rank[tid] = key_of(bv);
        r.sel[tid] = idx_of(bv);
        miss = __ldcg(s.miss + tid);
        r.flags[tid] = (__ldcg(s.anyc + tid) != 0) | (miss ? 2 : 0);
      }
      second = __syncthreads_or(miss);
    } else {
      second = __ldcg(s.ctrl + 2) != 0;
    }
    // A2. the whole windows of the resumed rows that missed
    if (second) {
      second_pass(reqs, b, count, s_list, s_first, warp_sums, health,
                  free_mb, conc, sa, sn, n, a, big, penalty, s);
      grid.sync();
      if (held && (r.flags[tid] & 2)) {
        const uint64_t bv = __ldcg(s.best + tid);
        r.rank[tid] = key_of(bv);
        r.sel[tid] = idx_of(bv);
      }
    }

    if (leader) {
      // the round's speculation per pending row, from the merged argmins
      if (tid < b) {
        const int i = tid;
        if (setup && r.valid[i]) finish_forced(reqs, b, i, n, big, s, r);
        if (held) {
          const int key = r.rank[i];
          const bool found = key < big;
          const int sel = found ? r.sel[i] : r.fchoice[i];
          const bool have_usable = r.have_usable[i] != 0;
          const bool placed = found || have_usable;
          const int* crow = conc + (long long)r.slot[i] * sa;
          const bool use_conc = placed && load_book(crow + sel * sn) > 0;
          const bool was_resumed = r.from[i] != FULL_PROBE;
          r.sel[i] = sel;
          r.placed[i] = placed;
          r.forced[i] = !found && have_usable;
          r.use_conc[i] = use_conc;
          r.take_mem[i] = placed && !use_conc;
          // a resumed row's anyc is the round before's
          if (!was_resumed) r.col_conc[i] = r.flags[i] & 1;
          r.free_at_sel[i] = load_book(free_mb + sel);
          r.rank[i] = found ? key : r.m[i];
          r.counts[i] +=
              (was_resumed ? 1 : 0) + (r.flags[i] & 2 ? 1 << 16 : 0);
          s.best[i] = ~0ull;
          s.anyc[i] = s.miss[i] = 0;
        }
      }
      if (tid == 0) {
        first_bad = b;
        n_writes = free_rose = 0;
        n_probed += count;
        s.ctrl[2] = 0;
      }
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

      // D. commit the settled rows and retire them, noting what the
      // commits changed that a resumed probe cannot see: the permit
      // columns written (n_writes of them in wslot, in any order) and
      // free memory that may have risen (a negative need, or a sum of the
      // launch's needs that could wrap the value the row read)
      int still = 0;
      if (tid < b) {
        const int i = tid;
        if (r.safe[i]) {
          const int sel = r.sel[i];
          if (r.placed[i]) {
            const bool tm = r.take_mem[i] != 0;
            if (tm) {
              atomicAdd(free_mb + sel, -r.need[i]);
              if (r.need[i] < 0 ||
                  (long long)r.free_at_sel[i] - (long long)need_sum < INT_MIN)
                free_rose = 1;
            }
            const int delta = r.use_conc[i] ? -1
                              : (tm && r.maxc[i] > 1 ? r.maxc[i] - 1 : 0);
            if (r.slot_ok[i] && delta != 0) {
              atomicAdd(conc + (long long)r.slot[i] * sa +
                            (long long)sel * sn,
                        delta);
              r.wslot[atomicAdd(&n_writes, 1)] = r.slot[i];
            }
          }
          r.chosen[i] = r.placed[i] ? sel : -1;
          if (r.forced[i]) r.forced_acc[i] = 1;
          r.pending[i] = 0;
        }
        still = r.pending[i];
      }
      const bool any_pending = __syncthreads_or(still);
      // where the next round's probe of each pending row starts
      if (still) {
        const int i = tid;
        bool reset = free_rose || r.step[i] < 0;
        for (int w = 0; w < n_writes && !reset; ++w)
          reset = r.wslot[w] == r.slot[i];
        r.from[i] = reset ? FULL_PROBE : r.rank[i];
      }
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
    // the launch's sums beside its rounds
    const int c = tid < b ? r.counts[tid] : 0;
    int resumed, missed;
    block_exclusive_sum(c & 0xffff, warp_sums, &resumed);
    block_exclusive_sum(c >> 16, warp_sums, &missed);
    if (tid == 0) {
      stats_out[0] = rounds;
      stats_out[1] = n_probed;
      stats_out[2] = resumed;
      stats_out[3] = missed;
    }
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
                                       int* forced, int* stats,
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
                  &penalty, &chosen, &forced, &stats, &scratch};
  err = cudaLaunchCooperativeKernel((const void*)placement_repair_kernel,
                                    dim3(blocks), dim3(REPAIR_THREADS), args,
                                    repair_smem_bytes(b),
                                    (cudaStream_t)stream);
  *grid_blocks = blocks;
  return (int)err;
}
