// The release fold for Hopper (sm_90a): one launch folds a step's
// completion releases into the books.
//
// Replaces no Pallas kernel. The JAX package folds releases inside the
// step's one XLA program (openwhisk_tpu/ops/placement.py `release_batch`,
// a loop over the R rows, and `release_batch_vector` at buckets >= 32),
// so there the fold costs nothing on the host. Written as torch ops, the
// port's fold dispatched some fifteen small ops a row below 32 rows (the
// per-row loop of ops/placement.py `release_batch`) and, at 32 rows and
// more, some forty ops and one host synchronisation (the heterogeneous
// residue of `release_batch_vector`, read back with `nonzero().tolist()`).
// On the event loop of a balancer that owns the card that cost
// milliseconds a step, enough to stall the admission funnel's process
// (PERF.md, ROADMAP Queue 3 item 12). This kernel is one launch a fold,
// at every bucket, with no host read.
//
// What it computes, bit-exact with ops/placement.py `release_batch` (the
// rows in batch order): a valid row with max_conc <= 1 returns need_mb to
// free[inv]; a valid row with max_conc > 1 adds one permit to
// conc[inv, slot], and when that makes a whole container's worth
// (conc + 1 >= max_conc) it takes max_conc back off the cell and returns
// need_mb to free[inv] (NestedSemaphore.releaseConcurrent). Invalid rows
// do nothing. Rows outside the books (inv not in [0, N), or a concurrency
// row's slot not in [0, A)) are outside the contract; they are dropped.
//
// What bounds it on this card. Nothing but its latency: R rows of 17 bytes
// and the cells they touch are a few kilobytes (nanoseconds at
// 3.35 TB/s), and a fold is a few hundred integer operations. The chain
// that has to stay serial is the rows that share one concurrency cell,
// and only where they differ in need or max_conc.
//
// What the design does about it. One block; the rows are staged in shared
// memory one chunk of up to RELEASE_THREADS rows at a time (chunks in
// batch order), one thread a row. Memory returns are integer atomics on
// free[inv]: they commute, so their order does not change the sum. A
// concurrency row starts reading its cell at once; the read is awaited
// only after the sort. Concurrency rows are compacted to the front (a
// ballot and a prefix over the warps) and group by their cell with a
// bitonic sort of (cell, row) keys in registers over the smallest power
// of two that holds them: strides below a warp go through shuffles, wider
// ones through a double-buffered shared array, one barrier a stage, so a
// fold of memory rows sorts one warp. Sorting by row within a cell keeps
// batch order, so
// each cell is one segment of the sorted keys; neighbours mark its head,
// a max-scan gives each row its head, and each row flags its segment
// heterogeneous when its need or max_conc differs from the head's row.
// The head then applies the whole segment: a homogeneous one (the steady
// state) in `release_batch_vector`'s closed form, wraps =
// clip(floor((c0 + k) / max_conc), 0, k); a heterogeneous one by walking
// its own rows in batch order. No thread reads rows of another cell, so
// the dependent chain is about log2(R)^2 / 2 sort stages plus the longest
// heterogeneous cell, where the first design scanned every earlier and
// every later row of the chunk (about 2R shared reads). Only the head
// writes its cell, so the fold has no race and no cross-block step; the
// barrier between chunks orders a cell's writes across them.
#include <cuda_runtime.h>

namespace {

constexpr int RELEASE_THREADS = 1024;
constexpr int ROW_BITS = 10;  // a row's index in its chunk: < 2^10
// the cell code of a row that is not a concurrency row: above every cell
// (the wrapper keeps N * A below it), so such rows sort last
constexpr unsigned long long NO_CELL = 1ull << 53;

__device__ __forceinline__ int floor_div(int x, int d) {  // d > 0
  const int q = x / d;
  return (x % d != 0 && x < 0) ? q - 1 : q;
}

__global__ void __launch_bounds__(RELEASE_THREADS)
release_fold_kernel(const int* __restrict__ inv, const int* __restrict__ slot,
                    const int* __restrict__ need,
                    const int* __restrict__ max_conc,
                    const unsigned char* __restrict__ valid, int r,
                    int* free_mb, int* conc, long long sn, long long sa,
                    int n, int a) {
  __shared__ unsigned long long s_key[2][RELEASE_THREADS];
  __shared__ int s_inv[RELEASE_THREADS];
  __shared__ int s_slot[RELEASE_THREADS];
  __shared__ int s_need[RELEASE_THREADS];
  __shared__ int s_maxc[RELEASE_THREADS];
  __shared__ int s_c0[RELEASE_THREADS];           // by row: its cell's value
  __shared__ int s_end[RELEASE_THREADS];          // by a head's position
  __shared__ unsigned char s_het[RELEASE_THREADS];  // by a head's position
  __shared__ int s_warp[32];
  const int t = threadIdx.x, nt = blockDim.x;  // nt: a power of two >= 32
  const int lane = t & 31, warp = t >> 5, warps = nt >> 5;
  int buf = 0;
  for (int base = 0; base < r; base += nt) {
    const int rows = min(nt, r - base);
    // 1. stage the row; a memory row returns its memory now, a
    //    concurrency row starts the read of its cell (awaited after the
    //    sort, which does not need it)
    unsigned long long key = (NO_CELL << ROW_BITS) | t;
    int c0 = 0;
    if (t < rows) {
      const int i = base + t;
      const int iv = inv[i], sl = slot[i], mc = max_conc[i], nd = need[i];
      if (valid[i] && iv >= 0 && iv < n) {
        if (mc <= 1) {
          atomicAdd(free_mb + iv, nd);
        } else if (sl >= 0 && sl < a) {
          key = ((unsigned long long)((long long)iv * a + sl) << ROW_BITS) |
                t;
          c0 = conc[iv * sn + sl * sa];
        }
      }
      s_inv[t] = iv;
      s_slot[t] = sl;
      s_need[t] = nd;
      s_maxc[t] = mc;
    }
    s_het[t] = 0;
    // 2. compact the concurrency rows to the front (in row order), so the
    //    sort spans the smallest power of two >= their count
    const bool is_row = key != ((NO_CELL << ROW_BITS) | t);
    const unsigned ballot = __ballot_sync(0xffffffffu, is_row);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int before = (lane < warp) ? s_warp[lane] : 0;
    int total = (lane < warps) ? s_warp[lane] : 0;
    for (int d = 16; d > 0; d >>= 1) {
      before += __shfl_xor_sync(0xffffffffu, before, d);
      total += __shfl_xor_sync(0xffffffffu, total, d);
    }
    int span = 32;
    while (span < total) span <<= 1;
    if (is_row)
      s_key[buf][before + __popc(ballot & ((1u << lane) - 1))] = key;
    if (t >= total) s_key[buf][t] = (NO_CELL << ROW_BITS) | t;
    __syncthreads();
    key = s_key[buf][t];
    buf ^= 1;
    // 3. bitonic sort of the first `span` keys, ascending: thread t ends
    //    holding the key at sorted position t (positions from `span` on
    //    hold no row, and their warps trade among themselves)
    for (int k = 2; k <= span; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        unsigned long long other;
        if (j >= 32) {
          s_key[buf][t] = key;
          __syncthreads();
          other = s_key[buf][t ^ j];
          buf ^= 1;
        } else {
          other = __shfl_xor_sync(0xffffffffu, key, j);
        }
        const bool keep_min = ((t & j) == 0) == ((t & k) == 0);
        key = keep_min ? min(key, other) : max(key, other);
      }
    }
    s_key[buf][t] = key;
    s_c0[t] = c0;
    __syncthreads();
    const unsigned long long* sorted = s_key[buf];
    buf ^= 1;
    // 4. segments: a head starts each cell's run; a max-scan of the head
    //    positions gives each position its head
    const unsigned long long cell = key >> ROW_BITS;
    const bool is_conc = cell != NO_CELL;
    const bool head =
        is_conc && (t == 0 || (sorted[t - 1] >> ROW_BITS) != cell);
    int h = head ? t : -1;
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, h, d);
      if (lane >= d) h = max(h, up);
    }
    if (lane == 31) s_warp[warp] = h;
    __syncthreads();
    int earlier = (lane < warp) ? s_warp[lane] : -1;
    for (int d = 16; d > 0; d >>= 1)
      earlier = max(earlier, __shfl_xor_sync(0xffffffffu, earlier, d));
    h = max(h, earlier);
    if (is_conc) {
      const int row = (int)(key & ((1u << ROW_BITS) - 1));
      const int head_row = (int)(sorted[h] & ((1u << ROW_BITS) - 1));
      if (s_need[row] != s_need[head_row] || s_maxc[row] != s_maxc[head_row])
        s_het[h] = 1;
      if (t == nt - 1 || (sorted[t + 1] >> ROW_BITS) != cell) s_end[h] = t;
    }
    __syncthreads();
    // 5. each head applies its cell's rows, in batch order
    if (head) {
      const int row = (int)(key & ((1u << ROW_BITS) - 1));
      const int iv = s_inv[row];
      const int c_start = s_c0[row], end = s_end[t];
      unsigned back = 0;
      int c = c_start;
      if (!s_het[t]) {
        const int k = end - t + 1, mc = s_maxc[row];
        const int wraps = min(max(floor_div(c_start + k, mc), 0), k);
        c = c_start + k - mc * wraps;
        back = (unsigned)s_need[row] * (unsigned)wraps;
      } else {
        for (int p = t; p <= end; ++p) {
          const int rj = (int)(sorted[p] & ((1u << ROW_BITS) - 1));
          c += 1;
          if (c >= s_maxc[rj]) {
            c -= s_maxc[rj];
            back += (unsigned)s_need[rj];
          }
        }
      }
      conc[iv * sn + s_slot[row] * sa] = c;
      if (back) atomicAdd(free_mb + iv, (int)back);
    }
    __syncthreads();
  }
}

__global__ void empty_kernel() {}

}  // namespace

// Launch the fold on `stream`: rows int32[R] (valid as bytes), the books'
// free int32[N] and conc int32 cells at conc + inv * sn + slot * sa.
// Returns a cudaError_t as int (0 when the launch was taken).
extern "C" int release_fold_launch(const int* inv, const int* slot,
                                   const int* need, const int* max_conc,
                                   const unsigned char* valid, int r,
                                   int* free_mb, int* conc, long long sn,
                                   long long sa, int n, int a, void* stream) {
  if (r < 0 || n < 1 || a < 1 ||
      (unsigned long long)n * (unsigned long long)a >= NO_CELL)
    return (int)cudaErrorInvalidValue;
  if (r == 0) return 0;
  int threads = 32;
  while (threads < r && threads < RELEASE_THREADS) threads <<= 1;
  release_fold_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      inv, slot, need, max_conc, valid, r, free_mb, conc, sn, sa, n, a);
  return (int)cudaGetLastError();
}

// One launch of an empty kernel on `stream`: the floor under any launch of
// this library, measured the same way as the fold. A measurement hook that
// no path of the balancer calls.
extern "C" int release_fold_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
