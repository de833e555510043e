// Sequential placement scan for Hopper (sm_90a), on one thread-block cluster.
//
// Replaces the Pallas TPU kernel `schedule_batch_pallas`
// (openwhisk_tpu/ops/placement_pallas.py, body `_kernel_body`, and its
// penalized variant `_kernel_penalized`): B requests placed one after the
// other, each with a probe-rank argmin over its partition window (eligible
// = in the window, healthy, and holding a concurrency permit or enough free
// memory; lowest index breaks ties), a forced random-rotation fallback over
// the usable invokers, and the NestedSemaphore update of free[sel] and
// conc[slot, sel]. Bit-exact with ops/placement.py::schedule_batch.
//
// What bounds it on this card. The bytes are few: free and health over the
// windows, each distinct conc row over its rows' windows and the changed
// cells (about 1 MB at B = 16, N = 16,384: some 0.3 us at 3.35 TB/s). What
// bounds it is the serial chain: request i + 1 cannot probe before request
// i's capacity update, so a batch is B dependent fleet-wide argmins, and
// the floor of each is one reduction across the cluster: shuffles, one
// block barrier, and an exchange of every block's minima through
// distributed shared memory.
//
// What the design does about it.
//  * One cluster of C blocks x 1,024 threads (C = 16, a non-portable
//    cluster size; 8 if the card cannot place 16). Thread t of the cluster
//    owns the invoker columns t + k * C * 1,024 (k < K) for the whole
//    launch and keeps their free memory, health and penalty in registers.
//    The scan reads and writes the books only at column sel, and one
//    thread owns sel, so no book value crosses threads: free is written
//    back once, at the end.
//  * Each thread loads its columns' conc values for request i + D while
//    request i runs (a D-deep ring in registers, D a compile-time depth).
//    When request i commits at a column, its owner stores the new cell and
//    adds the same delta to every value it already holds for a later
//    request whose clamped slot is i's slot, unless i's write is dropped
//    (an out-of-range slot). Loads it issues after the store see the
//    store, so each commit reaches each later read exactly once.
//  * Only columns inside [offset, offset + size) are probed; a request that
//    is invalid or whose window is empty skips the reduction. A row inside
//    the _mulmod contract (home, rand and step_inv in [0, m), m <= 2^17)
//    takes its ranks as one 64-bit product reduced by Barrett's method,
//    with the reciprocal of m computed when the row is staged, in place of
//    the four dependent divisions of mulmod; the result is the same.
//  * The two packed (key << 32 | idx) minima meet across the cluster with
//    no cluster barrier (cluster_exchange.cuh): a reduction over the
//    block's warps (one __syncthreads), then every block's minima written
//    into every block's inbox with st.async, counted on an mbarrier. A
//    cluster barrier alone, or a shared-memory atomicMin, a cluster
//    barrier and a read through distributed shared memory (this kernel's
//    first design), cost more: chip_smoke.py times all three
//    (csrc/cluster_barrier.cu).
//  * The request matrix is staged in shared memory, SCAN_CHUNK rows at a
//    time plus the D rows the prefetch looks ahead.
#include <cooperative_groups.h>

#include "cluster_exchange.cuh"
#include "placement_common.cuh"

namespace cg = cooperative_groups;

constexpr int SCAN_THREADS = 1024;
// the _mulmod contract's largest fleet (ops/placement_cuda.py SCAN_MAX_N):
// 8 columns a thread at C = 16, 16 at C = 8
constexpr int SCAN_MAX_N = 1 << 17;
// request rows staged in shared memory at a time
constexpr int SCAN_CHUNK = 1024;
constexpr int MAX_DEVICES = 64;

// Prefetch depth at K columns a thread: the ring's D * K values share the
// 64 registers a thread has at 1,024 threads a block with K free and K
// penalty values.
constexpr int scan_depth(int k) { return k <= 4 ? 4 : (k == 8 ? 2 : 1); }

struct ScanArgs {
  const int* reqs;
  int b;
  const unsigned char* health;
  int* free_mb;
  int* conc;
  long long sa, sn;
  int n, a;
  const int* penalty;
  int* chosen;
  int* forced;
};

// the request's window [offset, offset + size) inside [0, n)
__device__ __forceinline__ void window_of(int off, int size, int n, int& lo,
                                          int& hi) {
  const long long l = min(max((long long)off, 0ll), (long long)n);
  lo = (int)l;
  hi = (int)min(max((long long)off + size, l), (long long)n);
}

__device__ __forceinline__ int clamp_slot(int slot, int a) {
  return min(max(slot, 0), a - 1);
}

// x mod m for x < 2^64, with inv = floor((2^64 - 1) / m): the quotient
// estimate is low by at most one
__device__ __forceinline__ int barrett_mod(uint64_t x, int m, uint64_t inv) {
  uint64_t r = x - __umul64hi(x, inv) * (uint64_t)m;
  return (int)(r >= (uint64_t)m ? r - m : r);
}

// conc[slot_j, c] of staged request row lj for each owned column c that
// request j can use (in its window and healthy); other values are left
// as they are and never read for j
template <int K, int ROWS>
__device__ __forceinline__ void fetch(int (&dst)[K], int (*rq)[ROWS],
                                      int lj, const ScanArgs& p, int g,
                                      int nthreads, unsigned hmask) {
  if (!rq[R_VALID][lj]) return;
  int lo, hi;
  window_of(rq[R_OFFSET][lj], rq[R_SIZE][lj], p.n, lo, hi);
  const int* crow =
      p.conc + (long long)clamp_slot(rq[R_SLOT][lj], p.a) * p.sa;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = g + k * nthreads;
    if (c >= lo && c < hi && ((hmask >> k) & 1u))
      dst[k] = load_book(crow + (long long)c * p.sn);
  }
}

template <int K, int D>
__global__ void __launch_bounds__(SCAN_THREADS, 1)
placement_scan_kernel(const ScanArgs p) {
  constexpr int ROWS = SCAN_CHUNK + D;
  __shared__ int rq[R_ROWS][ROWS];
  __shared__ uint64_t rinv[ROWS];  // floor((2^64 - 1) / m) of each row
  __shared__ ExchangeSmem xs;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int nblocks = (int)cluster.num_blocks();
  const int nthreads = nblocks * SCAN_THREADS;
  const int rank = (int)cluster.block_rank();
  const int g = rank * SCAN_THREADS + tid;
  const int n = p.n, a = p.a, b = p.b;
  // the penalized rank can exceed n + 2 (one probe-ring lap per level)
  const int big = p.penalty ? (1 << 30) : n + 2;

  // the owned columns' books, for the whole launch
  int fr[K], pen[K], buf[D][K];
  unsigned hmask = 0, dirty = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = g + k * nthreads;
    fr[k] = pen[k] = 0;
    if (c < n) {
      fr[k] = p.free_mb[c];
      if (p.penalty) pen[k] = p.penalty[c];
      if (p.health[c]) hmask |= 1u << k;
    }
#pragma unroll
    for (int d = 0; d < D; ++d) buf[d][k] = 0;
  }
  exchange_init(xs);
  // every block runs, its mbarriers set, before any block writes to it
  cluster.sync();

  int probes = 0;  // cluster exchanges so far
  for (int base = 0; base < b; base += SCAN_CHUNK) {
    if (base) __syncthreads();  // every warp is done with the last chunk
    const int rows = min(b - base, ROWS);
    for (int t = tid; t < R_ROWS * rows; t += SCAN_THREADS) {
      const int r = t / rows, j = t - r * rows;
      rq[r][j] = p.reqs[(long long)r * b + base + j];
    }
    for (int j = tid; j < rows; j += SCAN_THREADS) {
      const int size = p.reqs[(long long)R_SIZE * b + base + j];
      rinv[j] = ~0ull / (uint64_t)max(size, 1);
    }
    __syncthreads();
    if (base == 0) {
#pragma unroll
      for (int d = 0; d < D; ++d)
        if (d < b) fetch<K, ROWS>(buf[d], rq, d, p, g, nthreads, hmask);
    }
    const int end = min(b, base + SCAN_CHUNK);
    // request i holds ring entry i % D == d: base is a multiple of D
    for (int i0 = base; i0 < end; i0 += D) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int i = i0 + d;
        if (i >= end) break;
        const int li = i - base;
        const int off = rq[R_OFFSET][li];
        const int size = rq[R_SIZE][li];
        const int need = rq[R_NEED][li];
        const int slot_raw = rq[R_SLOT][li];
        const bool valid = rq[R_VALID][li] != 0;
        // an out-of-range slot reads the clamped row, and its write is
        // dropped
        const bool slot_ok = slot_raw >= 0 && slot_raw < a;
        const int slot = clamp_slot(slot_raw, a);
        int lo, hi;
        window_of(off, size, n, lo, hi);
        bool found = false, have_usable = false;
        int sel = 0;
        if (valid && lo < hi) {  // the same branch in every thread
          const int home = rq[R_HOME][li];
          const int step_inv = rq[R_STEP_INV][li];
          const int rnd = rq[R_RAND][li];
          const int m = max(size, 1);
          // inside the _mulmod contract: every key without a division
          const bool fast =
              m <= SCAN_MAX_N && (unsigned)home < (unsigned)m &&
              (unsigned)rnd < (unsigned)m && (unsigned)step_inv < (unsigned)m;
          const uint64_t inv = rinv[li];
          uint64_t best = ~0ull, fbest = ~0ull;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int c = g + k * nthreads;
            if (c >= lo && c < hi && ((hmask >> k) & 1u)) {
              const int local = c - off;  // in [0, m)
              int fkey, key;
              if (fast) {
                fkey = local - rnd;
                fkey += fkey < 0 ? m : 0;
              } else {
                fkey = floormod(local - rnd, m);
              }
              const uint64_t f = pack_key(fkey, c);
              fbest = f < fbest ? f : fbest;
              if (buf[d][k] > 0 || fr[k] >= need) {
                if (fast) {
                  int a0 = local - home;
                  a0 += a0 < 0 ? m : 0;
                  key = barrett_mod((uint64_t)a0 * (unsigned)step_inv, m,
                                    inv);
                } else {
                  key = mulmod(local - home, step_inv, m);
                }
                if (p.penalty) key = wadd(key, wmul(pen[k], m));
                const uint64_t e = pack_key(key, c);
                best = e < best ? e : best;
              }
            }
          }
          cluster_min(xs, best, fbest, probes, rank, nblocks);
          ++probes;
          found = key_of(best) < big;
          have_usable = key_of(fbest) < big;
          sel = found ? idx_of(best) : idx_of(fbest);
        }
        const bool placed = found || have_usable;  // valid: probed
        if (placed) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            if (g + k * nthreads == sel) {  // the owner of sel
              const int cell = buf[d][k];
              const bool use_conc = cell > 0;
              if (!use_conc) {
                fr[k] = wsub(fr[k], need);
                dirty |= 1u << k;
              }
              const int maxc = rq[R_MAX_CONC][li];
              const int delta = use_conc ? -1 : (maxc > 1 ? maxc - 1 : 0);
              if (slot_ok && delta != 0) {
                p.conc[(long long)slot * p.sa + (long long)sel * p.sn] =
                    wadd(cell, delta);
                // the later requests already fetched: the store's patch
#pragma unroll
                for (int e = 1; e < D; ++e) {
                  if (i + e < b && clamp_slot(rq[R_SLOT][li + e], a) == slot)
                    buf[(d + e) % D][k] = wadd(buf[(d + e) % D][k], delta);
                }
              }
            }
          }
        }
        if (g == 0) {
          p.chosen[i] = placed ? sel : -1;
          p.forced[i] = (!found && have_usable) ? 1 : 0;
        }
        // after the commit: this load sees the owner's own store
        if (i + D < b)
          fetch<K, ROWS>(buf[d], rq, li + D, p, g, nthreads, hmask);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    if ((dirty >> k) & 1u) p.free_mb[g + k * nthreads] = fr[k];
  // no block exits while another may still write its shared memory
  cluster.sync();
}

// per device, per log2 K and per cluster size (8, 16): 0 not asked yet,
// 1 the card places the cluster, -1 it cannot
static int g_fit[MAX_DEVICES][5][2];

template <int K>
static cudaError_t launch_k(const ScanArgs& p, int dev, int c,
                            cudaStream_t stream, bool* launched) {
  constexpr int D = scan_depth(K);
  constexpr int LOG_K = K == 1 ? 0 : K == 2 ? 1 : K == 4 ? 2 : K == 8 ? 3 : 4;
  void (*kernel)(ScanArgs) = placement_scan_kernel<K, D>;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c);
  cfg.blockDim = dim3(SCAN_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int& fit = g_fit[dev][LOG_K][c > 8];
  if (!fit) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) cudaGetLastError();  // a refusal, not a fault
    fit = (err == cudaSuccess && clusters >= 1) ? 1 : -1;
  }
  *launched = fit > 0;
  if (!*launched) return cudaSuccess;
  return cudaLaunchKernelEx(&cfg, kernel, p);
}

static cudaError_t launch(const ScanArgs& p, int dev, int c, int k,
                          cudaStream_t stream, bool* launched) {
  switch (k) {
    case 1: return launch_k<1>(p, dev, c, stream, launched);
    case 2: return launch_k<2>(p, dev, c, stream, launched);
    case 4: return launch_k<4>(p, dev, c, stream, launched);
    case 8: return launch_k<8>(p, dev, c, stream, launched);
    case 16: return launch_k<16>(p, dev, c, stream, launched);
  }
  *launched = false;
  return cudaSuccess;
}

// Launches the scan on one cluster (16 blocks, else 8) and writes its
// shape to shape[0..2]: blocks, columns a thread (K), prefetch depth (D).
extern "C" int placement_scan_launch(const int* reqs, int b,
                                     const unsigned char* health,
                                     int* free_mb, int* conc, long long sa,
                                     long long sn, int n, int a,
                                     const int* penalty, int* chosen,
                                     int* forced, void* stream, int* shape) {
  if (b < 1 || n < 1 || n > SCAN_MAX_N || a < 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  const ScanArgs p = {reqs, b, health, free_mb, conc, sa, sn,
                      n,    a, penalty, chosen, forced};
  for (int c = 16; c >= 8; c /= 2) {
    int k = 1;
    while (k * c * SCAN_THREADS < n) k *= 2;
    bool launched = false;
    err = launch(p, dev, c, k, (cudaStream_t)stream, &launched);
    if (err != cudaSuccess) return (int)err;
    if (launched) {
      shape[0] = c;
      shape[1] = k;
      shape[2] = scan_depth(k);
      return 0;
    }
  }
  return (int)cudaErrorLaunchOutOfResources;
}
