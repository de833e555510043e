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
// that has to stay serial is the rows that share one concurrency cell.
//
// What the design does about it. One block, one thread a row, the rows
// staged in shared memory RELEASE_THREADS at a time (chunks in order).
// Memory returns are integer atomics on free[inv]: they commute, so their
// order does not change the sum. Concurrency rows group by their cell: the
// first row of a cell in the chunk (its leader) walks the later rows of
// the chunk, applies those of its cell in batch order in a register, and
// writes the cell once. No other thread touches that cell in the chunk,
// so the fold has no race and no cross-block step; the barrier between
// chunks orders a cell's writes across them.
#include <cuda_runtime.h>

namespace {

constexpr int RELEASE_THREADS = 1024;

__global__ void __launch_bounds__(RELEASE_THREADS)
release_fold_kernel(const int* __restrict__ inv, const int* __restrict__ slot,
                    const int* __restrict__ need,
                    const int* __restrict__ max_conc,
                    const unsigned char* __restrict__ valid, int r,
                    int* free_mb, int* conc, long long sn, long long sa,
                    int n, int a) {
  __shared__ int s_inv[RELEASE_THREADS];
  __shared__ int s_slot[RELEASE_THREADS];
  __shared__ int s_need[RELEASE_THREADS];
  __shared__ int s_maxc[RELEASE_THREADS];
  // 0: nothing to do, 1: a memory row, 2: a concurrency row
  __shared__ unsigned char s_kind[RELEASE_THREADS];
  const int t = threadIdx.x;
  for (int base = 0; base < r; base += RELEASE_THREADS) {
    const int rows = min(RELEASE_THREADS, r - base);
    if (t < rows) {
      const int i = base + t;
      const int iv = inv[i], sl = slot[i], mc = max_conc[i];
      unsigned char kind = 0;
      if (valid[i] && iv >= 0 && iv < n) {
        if (mc <= 1)
          kind = 1;
        else if (sl >= 0 && sl < a)
          kind = 2;
      }
      s_inv[t] = iv;
      s_slot[t] = sl;
      s_need[t] = need[i];
      s_maxc[t] = mc;
      s_kind[t] = kind;
    }
    __syncthreads();
    if (t < rows && s_kind[t] == 1) {
      atomicAdd(free_mb + s_inv[t], s_need[t]);
    } else if (t < rows && s_kind[t] == 2) {
      const int iv = s_inv[t], sl = s_slot[t];
      bool leader = true;
      for (int j = 0; j < t && leader; ++j)
        leader = !(s_kind[j] == 2 && s_inv[j] == iv && s_slot[j] == sl);
      if (leader) {
        int* cell = conc + iv * sn + sl * sa;
        int c = *cell;
        int back = 0;
        for (int j = t; j < rows; ++j) {
          if (s_kind[j] != 2 || s_inv[j] != iv || s_slot[j] != sl) continue;
          c += 1;
          if (c >= s_maxc[j]) {
            c -= s_maxc[j];
            back += s_need[j];
          }
        }
        *cell = c;
        if (back) atomicAdd(free_mb + iv, back);
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Launch the fold on `stream`: rows int32[R] (valid as bytes), the books'
// free int32[N] and conc int32 cells at conc + inv * sn + slot * sa.
// Returns a cudaError_t as int (0 when the launch was taken).
extern "C" int release_fold_launch(const int* inv, const int* slot,
                                   const int* need, const int* max_conc,
                                   const unsigned char* valid, int r,
                                   int* free_mb, int* conc, long long sn,
                                   long long sa, int n, int a, void* stream) {
  if (r < 0 || n < 1 || a < 1) return (int)cudaErrorInvalidValue;
  if (r == 0) return 0;
  const int threads = r < RELEASE_THREADS ? ((r + 31) / 32) * 32
                                          : RELEASE_THREADS;
  release_fold_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      inv, slot, need, max_conc, valid, r, free_mb, conc, sn, sa, n, a);
  return (int)cudaGetLastError();
}
