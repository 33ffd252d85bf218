// Hamming<=1 barcode neighbour search, kernels K4 and K5, for Hopper (sm_90a).
//
// Both kernels replace the TPU's O(Q x K) searches of
// alevin_fry_tpu/ops/pallas_hamming.py: K4 the MXU kernel (_build_mxu_kernel,
// :145, reached through find_neighbors_mxu :242), K5 the brute-force VPU
// kernel (_build_kernel, :39, reached through find_neighbors_pallas :371).
// For every query barcode they count the kept barcodes within Hamming
// distance 1 over the 2-bit base code (distance 0 included, each copy of a
// duplicated kept code counted) and keep the smallest of them: K4 its index
// in the kept table, which arrives sorted (INT_MAX when there is none); K5
// its code by unsigned value (all ones when there is none).
//
// The TPU tested every query against every kept code because it has no fast
// gather: a one-hot (Q x 4L) @ (4L x K) contraction on the MXU, or XOR,
// 2-bit fold and popcount on the VPU.  Hopper reads shared memory and its
// 50 MB L2 at random cheaply, so this kernel does what the reference's host
// search does: it probes only the 3P + 1 words within distance 1 of each
// query (the query itself and q ^ (v << 2p) for v = 1..3 at each of P
// positions, all distinct) in the kept table sorted in unsigned order, and
// adds the length of each word's equal range.  At the RNA path's input
// (Q = 477,113, K = 55,471, L = 16) that is 23.4M probes of about 16 search
// steps against 2.65e10 pair tests; the brute-force loop it replaces took
// 25.90 ms there and 40.17 ms at the ATAC path's (Q = 648,588, K = 59,982)
// on an H100 at 700 W.  K4 passes P = the barcode length; K5's wrapper
// passes the number of 2-bit positions any query or kept code uses, which
// is exact for its whole-word contract: above P every code holds base 0.
//
// Layout.  Each block stages a sample of the sorted table in dynamic shared
// memory: every S-th code, S the smallest power of two whose sample fits
// kSampleCap codes (the whole table when it fits), padded with all-ones
// words to 2^levels - 1 entries so the bisection takes the same `levels`
// steps in every thread.  A search bisects the sample, then finishes the
// last log2(S) steps in the device-memory table, which at these sizes stays
// in L2 (0.44 MB RNA, 0.48 MB ATAC, 8.8 MB at 1.1M codes).  The search is
// bound by latency, so each thread owns one query and, after the word
// itself, searches the three substitutions of each position in lockstep:
// three independent searches in flight per thread.  Blocks are persistent
// (as many as fit on the card, striding over the queries), so the sample
// is staged once per block.  A thread writes its query's two outputs and
// nothing else: no atomics, no initialised outputs.  The rescue passes its
// queries sorted, so the 32 queries of a warp share their leading bases and
// their searches take nearly the same path through the sample and the
// table; shuffled queries run about 3-4x slower.  (One thread per (query,
// position), merging hits with atomics, was less sensitive to the order
// but 1.4-1.8x slower on sorted queries; H100, chip_smoke.py phase 2.)
//
// Bound: device memory, one read of the queries and the kept table and one
// write of the outputs: 16 Q + 8 K bytes for K4, 20 Q + 8 K for K5, a few
// microseconds at 3.35 TB/s.  The probes' integer work is far below that of
// the Q x K loop, and their table reads hit shared memory and L2.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 512;
constexpr int kMinBlocks = 3;                        // resident blocks per SM
constexpr int kSampleCap = (1 << 13) - 1;            // sample codes in shared memory
constexpr size_t kSampleBytes = kSampleCap * sizeof(u64);  // 65,528 B

// What a kernel keeps of a query's neighbours besides their count: the
// smallest key over every kept code equal to a probe word w, whose first
// copy sits at index lo of the sorted table.
struct FirstIndex {  // K4: the smallest kept index
  using T = int;
  __device__ static T none() { return INT_MAX; }
  __device__ static T key(int lo, u64) { return lo; }
};
struct MinValue {  // K5: the smallest kept code by unsigned value
  using T = unsigned long long;
  __device__ static T none() { return ~0ull; }
  __device__ static T key(int, u64 w) { return w; }
};

// How a table of nk codes is split between shared memory and L2.
struct Plan {
  int shift;       // log2 S: the sample holds every S-th code
  int levels;      // the padded sample has 2^levels - 1 entries
  long long ns;    // sample codes taken from the table
};

Plan plan_for(long long nk) {
  Plan p{0, 0, 0};
  while (((nk + (1LL << p.shift) - 1) >> p.shift) > kSampleCap) ++p.shift;
  p.ns = (nk + (1LL << p.shift) - 1) >> p.shift;
  while ((1LL << p.levels) - 1 < p.ns) ++p.levels;
  return p;
}

// The end of the run of copies of w that starts at kept[lo]: galloping,
// then bisection, so a unique code costs one read.
__device__ long long equal_end(const u64* __restrict__ kept, long long nk, long long lo,
                               u64 w) {
  long long a = lo + 1, step = 1, b;
  for (;;) {
    b = a + step - 1;
    if (b >= nk || kept[b] != w) break;
    a = b + 1;
    step <<= 1;
  }
  long long n = (b < nk ? b : nk) - a;  // kept[a - 1] == w; the end lies in [a, a + n]
  while (n > 0) {
    const long long h = n >> 1;
    if (kept[a + h] == w) {
      a += h + 1;
      n -= h + 1;
    } else {
      n = h;
    }
  }
  return a;
}

// Lower bounds of N words in lockstep: bisect the shared sample (the same
// `levels` steps in every thread), then the window of at most S - 1 codes
// between two samples in device memory.  geq tracks the code at the
// current upper end (all ones past the table), so a word is in the table
// when lo < nk and geq == w, with no further read.
template <int N>
__device__ __forceinline__ void lower_bounds(const u64* sample, Plan plan,
                                             const u64* __restrict__ kept, long long nk,
                                             const u64 (&w)[N], int (&lo)[N], u64 (&geq)[N]) {
  int n[N];
#pragma unroll
  for (int v = 0; v < N; ++v) {
    lo[v] = 0;
    geq[v] = ~0ull;
  }
  for (int h = ((1 << plan.levels) - 1) >> 1, lvl = 0; lvl < plan.levels; ++lvl, h >>= 1) {
#pragma unroll
    for (int v = 0; v < N; ++v) {
      const u64 s = sample[lo[v] + h];
      const bool lt = s < w[v];
      lo[v] = lt ? lo[v] + h + 1 : lo[v];
      geq[v] = lt ? geq[v] : s;
    }
  }
#pragma unroll
  for (int v = 0; v < N; ++v) {  // lo[v] is now the count of samples below w[v]
    const long long j = lo[v];
    const long long end = (j << plan.shift) < nk ? (j << plan.shift) : nk;
    lo[v] = j ? (int)(((j - 1) << plan.shift) + 1) : 0;
    n[v] = j ? (int)(end - lo[v]) : 0;
  }
  for (int s = 0; s < plan.shift; ++s) {
#pragma unroll
    for (int v = 0; v < N; ++v) {
      if (n[v] > 0) {
        const int h = n[v] >> 1;
        const u64 x = kept[lo[v] + h];
        const bool lt = x < w[v];
        lo[v] = lt ? lo[v] + h + 1 : lo[v];
        geq[v] = lt ? geq[v] : x;
        n[v] = lt ? n[v] - h - 1 : h;
      }
    }
  }
}

// Search N probe words and add their hits to a query's count and key.
template <class Sel, int N>
__device__ __forceinline__ void probe(const u64* sample, Plan plan, const u64* __restrict__ kept,
                                      long long nk, const u64 (&w)[N], int& cnt,
                                      typename Sel::T& best) {
  int lo[N];
  u64 geq[N];
  lower_bounds<N>(sample, plan, kept, nk, w, lo, geq);
#pragma unroll
  for (int v = 0; v < N; ++v) {
    if (lo[v] < nk && geq[v] == w[v]) {
      cnt += (int)(equal_end(kept, nk, lo[v], w[v]) - lo[v]);
      const typename Sel::T k = Sel::key(lo[v], w[v]);
      best = k < best ? k : best;
    }
  }
}

template <class Sel>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
hamming1_probe_kernel(const u64* __restrict__ q, long long nq, const u64* __restrict__ kept,
                      long long nk, int positions, Plan plan, int* __restrict__ cnt,
                      typename Sel::T* __restrict__ best) {
  extern __shared__ u64 sample[];
  const int npad = (1 << plan.levels) - 1;
  for (int i = threadIdx.x; i < npad; i += blockDim.x)
    sample[i] = i < plan.ns ? kept[(long long)i << plan.shift] : ~0ull;
  __syncthreads();

  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < nq;
       i += (long long)gridDim.x * kThreads) {
    const u64 x = q[i];
    int c = 0;
    typename Sel::T b = Sel::none();
    const u64 self[1] = {x};
    probe<Sel, 1>(sample, plan, kept, nk, self, c, b);
    for (int p = 0; p < positions; ++p) {
      const u64 w[3] = {x ^ (1ull << (2 * p)), x ^ (2ull << (2 * p)), x ^ (3ull << (2 * p))};
      probe<Sel, 3>(sample, plan, kept, nk, w, c, b);
    }
    cnt[i] = c;
    best[i] = b;
  }
}

// The dynamic shared memory a block stages for `plan` and how many such
// blocks an SM holds, after allowing the kernel above 48 KB.
template <class Sel>
cudaError_t residency(const Plan& plan, size_t* smem, int* per_sm) {
  auto kern = hamming1_probe_kernel<Sel>;
  *smem = (((size_t)1 << plan.levels) - 1) * sizeof(u64);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSampleBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, kThreads, *smem);
  return err;
}

template <class Sel>
int launch(const void* q, long long nq, const void* kept, long long nk, int positions,
           void* cnt, void* best, void* stream) {
  if (nq <= 0 || nk <= 0) return 0;
  if (positions < 0 || positions > 32 || nk >= INT_MAX) return (int)cudaErrorInvalidValue;
  const Plan plan = plan_for(nk);
  size_t smem = 0;
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err;
  if ((err = residency<Sel>(plan, &smem, &per_sm)) != cudaSuccess ||
      (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long need = (nq + kThreads - 1) / kThreads;
  hamming1_probe_kernel<Sel><<<(unsigned)(need < resident ? need : resident), kThreads, smem,
                               (cudaStream_t)stream>>>(
      (const u64*)q, nq, (const u64*)kept, nk, positions, plan, (int*)cnt,
      (typename Sel::T*)best);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K4: kept in ascending unsigned order, probes over `positions` bases.
// cnt[i] = number of kept codes within Hamming distance 1 of q[i];
// idx[i] = smallest such kept index, INT_MAX when cnt[i] == 0.
int aft_hamming1(const void* q, long long nq, const void* kept, long long nk, int positions,
                 void* cnt, void* idx, void* stream) {
  return launch<FirstIndex>(q, nq, kept, nk, positions, cnt, idx, stream);
}

// K5: as K4, but rep[i] = smallest such kept code by unsigned value, all
// ones when cnt[i] == 0.
int aft_hamming1_min(const void* q, long long nq, const void* kept, long long nk,
                     int positions, void* cnt, void* rep, void* stream) {
  return launch<MinValue>(q, nq, kept, nk, positions, cnt, rep, stream);
}

// How a table of nk codes is searched: out[0] = S (every S-th code in the
// shared sample), out[1] = dynamic shared memory bytes a block stages,
// out[2] = resident blocks per SM at that size (K4's kernel).
int aft_hamming1_plan(long long nk, long long* out) {
  const Plan plan = plan_for(nk);
  size_t smem = 0;
  int per_sm = 0;
  const cudaError_t err = residency<FirstIndex>(plan, &smem, &per_sm);
  out[0] = 1LL << plan.shift;
  out[1] = (long long)smem;
  out[2] = per_sm;
  return (int)err;
}

}  // extern "C"
