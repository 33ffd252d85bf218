// Hamming<=1 barcode neighbour search, kernels K4 and K5, for Hopper (sm_90a).
//
// K4 replaces the MXU kernel of alevin_fry_tpu/ops/pallas_hamming.py
// (_build_mxu_kernel, :145, reached through find_neighbors_mxu :242).  For
// every query barcode it counts the kept barcodes within Hamming distance 1
// over the 2-bit base code, and returns the smallest kept index among them
// (INT_MAX when there is none).  The kept table arrives sorted, so the
// smallest index is the smallest neighbour: the rescue contract.
//
// The TPU computed the distance field as a one-hot (Q x 4L) @ (4L x K) bf16
// contraction because the MXU was its only fast unit.  On Hopper a pair costs
// a few integer instructions: x = q ^ k folds to one bit per base with
// (x | x >> 1) & 0x5555..., and the pair is a neighbour when that word has at
// most one bit set (__popcll <= 1).  Shifts are on unsigned 64-bit words, so
// 32-base barcodes that use bit 63 need no masking.
//
// Layout: a block of 256 threads owns 1024 queries, four per thread in
// registers.  The whole kept table streams through shared memory in tiles of
// 4096 codes (32 KB), which every thread reads as a broadcast.  Each query
// keeps a running minimum of a key over its neighbours: the kept index (K4)
// or the kept code (K5), the select policy of the one kernel template.
// The loop stops at nk: there is no kept padding that could alias a real
// barcode, and no atomics.
//
// Bound: the integer pipes, at about ten 32-bit operations per pair
// (Q x K pairs; no device-memory traffic beyond one pass over the queries
// and one pass over the kept table per block).  An int8 one-hot mma version
// is a later comparison.
//
// K5 replaces the brute-force VPU kernel of the same file (_build_kernel, :39,
// reached through find_neighbors_pallas :371): the same fold and popcount, but
// it returns the smallest neighbour by unsigned VALUE, so the kept table need
// not be sorted, and it takes no length: it works on whole 64-bit words.  The
// TPU kernel split each word into lo / hi u32 halves and tracked the minimum in
// bias-transformed int32 because Mosaic had no 64-bit or unsigned reductions;
// here the words and the running minimum are plain unsigned 64-bit registers.
// The TPU kernel padded the kept table to a multiple of 1024 with the all-C
// 32-base code, which is itself a barcode within distance 1 of the all-C
// 31-base one; this loop stops at nk and reads no padding.  It is the K4
// kernel instantiated with the MinValue policy: same layout, same bound.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kQueriesPerBlock = kThreads * kPerThread;
constexpr int kKeptTile = 4096;

// What a kernel keeps of a query's neighbours besides their count: the
// smallest key(j, k) over every neighbour k at kept index j.
struct FirstIndex {  // K4: the smallest kept index
  using T = int;
  __device__ static T none() { return INT_MAX; }
  __device__ static T key(long long j, unsigned long long) { return (int)j; }
};
struct MinValue {  // K5: the smallest kept code by unsigned value
  using T = unsigned long long;
  __device__ static T none() { return ~0ull; }
  __device__ static T key(long long, unsigned long long k) { return k; }
};

template <class Sel>
__global__ void __launch_bounds__(kThreads)
hamming1_kernel(const unsigned long long* __restrict__ q, long long nq,
                const unsigned long long* __restrict__ kept, long long nk,
                int* __restrict__ cnt, typename Sel::T* __restrict__ best_out) {
  using T = typename Sel::T;
  __shared__ unsigned long long tile[kKeptTile];
  const long long qbase = (long long)blockIdx.x * kQueriesPerBlock + threadIdx.x;
  unsigned long long qv[kPerThread];
  int c[kPerThread];
  T best[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const long long qi = qbase + (long long)i * kThreads;
    qv[i] = qi < nq ? q[qi] : 0ull;
    c[i] = 0;
    best[i] = Sel::none();
  }
  for (long long t0 = 0; t0 < nk; t0 += kKeptTile) {
    const int tn = (int)(nk - t0 < kKeptTile ? nk - t0 : kKeptTile);
    __syncthreads();
    for (int j = threadIdx.x; j < tn; j += kThreads) tile[j] = kept[t0 + j];
    __syncthreads();
    for (int j = 0; j < tn; ++j) {
      const unsigned long long k = tile[j];
      const T key = Sel::key(t0 + j, k);
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const unsigned long long x = qv[i] ^ k;
        const unsigned long long t = (x | (x >> 1)) & 0x5555555555555555ull;
        if (__popcll(t) <= 1) {
          ++c[i];
          best[i] = key < best[i] ? key : best[i];
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const long long qi = qbase + (long long)i * kThreads;
    if (qi < nq) {
      cnt[qi] = c[i];
      best_out[qi] = best[i];
    }
  }
}

}  // namespace

extern "C" {

// cnt[i] = number of kept codes within Hamming distance 1 of q[i];
// idx[i] = smallest such kept index, INT_MAX when cnt[i] == 0.
int aft_hamming1(const void* q, long long nq, const void* kept, long long nk,
                 void* cnt, void* idx, void* stream) {
  if (nq <= 0) return 0;
  const long long blocks = (nq + kQueriesPerBlock - 1) / kQueriesPerBlock;
  hamming1_kernel<FirstIndex><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)q, nq, (const unsigned long long*)kept, nk,
      (int*)cnt, (int*)idx);
  return (int)cudaGetLastError();
}

// K5: cnt[i] as above; rep[i] = smallest such kept code by unsigned value,
// all ones when cnt[i] == 0.  The kept table may be in any order.
int aft_hamming1_min(const void* q, long long nq, const void* kept, long long nk,
                     void* cnt, void* rep, void* stream) {
  if (nq <= 0) return 0;
  const long long blocks = (nq + kQueriesPerBlock - 1) / kQueriesPerBlock;
  hamming1_kernel<MinValue><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)q, nq, (const unsigned long long*)kept, nk,
      (int*)cnt, (unsigned long long*)rep);
  return (int)cudaGetLastError();
}

}  // extern "C"
