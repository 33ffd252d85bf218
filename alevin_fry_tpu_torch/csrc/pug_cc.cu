// K7: connected components of the per-cell UMI graphs (PUGs) for Hopper
// (sm_90a).
//
// Replaces the JAX package's device programs for the same function, XLA
// and not Pallas: alevin_fry_tpu/ops/pug_device.py::connected_components_batched
// (:122, gather label propagation :165-202) and _dense_cc_run (:72, boolean
// matrix squaring on the MXU).  The TPU squared a dense N x N matrix
// because its gathers were slow; on Hopper gathers from shared memory are
// cheap, so this kernel works on the graph's CSR directly: no padding to a
// (B, N, D) ladder, no N^2 matrix, and no cell left to the host.
//
// What it computes: for every node v of every cell, the smallest
// cell-local node index of v's weakly connected component, given each
// cell's symmetrized adjacency (csrc/radc.cpp::radc_pug_graph_export: a
// degree per node and the cell-local neighbours, node by node, every edge
// both ways).  That is what the reference's union-find defines
// (pugutils.rs:278-301) and what radc_pug_cover takes.
//
// What bounds it: the bytes.  Each node's degree (8 bytes) is read once
// and its label (4 bytes) written once, each adjacency entry (4 bytes)
// read once.  Most nodes of a UMI graph have no edge (at least 86% on a
// 20M-read run, PERF.md), and such a node is a component of its own.  So
// a cell's work runs in three steps, and only the first touches all its
// nodes:
//   1. One streaming pass over the cell's degrees, in steps of four
//      coalesced int64 loads a thread, the next step's in flight while
//      this one's are scanned.  A node without an edge gets its label
//      (itself) at once.  The edged nodes are listed in ascending order
//      (ballot and prefix sums: the compact index, or rank), each with its
//      first entry as an int32 cell-local offset.
//   2. Each neighbour is mapped to its rank (a neighbour of an edged node
//      has an edge: the adjacency is symmetric): through a node-to-rank
//      map (4n bytes, written in step 1) in shared memory where it fits
//      after the layout, else by a binary search of the sorted list where
//      that list is in shared memory (routes w, a), else through the map
//      in global scratch (routes b, c: a search there costs a dependent
//      load from L2 per step, 2.4 ms on a 68,112-node cell, PERF.md).
//   3. A union-find over the ranks (as in ECL-CC, arXiv 1712.09789): every
//      entry (r, x) with x < r joins the trees of r and x, then each edged
//      node takes its root.  The ranks keep the nodes' order, so the
//      smallest rank of a component is its smallest node, and the label of
//      rank r is the node of its root.
// So no step after the first costs anything for a node without an edge,
// and no round repeats a pass: every live cell reports one round.
//
// Why the roots are the components' smallest ranks, whatever the order the
// threads run in: a parent is never larger than its child (par[x] <= x).
// par starts as the identity; a link (atomicCAS) writes a smaller index
// into a node that is still a root (par[x] == x), so it only ever joins two
// trees, under the smaller of the two indices it saw; path halving writes
// into a node that is no longer a root one of its ancestors, and a node that
// stopped being a root never becomes one again, so those stores race only
// with each other, and each leaves x in its tree.  So each tree's root is its
// smallest member.  A union returns only once its two ends share a root (a
// failed swap means another thread changed that root's parent: the loop
// climbs from the new parent, and indices only decrease, so it ends).
// After every union has returned, each component is one tree, whose root is
// its smallest rank.  Reads of par are volatile, so none is served from a
// stale register.
//
// Four routes, chosen per cell on the host (ops/pug_device.py::launch_plan)
// from its node count n and entry count m, laid out for min(n, m) edged
// nodes (at most that many: each has an entry):
//   (w) warp: a cell of at most 256 entries and 2,048 nodes (the bulk) runs
//       on one warp, eight cells a block, each in its own slice of dynamic
//       shared memory; its neighbours are loaded into registers before the
//       degree pass, so their latency overlaps it; no block barrier.
//   (a) staged: the compact layout (ranks' nodes, offsets, parents and the
//       neighbours) in dynamic shared memory; the neighbours come by a
//       Hopper bulk copy (cp.async.bulk, completion on an mbarrier) of the
//       16-byte aligned middle of the cell's slice, issued before the degree
//       pass and mapped to ranks in place.
//   (b) shared: the parents (and the map, where the host found room for
//       it) in shared memory, the rest in the cell's slice of a global
//       scratch buffer.
//   (c) global: everything in the scratch.
// A block route's kernel traps if its layout overruns the dynamic shared
// bytes it was launched with, and any kernel traps if a cell's degrees do
// not sum to its entry count.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;             // cells (warps) of a route (w) block
constexpr int kWarpEntries = 256;     // most entries of a route (w) cell
constexpr int kWarpRegs = kWarpEntries / 32;
constexpr int kItems = 4;             // degrees a thread loads a step of the pass
constexpr int kMaxThreads = 512;
constexpr int kScan = kItems * kMaxThreads / 32;  // (item, warp) totals of a step
// a block route's header: mbarrier (8 B), running counts (8 B), the
// step's totals and their prefixes (edged nodes and entries each)
constexpr int kHeader = 16 + 4 * 4 * kScan;

enum Route { kWarp = 0, kStaged = 1, kShared = 2, kGlobal = 3 };

struct CcArgs {
  const long long* deg;          // (N) degree of each node
  const int* nbr;                // (A) cell-local neighbours, node by node
  const long long* node_off;     // (C+1) first node of each cell
  const long long* entry_off;    // (C+1) first adjacency entry of each cell
  const long long* scratch_off;  // (C) first scratch word of a route (b) or (c) cell
  const int* cells;              // the cells of this launch
  int n_cells;
  long long slot_bytes;          // route (w): shared bytes of a warp
  int* scratch;
  int* labels_out;               // (N) cell-local component label
  int* rounds_out;               // (C) rounds run
};

__device__ __forceinline__ long long r16(long long b) { return (b + 15) & ~15LL; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The root of x's tree, moving each member passed to its grandparent
// (path halving; see the header for why the stores are safe).
__device__ __forceinline__ int find_root(volatile int* par, int x) {
  int cur = par[x];
  if (cur != x) {
    int prev = x, next;
    while (cur > (next = par[cur])) {
      par[prev] = next;
      prev = cur;
      cur = next;
    }
  }
  return cur;
}

// Joins the trees of a and b: the larger root goes under the smaller one.
__device__ __forceinline__ void unite(volatile int* par, int a, int b) {
  int hi = find_root(par, a), lo = find_root(par, b);
  while (hi != lo) {
    if (hi < lo) {
      const int t = hi;
      hi = lo;
      lo = t;
    }
    const int seen = atomicCAS(const_cast<int*>(par) + hi, hi, lo);
    if (seen == hi) break;
    hi = seen;  // hi gained a parent meanwhile: go on from it
  }
}

// The rank of edged node v in the ascending list act[0, k).
__device__ __forceinline__ int rank_in(const int* act, int k, int v) {
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (act[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int warp_inclusive_sum(int x, int lane) {
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int t = __shfl_up_sync(kFull, x, s);
    if (lane >= s) x += t;
  }
  return x;
}

// One contiguous slice of n words staged at `region` (r16(4n) + 16 bytes,
// 16-byte aligned): the staged array s sits at the source's offset within
// 16 bytes, so words [i0, i1) go by one bulk copy between 16-byte aligned
// addresses and the up to three words at each end by plain loads.
struct Slice {
  const unsigned* g;
  unsigned* s;
  int n, i0, i1;
  __device__ Slice(unsigned char* region, const void* src, int n_) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(src);
    g = static_cast<const unsigned*>(src);
    s = reinterpret_cast<unsigned*>(region + (a & 15));
    n = n_;
    i0 = min(n, static_cast<int>(((16 - (a & 15)) & 15) >> 2));
    i1 = max(i0, n - static_cast<int>(((a + 4ull * n) & 15) >> 2));
  }
  __device__ unsigned bulk_bytes() const { return 4u * static_cast<unsigned>(i1 - i0); }
  __device__ void issue(unsigned mbar) const {
    if (i1 > i0)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
          ::"r"(smem_addr(s + i0)), "l"(g + i0), "r"(bulk_bytes()), "r"(mbar) : "memory");
  }
  __device__ void copy_ends() const {
    const int head = i0, tail = n - i1;
    for (int i = threadIdx.x; i < head + tail; i += blockDim.x) {
      const int k = i < head ? i : i1 + (i - head);
      s[k] = g[k];
    }
  }
};

__device__ __forceinline__ bool mbar_try_wait(unsigned mbar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(ok) : "r"(mbar), "r"(parity) : "memory");
  return ok != 0;
}

// Route (w): warp w of the block runs cell cells[blockIdx.x * kWarps + w]
// in its slot_bytes of dynamic shared memory.
__global__ void __launch_bounds__(kWarps * 32, 4) pug_cc_warp_kernel(CcArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int i = blockIdx.x * kWarps + w;
  if (i >= a.n_cells) return;
  const int c = a.cells[i];
  const long long v0 = a.node_off[c], e0 = a.entry_off[c];
  const int n = static_cast<int>(a.node_off[c + 1] - v0);
  const int m = static_cast<int>(a.entry_off[c + 1] - e0);
  const int kh = min(n, m);
  unsigned char* slot = smem + w * a.slot_bytes;
  int* act = reinterpret_cast<int*>(slot);
  int* par_rw = reinterpret_cast<int*>(slot + r16(4LL * kh));
  int* off = reinterpret_cast<int*>(slot + 2 * r16(4LL * kh));
  int* nbc = reinterpret_cast<int*>(slot + 2 * r16(4LL * kh) + r16(4LL * (kh + 1)));
  if (m > kWarpEntries ||
      2 * r16(4LL * kh) + r16(4LL * (kh + 1)) + r16(4LL * m) > a.slot_bytes)
    __trap();
  volatile int* par = par_rw;

  int nb[kWarpRegs];
#pragma unroll
  for (int q = 0; q < kWarpRegs; ++q) {
    const int j = q * 32 + lane;
    nb[q] = j < m ? a.nbr[e0 + j] : 0;
  }
  const long long* deg = a.deg + v0;
  int* lab = a.labels_out + v0;
  int k = 0, o = 0;  // edged nodes and entries before this step (warp-uniform)
  int d[kItems], nd[kItems];  // this step's degrees and the next step's, in flight
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int v = q * 32 + lane;
    d[q] = v < n ? static_cast<int>(deg[v]) : 0;
  }
  for (int base = 0; base < n; base += kItems * 32) {
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const int v = base + (kItems + q) * 32 + lane;
      nd[q] = v < n ? static_cast<int>(deg[v]) : 0;
    }
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const int v = base + q * 32 + lane;
      const int dq = d[q];
      const unsigned edged = __ballot_sync(kFull, dq > 0);
      const int incl = warp_inclusive_sum(dq, lane);
      if (dq > 0) {
        const int r = k + __popc(edged & ((1u << lane) - 1));
        act[r] = v;
        par_rw[r] = r;
        off[r] = o + incl - dq;
      } else if (v < n) {
        lab[v] = v;
      }
      k += __popc(edged);
      o += __shfl_sync(kFull, incl, 31);
    }
#pragma unroll
    for (int q = 0; q < kItems; ++q) d[q] = nd[q];
  }
  if (o != m) __trap();  // the degrees do not sum to the cell's entries
  if (lane == 0) off[k] = m;
  __syncwarp();
#pragma unroll
  for (int q = 0; q < kWarpRegs; ++q) {
    const int j = q * 32 + lane;
    if (j < m) nbc[j] = rank_in(act, k, nb[q]);
  }
  __syncwarp();
  for (int r = lane; r < k; r += 32)
    for (int j = off[r]; j < off[r + 1]; ++j)
      if (nbc[j] < r) unite(par, r, nbc[j]);
  __syncwarp();
  for (int r = lane; r < k; r += 32) lab[act[r]] = act[find_root(par, r)];
  if (lane == 0) a.rounds_out[c] = 1;
}

// Routes (a), (b) and (c): one block per cell.
template <int kRoute>
__global__ void __launch_bounds__(kMaxThreads, 2) pug_cc_block_kernel(CcArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned mbar = smem_addr(smem);
  int* run = reinterpret_cast<int*>(smem + 8);  // edged nodes and entries so far
  int* tot = reinterpret_cast<int*>(smem + 16);  // the step's totals by (item, warp)
  int* pre = tot + 2 * kScan;                    // and their exclusive prefixes
  unsigned char* p = smem + kHeader;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int c = a.cells[blockIdx.x];
  const long long v0 = a.node_off[c], e0 = a.entry_off[c];
  const int n = static_cast<int>(a.node_off[c + 1] - v0);
  const int m = static_cast<int>(a.entry_off[c + 1] - e0);
  const int kh = min(n, m);

  int *act, *off, *nbc, *par_rw, *gmap = nullptr;
  long long used;  // shared bytes after the header
  Slice nbr_s(p, a.nbr + e0, 0);
  if constexpr (kRoute == kStaged) {
    act = reinterpret_cast<int*>(p);
    par_rw = reinterpret_cast<int*>(p + r16(4LL * kh));
    off = reinterpret_cast<int*>(p + 2 * r16(4LL * kh));
    unsigned char* region = p + 2 * r16(4LL * kh) + r16(4LL * (kh + 1));
    nbr_s = Slice(region, a.nbr + e0, m);
    nbc = reinterpret_cast<int*>(nbr_s.s);
    used = (region - p) + r16(4LL * m) + 16;
  } else {
    int* s = a.scratch + a.scratch_off[c];
    act = s;
    off = s + kh;
    nbc = s + 2 * kh + 1;
    gmap = nbc + m;
    par_rw = kRoute == kShared ? reinterpret_cast<int*>(p) : gmap + n;
    used = kRoute == kShared ? r16(4LL * kh) : 0;
  }
  unsigned dyn;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn));
  if (kHeader + used > static_cast<long long>(dyn)) __trap();
  // the node-to-rank map: in shared memory where its 4n bytes fit after
  // the layout, else in the scratch (routes b, c) or none (route a)
  int* map = kHeader + used + 4LL * n <= static_cast<long long>(dyn)
                 ? reinterpret_cast<int*>(p + used) : gmap;
  volatile int* par = par_rw;

  if (threadIdx.x == 0) {
    run[0] = run[1] = 0;
    if constexpr (kRoute == kStaged) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(mbar), "r"(1) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  if constexpr (kRoute == kStaged) {
    __syncthreads();  // the mbarrier is initialised
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(mbar),
                   "r"(nbr_s.bulk_bytes()) : "memory");
      nbr_s.issue(mbar);
    }
    nbr_s.copy_ends();
  }

  // 1. the degrees, kItems a thread per step, warp-striped
  const long long* deg = a.deg + v0;
  int* lab = a.labels_out + v0;
  const int n_tot = kItems * nw;
  int d[kItems], nd[kItems];  // this step's degrees and the next step's, in flight
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int v = q * blockDim.x + threadIdx.x;
    d[q] = v < n ? static_cast<int>(deg[v]) : 0;
  }
  for (int base = 0; base < n; base += kItems * blockDim.x) {
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const int v = base + (kItems + q) * blockDim.x + threadIdx.x;
      nd[q] = v < n ? static_cast<int>(deg[v]) : 0;
    }
    int below[kItems], incl[kItems];
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const int v = base + q * blockDim.x + threadIdx.x;
      const int dq = d[q];
      const unsigned edged = __ballot_sync(kFull, dq > 0);
      below[q] = __popc(edged & ((1u << lane) - 1));
      incl[q] = warp_inclusive_sum(dq, lane);
      if (lane == 31) {
        tot[q * nw + wid] = __popc(edged);
        tot[kScan + q * nw + wid] = incl[q];
      }
      if (dq == 0 && v < n) lab[v] = v;
    }
    __syncthreads();
    if (wid == 0) {  // exclusive prefixes of the totals in node order, two a lane
      const int t0 = 2 * lane, t1 = 2 * lane + 1;
      const int c0 = t0 < n_tot ? tot[t0] : 0, c1 = t1 < n_tot ? tot[t1] : 0;
      const int s0 = t0 < n_tot ? tot[kScan + t0] : 0, s1 = t1 < n_tot ? tot[kScan + t1] : 0;
      const int ci = warp_inclusive_sum(c0 + c1, lane), si = warp_inclusive_sum(s0 + s1, lane);
      const int k0 = run[0], o0 = run[1];
      if (t0 < n_tot) {
        pre[t0] = k0 + ci - c0 - c1;
        pre[kScan + t0] = o0 + si - s0 - s1;
      }
      if (t1 < n_tot) {
        pre[t1] = k0 + ci - c1;
        pre[kScan + t1] = o0 + si - s1;
      }
      __syncwarp();
      if (lane == 31) {
        run[0] = k0 + ci;
        run[1] = o0 + si;
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      if (d[q] > 0) {
        const int v = base + q * blockDim.x + threadIdx.x;
        const int r = pre[q * nw + wid] + below[q];
        act[r] = v;
        par_rw[r] = r;
        off[r] = pre[kScan + q * nw + wid] + incl[q] - d[q];
        if (map) map[v] = r;
      }
    }
#pragma unroll
    for (int q = 0; q < kItems; ++q) d[q] = nd[q];
  }
  __syncthreads();
  const int k = run[0];
  if (run[1] != m) __trap();  // the degrees do not sum to the cell's entries
  if (threadIdx.x == 0) off[k] = m;

  // 2. the neighbours as ranks
  if constexpr (kRoute == kStaged) {
    while (!mbar_try_wait(mbar, 0)) {
    }
  }
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const int x = kRoute == kStaged ? nbc[j] : a.nbr[e0 + j];
    nbc[j] = map ? map[x] : rank_in(act, k, x);
  }
  __syncthreads();

  // 3. the union-find
  for (int r = threadIdx.x; r < k; r += blockDim.x)
    for (int j = off[r]; j < off[r + 1]; ++j)
      if (nbc[j] < r) unite(par, r, nbc[j]);
  __syncthreads();
  for (int r = threadIdx.x; r < k; r += blockDim.x) lab[act[r]] = act[find_root(par, r)];
  if (threadIdx.x == 0) a.rounds_out[c] = 1;
}

using Kernel = void (*)(CcArgs);
const Kernel kKernels[4] = {pug_cc_warp_kernel, pug_cc_block_kernel<kStaged>,
                                pug_cc_block_kernel<kShared>, pug_cc_block_kernel<kGlobal>};

// Opens each variant to the device's whole opt-in shared memory, once per
// variant (the largest size any launch asks for).
cudaError_t open_shared_memory(int route) {
  static int opened_on[4] = {-1, -1, -1, -1};
  int dev = 0, bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || opened_on[route] == dev) return err;
  err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kKernels[route], cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) opened_on[route] = dev;
  return err;
}

}  // namespace

extern "C" {

// K7 over the n_cells cells of `cells` on `route` (0: (w), eight cells a
// block of 256 threads, smem_bytes / 8 a warp; 1-3: (a)-(c), one cell a
// block of `threads` threads), each with smem_bytes of dynamic shared
// memory (ops/pug_device.py::launch_plan sizes both).  Returns the CUDA
// error of the launch (0 when it was accepted).
int aft_pug_cc(const long long* deg, const int* nbr, const long long* node_off,
               const long long* entry_off, const long long* scratch_off, const int* cells,
               int n_cells, int route, int threads, long long smem_bytes, int* scratch,
               int* labels_out, int* rounds_out, void* stream) {
  if (n_cells <= 0) return 0;
  if (route < kWarp || route > kGlobal) return static_cast<int>(cudaErrorInvalidValue);
  if (route == kWarp ? threads != kWarps * 32 || smem_bytes % kWarps != 0
                     : threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
                           smem_bytes < kHeader)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = open_shared_memory(route);
  if (err != cudaSuccess) return static_cast<int>(err);
  CcArgs a{deg,     nbr,     node_off,   entry_off,  scratch_off, cells,
           n_cells, smem_bytes / kWarps, scratch, labels_out, rounds_out};
  const int blocks = route == kWarp ? (n_cells + kWarps - 1) / kWarps : n_cells;
  kKernels[route]<<<blocks, threads, static_cast<size_t>(smem_bytes),
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
