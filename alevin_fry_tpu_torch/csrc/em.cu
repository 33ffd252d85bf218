// K6: the per-cell equivalence-class EM for Hopper (sm_90a).
//
// Replaces the JAX package's EM device programs, XLA and not Pallas:
// alevin_fry_tpu/ops/em.py::_get_em_kernel (:276) and
// _get_em_kernel_compact (:446).  Those padded every cell to a shape ladder
// (_EP_LADDER), ran the rounds of a whole batch under lax.while_loop with
// per-cell masks, and sent cells of more than 1,024 classes to NumPy on the
// host.  Here one block runs one cell's whole round loop at the cell's own
// size, so no cell is padded, none waits for the slowest of a batch, and
// none goes to the host.
//
// What it computes is the native host EM, radc_em_cells
// (csrc/radc.cpp:2551-2680), operation for operation, so the floats agree
// bit for bit:
//   * seeds: each id's single-label counts, added in class order; the
//     informative init (seed + 0.5f) * 1e-3f over the cell's dictionary, or
//     the uniform 1/R that the caller passes;
//   * a round: abundances (USA: the id plus its partners, left to right),
//     each multi-label class's denominator over its labels in order and
//     inv = count / denom (no contribution where denom is 0), then each id's
//     new value: 0, plus its single-label counts, plus abundance * inv of
//     each multi-label class holding it, in class order;
//   * converged when no id has a new value over 1e-2 that moved by more
//     than 1e-2; at least 2 rounds, at most 100; with with_last_round, a
//     converged cell zeroes its values below 0.01 and runs one round more;
//   * the final values below 0.01 become 0.
// The host lays each cell out once (ops/em.py::plan_cells): a dictionary of
// the ids it touches plus their USA partners (local ids 0..U-1), labels as
// local ids, each touched id's partners as local ids, and each id's
// occurrence list, the labels transposed (~e for a single-label class e,
// e for a multi-label one, singles first, each part in class order).  One
// thread per id sums its own list in that order, which is the host's order
// of addition: no atomics, and no run-to-run change.  The singles' part of
// that sum is the same every round (0 plus the same counts in the same
// order), so it is taken once, as the id's seed, and each round starts
// from the seed at the id's first multi-label occurrence: the same adds in
// the same order.  Every float operation is an explicit round-to-nearest
// intrinsic (__fadd_rn, __fmul_rn, __fdiv_rn, __fsub_rn), so nvcc contracts
// no product and sum into an FMA, which the host never does.
//
// A round is two or three phases between barriers: (A, USA only) the
// abundance of every id, (B) the inverse of every multi-label class, (C)
// the new value of every id, written over its alpha (only its own thread
// reads it then).  Without USA partners the abundance is the alpha itself,
// so phase A and its array go.  At block start the block lists its
// multi-label classes and the ids with a multi-label occurrence (in no
// particular order: each entry's sum is its own); an id without one takes
// its seed in round 1 and keeps it, so later rounds run phase B over the
// first list and phases A and C over the second, and the singles and the
// untouched USA partners cost nothing a round.  Each link of a sum is a
// dependent chain (load the occurrence, load the inverse, multiply, add),
// so what bounds a cell is the latency of those loads: the design keeps
// them in shared memory.  Three routes, chosen per cell from its bytes on the host
// (ops/em.py::launch_plan) against the block's shared-memory limit (227 KB
// on the H100, opted in with cudaFuncSetAttribute):
//   (a) staged: the cell's layout (its class and occurrence offsets as
//       int32 relative to the cell, the labels' local ids, the occurrence
//       lists, the USA partners, the weights) and its state live in
//       dynamic shared memory.  The layout comes in once, before round 1:
//       one thread issues a Hopper bulk copy (cp.async.bulk, completion on
//       an mbarrier) for the 16-byte aligned middle of each contiguous
//       slice while the other threads convert the offsets and load the
//       counts and the slices' unaligned ends; after that the rounds read
//       only shared memory and registers.
//   (b) shared: the state (alphas, seeds, abundances, inverses) in shared
//       memory, the layout read from device memory each round.
//   (c) global: the state in the cell's slice of a global scratch buffer,
//       through the same pointers, for the largest cells.
// The wrapper launches the cells in groups of like route, tile, block size
// and shared-memory size, so that a few large cells do not limit how many
// blocks of small ones an SM holds, and gives a large cell's block more
// threads.
//
// The weighted mode (the long-read EM, em_optimize_weighted_cell_np in the
// JAX package's ops/em.py:157-216, the host path it takes) gives each label
// a weight (lab_w, and occ_w for the same labels in occurrence order): a
// class's denominator sums alpha[id] * w over its labels, an occurrence
// adds (alpha[id] * w) * scale with scale = count / max(denom, 1e-30)
// where denom > 0, and there is no USA coupling and no last round.  The
// host sums each class's row padded with zeros to the cell's longest
// class, Lmax, with NumPy's pairwise order (np_row_sum below), so the
// denominator follows that order at Lmax, not the class's own length.
//
// The bootstrap mode runs the replicate EMs of the reference's host
// bootstraps (alevin_fry_tpu/ops/bootstrap.py:71-340) over the same layout,
// with each (cell, replicate) row's resampled counts (countf, E floats a
// replicate) and random init (init, U floats a replicate; kernel K8 draws
// it).  On route (a) one block runs a tile of up to 32 replicates of one
// cell over its one staged layout (grid (cells, tiles)): the threads stride
// over (replicate, id) and (replicate, class) pairs of the replicates still
// running, and each replicate keeps its own rounds, convergence and last
// round as one bit of the block's round masks, so a replicate that has
// finished is not touched again.  On routes (b) and (c) a tile is one
// replicate.  A work item carries two replicates of one id or class: the
// layout's loads (occurrence, label) are made once for both, and their two
// sums are independent chains that the thread interleaves (four an item
// took more registers and ran slower, PERF.md).
// Every row runs its rounds from its init, even a cell whose
// classes all have one label, with the last round.  A cell of at most
// 1,024 classes took em_batch_np there, whose denominators NumPy sums over
// rows padded to its rung's width Lp (cell_lp: np_row_sum at n = Lp) with
// inv = count / max(denom, 1e-30); a larger cell took em_optimize_cell_np
// (cell_lp 0): sequential denominators, inv = count / denom.  A row on the
// global route takes its slice of scratch at scratch_off[c] + r *
// scratch_stride.
//
// Bound: the device memory traffic is one read of the layout and counts
// and one write of the values; what each round reads again stays on the
// SM.  The work is sequential along each id's list and each class's
// labels, and a cell's rounds depend on each other, so the kernel is
// bound by the latency of those chains and of the rounds' barriers, not
// by bytes or operations (56-74x its byte bound, PERF.md).  The design
// shortens each round (the lists; a large cell's links read from shared
// memory, some tens of cycles, in place of L2, some hundreds: its phase
// C ran 3.1x faster staged, a small cell's, whose layout stays in L1,
// 1.3x), shares one staged layout among a tile's replicates, and gives a
// bootstrap item two independent chains.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxThreads = 512;
constexpr int kChunk = 2;  // replicates a bootstrap work item carries: independent sums
constexpr int kMaxTile = 32;  // replicates a block: one bit each of the round masks
constexpr int kHeader = 32;   // mbarrier (8 B), the two moved masks, the longest class, two counts
constexpr float kMinOut = 0.01f;
constexpr float kCheckCutoff = 1e-2f;
constexpr float kRelTol = 1e-2f;
constexpr int kMinIter = 2;
constexpr int kMaxIter = 100;

enum Mode { kPlain = 0, kWeighted = 1, kBoot = 2 };

struct EmArgs {
  const long long* cell_cls;     // (C+1) classes of each cell
  const long long* lab_off;      // (E+1) labels of each class
  const int* lab_loc;            // (L) each label's local id
  const float* countf;           // (E) class counts; bootstrap: (N, E)
  const long long* dict_off;     // (C+1) dictionary of each cell
  const int* p1;                 // (U) first partner (local), -1 none
  const int* p2;                 // (U) second partner (local), -1 none
  const long long* occ_off;      // (U+1) occurrence list of each entry
  const int* occ;                // (L) ~e single / e multi, class-local
  const float* lab_w;            // (L) each label's weight; null: unweighted
  const float* occ_w;            // (L) the same weights in occurrence order
  const int* cell_list;          // the cells of this launch
  const long long* scratch_off;  // (C) float offset in scratch, -1: shared memory
  float* scratch;
  float init_value;              // 1/R for the uniform init, 0: informative
  int with_last_round;
  float* alpha_out;              // (U) final values; bootstrap: (N, U)
  int* rounds_out;               // (C) rounds run (0: no EM); bootstrap: (N, C)
  // the bootstrap mode only
  const int* cell_lp;            // (C) row-sum width of the cell's rung, 0: sequential
  const float* init;             // (N, U) each row's initial values
  long long n_cls, n_dict, n_cells;  // E, U and C: the strides of a replicate
  long long scratch_stride;      // scratch floats of a replicate
  int n_rep, tile;               // replicates, and replicates a block
};

__device__ __forceinline__ long long r16(long long b) { return (b + 15) & ~15LL; }
// bytes of the shared-memory slice that stages n words copied in bulk:
// the array starts at its source's offset within 16 bytes
__device__ __forceinline__ long long slice_bytes(long long n) { return r16(4 * n) + 16; }

// A cell's CSR offsets relative to its first entry: staged as int32 in
// shared memory, or read from the batch's int64 offsets in device memory.
template <bool kStage>
struct Offsets;
template <>
struct Offsets<true> {
  const int* p;
  __device__ __forceinline__ int operator[](int i) const { return p[i]; }
};
template <>
struct Offsets<false> {
  const long long* p;
  long long base;
  __device__ __forceinline__ int operator[](int i) const {
    return static_cast<int>(p[i] - base);
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One contiguous slice of n words staged at `region` (slice_bytes(n)
// bytes, 16-byte aligned): the staged array s sits at the source's offset
// within 16 bytes, so words [i0, i1) go by one bulk copy between 16-byte
// aligned addresses and the up to three words at each end by plain loads.
struct Slice {
  const unsigned* g = nullptr;
  unsigned* s = nullptr;
  int n = 0, i0 = 0, i1 = 0;
  __device__ Slice() {}
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

// A slot at the end of a shared list: one atomicAdd for the lanes that
// append together.
__device__ __forceinline__ int append_slot(int* count) {
  const cg::coalesced_group g = cg::coalesced_threads();
  int base = 0;
  if (g.thread_rank() == 0) base = atomicAdd(count, static_cast<int>(g.size()));
  return g.shfl(base, 0) + static_cast<int>(g.thread_rank());
}

// The k-th (from 0) set bit of m.
__device__ __forceinline__ int nth_bit(unsigned m, int k) {
  for (; k > 0; --k) m &= m - 1;
  return __ffs(m) - 1;
}

// f(js, nq, x) for every x < n and every chunk of up to W replicates whose
// bits are set in mask (js[0..nq) the chunk's replicates, in order), the
// items spread over the block's threads.
template <int W, class F>
__device__ __forceinline__ void for_items(unsigned mask, int n, F&& f) {
  if (n <= 0 || mask == 0) return;
  const int na = __popc(mask);
  const int nch = (na + W - 1) / W;
  const bool low = (mask & (mask + 1)) == 0;  // replicates 0..na-1
  int k = static_cast<int>(threadIdx.x) / n;
  int x = static_cast<int>(threadIdx.x) - k * n;
  const int dk = static_cast<int>(blockDim.x) / n;
  const int dx = static_cast<int>(blockDim.x) - dk * n;
  int kc = -1, nq = 0;
  int js[W];
  while (k < nch) {
    if (k != kc) {
      kc = k;
      nq = min(W, na - k * W);
#pragma unroll
      for (int q = 0; q < W; ++q) js[q] = q < nq ? (low ? k * W + q : nth_bit(mask, k * W + q)) : 0;
    }
    f(js, nq, x);
    x += dx;
    k += dk;
    if (x >= n) {
      x -= n;
      ++k;
    }
  }
}

// One label value of a class (weighted by w when kW), or 0 past the
// class's labels, for each of W replicates' abundances.
template <bool kW, int W>
__device__ __forceinline__ void row_values(const float* const* ab, const int* loc,
                                           const float* w, int len, int i, float* v) {
  if (i >= len) {
#pragma unroll
    for (int q = 0; q < W; ++q) v[q] = 0.0f;
    return;
  }
  const int l = loc[i];
  const float wi = kW ? w[i] : 1.0f;
#pragma unroll
  for (int q = 0; q < W; ++q) v[q] = kW ? __fmul_rn(ab[q][l], wi) : ab[q][l];
}

// NumPy's float32 sum of one row of n values (pairwise_sum in its
// loops_utils.h; the add reduction starts from the identity 0): under 8
// values left to right; up to 128, eight strided partial sums combined
// as ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)) and then the tail one by one;
// past 128, the two halves split at n/2 rounded down to a multiple of 8,
// each summed the same way.  The row is the class's len values padded
// with zeros to n; a part wholly in the padding adds nothing.  W
// replicates' rows at once (their abundances ab[q], one label layout).
template <bool kW, int W>
__device__ void np_row_sum(const float* const* ab, const int* loc, const float* w, int len,
                           int lo, int n, float* out) {
  float v[W];
  if (lo >= len) {
#pragma unroll
    for (int q = 0; q < W; ++q) out[q] = 0.0f;
    return;
  }
  if (n < 8) {
    float r[W];
#pragma unroll
    for (int q = 0; q < W; ++q) r[q] = 0.0f;
    for (int i = 0; i < n; ++i) {
      row_values<kW, W>(ab, loc, w, len, lo + i, v);
#pragma unroll
      for (int q = 0; q < W; ++q) r[q] = __fadd_rn(r[q], v[q]);
    }
#pragma unroll
    for (int q = 0; q < W; ++q) out[q] = r[q];
    return;
  }
  if (n <= 128) {
    float r[8][W];
#pragma unroll
    for (int k = 0; k < 8; ++k) row_values<kW, W>(ab, loc, w, len, lo + k, r[k]);
    int i = 8;
    for (; i < n - n % 8; i += 8)
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        row_values<kW, W>(ab, loc, w, len, lo + i + k, v);
#pragma unroll
        for (int q = 0; q < W; ++q) r[k][q] = __fadd_rn(r[k][q], v[q]);
      }
#pragma unroll
    for (int q = 0; q < W; ++q)
      out[q] = __fadd_rn(__fadd_rn(__fadd_rn(r[0][q], r[1][q]), __fadd_rn(r[2][q], r[3][q])),
                         __fadd_rn(__fadd_rn(r[4][q], r[5][q]), __fadd_rn(r[6][q], r[7][q])));
    for (; i < n; ++i) {
      row_values<kW, W>(ab, loc, w, len, lo + i, v);
#pragma unroll
      for (int q = 0; q < W; ++q) out[q] = __fadd_rn(out[q], v[q]);
    }
    return;
  }
  int n2 = n / 2;
  n2 -= n2 % 8;
  float o2[W];
  np_row_sum<kW, W>(ab, loc, w, len, lo, n2, out);
  np_row_sum<kW, W>(ab, loc, w, len, lo + n2, n - n2, o2);
#pragma unroll
  for (int q = 0; q < W; ++q) out[q] = __fadd_rn(out[q], o2[q]);
}

// The replicate of item slot q: the chunk's in the bootstrap mode, else
// the block's one.
template <bool kB>
__device__ __forceinline__ int rj(const int* js, int q) {
  return kB ? js[q] : 0;
}

// kMode: plain, weighted (its recursive row sum takes registers and a
// stack frame that the plain mode is kept free of) or bootstrap; kStage:
// route (a), else (b) or (c) by the cell's scratch offset; kUsa: some id
// has a USA partner (the plain mode only).
template <int kMode, bool kStage, bool kUsa>
__global__ void __launch_bounds__(kMaxThreads) em_cell_kernel(EmArgs a) {
  constexpr bool kW = kMode == kWeighted;
  constexpr bool kB = kMode == kBoot;
  constexpr int W = kB ? kChunk : 1;  // replicates an item carries
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = a.cell_list[blockIdx.x];
  const int rep0 = kB ? static_cast<int>(blockIdx.y) * a.tile : 0;
  const int nt = kB ? min(a.tile, a.n_rep - rep0) : 1;  // replicates of this block
  const unsigned all = nt == 32 ? ~0u : (1u << nt) - 1;
  const long long e0 = a.cell_cls[c];
  const int ne = static_cast<int>(a.cell_cls[c + 1] - e0);
  const long long d0 = a.dict_off[c];
  const int nu = static_cast<int>(a.dict_off[c + 1] - d0);
  const long long l0 = a.lab_off[e0];
  const int nl = static_cast<int>(a.lab_off[e0 + ne] - l0);
  const long long k0 = a.occ_off[d0];
  constexpr bool usa = kUsa;

  // the header, then the cell's arrays: shared memory, or scratch (route c)
  const unsigned mbar = smem_addr(smem);
  unsigned* moved_s = reinterpret_cast<unsigned*>(smem + 8);
  int* lmax_s = reinterpret_cast<int*>(smem + 16);
  int* nm_s = reinterpret_cast<int*>(smem + 20);   // multi-label classes
  int* nmi_s = reinterpret_cast<int*>(smem + 24);  // ids with a multi-label occurrence
  unsigned char* p = smem + kHeader;
  if (!kStage && a.scratch_off[c] >= 0)
    p = reinterpret_cast<unsigned char*>(a.scratch + a.scratch_off[c] +
                                         (kB ? rep0 * a.scratch_stride : 0));
  const bool in_smem = kStage || a.scratch_off[c] < 0;
  // each id's first multi-label occurrence, the ids that have one and the
  // multi-label classes, each list in no particular order
  int* mstart = reinterpret_cast<int*>(p);
  int* mids = mstart + nu;
  int* mcls = mids + nu;
  p += r16(4LL * (2 * nu + ne));
  const int* lab_loc = a.lab_loc + l0;
  const int* occ = a.occ + k0;
  const int* p1 = a.p1 + d0;
  const int* p2 = a.p2 + d0;
  const float* lab_w = kW ? a.lab_w + l0 : nullptr;
  const float* occ_w = kW ? a.occ_w + k0 : nullptr;
  Offsets<kStage> lo, oo;
  // route (a)'s staged slices (an unused one is empty)
  Slice s_loc, s_occ, s_p1, s_p2, s_lw, s_ow;
  if constexpr (kStage) {
    int* slo = reinterpret_cast<int*>(p);
    int* soo = slo + ne + 1;
    p += r16(4LL * (ne + nu + 2));
    lo.p = slo;
    oo.p = soo;
    s_loc = Slice(p, lab_loc, nl);
    p += slice_bytes(nl);
    s_occ = Slice(p, occ, nl);
    p += slice_bytes(nl);
    lab_loc = reinterpret_cast<const int*>(s_loc.s);
    occ = reinterpret_cast<const int*>(s_occ.s);
    if constexpr (kUsa) {
      s_p1 = Slice(p, p1, nu);
      p += slice_bytes(nu);
      s_p2 = Slice(p, p2, nu);
      p += slice_bytes(nu);
      p1 = reinterpret_cast<const int*>(s_p1.s);
      p2 = reinterpret_cast<const int*>(s_p2.s);
    }
    if constexpr (kW) {
      s_lw = Slice(p, lab_w, nl);
      p += slice_bytes(nl);
      s_ow = Slice(p, occ_w, nl);
      p += slice_bytes(nl);
      lab_w = reinterpret_cast<const float*>(s_lw.s);
      occ_w = reinterpret_cast<const float*>(s_ow.s);
    }
  } else {
    lo.p = a.lab_off + e0;
    lo.base = l0;
    oo.p = a.occ_off + d0;
    oo.base = k0;
  }
  // each replicate's state: alphas, seeds, abundances (USA), inverses and,
  // staged, its counts
  const long long rw = 2LL * nu + (usa ? nu : 0) + ne + (kStage ? ne : 0);
  float* const rep = reinterpret_cast<float*>(p);
  if (in_smem) {
    unsigned dyn;
    asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn));
    if ((p - smem) + r16(4 * rw * nt) > static_cast<long long>(dyn)) __trap();
  }
  auto alpha_of = [&](int j) { return rep + j * rw; };
  auto seed_of = [&](int j) { return rep + j * rw + nu; };
  auto ab_of = [&](int j) { return usa ? rep + j * rw + 2 * nu : rep + j * rw; };
  auto inv_of = [&](int j) { return rep + j * rw + 2 * nu + (usa ? nu : 0); };
  auto cnt_of = [&](int j) -> const float* {
    if constexpr (kStage) return rep + j * rw + 2 * nu + (usa ? nu : 0) + ne;
    return a.countf + (kB ? static_cast<long long>(rep0 + j) * a.n_cls : 0) + e0;
  };

  if (threadIdx.x == 0) {
    moved_s[0] = moved_s[1] = 0;
    *lmax_s = *nm_s = *nmi_s = 0;
    if constexpr (kStage) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(mbar), "r"(1) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  if constexpr (kStage) {
    __syncthreads();  // the mbarrier is initialised
    if (threadIdx.x == 0) {
      const unsigned tx = s_loc.bulk_bytes() + s_occ.bulk_bytes() + s_p1.bulk_bytes() +
                          s_p2.bulk_bytes() + s_lw.bulk_bytes() + s_ow.bulk_bytes();
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(mbar), "r"(tx)
                   : "memory");
      s_loc.issue(mbar);
      s_occ.issue(mbar);
      s_p1.issue(mbar);
      s_p2.issue(mbar);
      s_lw.issue(mbar);
      s_ow.issue(mbar);
    }
    s_loc.copy_ends();
    s_occ.copy_ends();
    s_p1.copy_ends();
    s_p2.copy_ends();
    s_lw.copy_ends();
    s_ow.copy_ends();
    int* slo = const_cast<int*>(lo.p);
    int* soo = const_cast<int*>(oo.p);
    for (int e = threadIdx.x; e <= ne; e += blockDim.x)
      slo[e] = static_cast<int>(a.lab_off[e0 + e] - l0);
    for (int t = threadIdx.x; t <= nu; t += blockDim.x)
      soo[t] = static_cast<int>(a.occ_off[d0 + t] - k0);
    for (int i = threadIdx.x; i < nt * ne; i += blockDim.x) {
      const int j = i / ne, e = i - j * ne;
      const_cast<float*>(cnt_of(j))[e] =
          a.countf[(kB ? static_cast<long long>(rep0 + j) * a.n_cls : 0) + e0 + e];
    }
  }
  if constexpr (kB) {
    for (int i = threadIdx.x; i < nt * nu; i += blockDim.x) {
      const int j = i / nu, t = i - j * nu;
      alpha_of(j)[t] = a.init[static_cast<long long>(rep0 + j) * a.n_dict + d0 + t];
    }
  }
  if constexpr (kStage) {
    while (!mbar_try_wait(mbar, 0)) {
    }
  }
  __syncthreads();

  // the multi-label classes (and the weighted mode's longest class)
  for (int e = threadIdx.x; e < ne; e += blockDim.x) {
    const int len = lo[e + 1] - lo[e];
    if (len > 1) {
      mcls[append_slot(nm_s)] = e;
      if (kW) atomicMax(lmax_s, len);
    }
  }
  __syncthreads();
  const int nm = *nm_s;
  const bool needs_em = kB || nm > 0;
  const int lmax = kB ? a.cell_lp[c] : *lmax_s;
  // seeds: each id's single-label counts, in class order
  for_items<W>(all, nu, [&](const int* js, int nq, int t) {
    float seed[W];
    const float* cnt[W];
#pragma unroll
    for (int q = 0; q < W; ++q) {
      seed[q] = 0.0f;
      cnt[q] = cnt_of(rj<kB>(js, q));
    }
    int k = oo[t];
    const int end = oo[t + 1];
    for (; k < end; ++k) {
      const int v = occ[k];
      if (v >= 0) break;  // the single-label classes come first
#pragma unroll
      for (int q = 0; q < W; ++q)
        if (q < nq) seed[q] = __fadd_rn(seed[q], cnt[q][~v]);
    }
    if (js[0] == 0) {  // the chunk of replicate 0: once per id
      mstart[t] = k;
      if (k < end) mids[append_slot(nmi_s)] = t;
    }
#pragma unroll
    for (int q = 0; q < W; ++q) {
      if (q >= nq) break;
      seed_of(rj<kB>(js, q))[t] = seed[q];
      if constexpr (!kB)
        alpha_of(0)[t] = !needs_em          ? seed[q]
                         : a.init_value > 0 ? a.init_value
                                            : __fmul_rn(__fadd_rn(seed[q], 0.5f), 1e-3f);
    }
  });
  __syncthreads();
  const int nmi = *nmi_s;

  // The round masks, the same in every thread: replicates still running,
  // in their last round, and (thread j) replicate j's rounds.  An id with
  // no multi-label occurrence takes its seed in round 1 and keeps it, so
  // after round 1 the phases run over the lists alone.
  unsigned run = needs_em ? all : 0, lst = 0;
  int it = 0, my_rounds = 0;
  while (run) {
    __syncthreads();
    if constexpr (usa) {
      // (A) abundances of the ids the multi-label classes hold
      for_items<W>(run, nmi, [&](const int* js, int nq, int i) {
        const int t = mids[i];
#pragma unroll
        for (int q = 0; q < W; ++q) {
          if (q >= nq) break;
          const float* al = alpha_of(rj<kB>(js, q));
          float v = al[t];
          if (p1[t] >= 0)
            v = p2[t] >= 0 ? __fadd_rn(__fadd_rn(al[p1[t]], al[p2[t]]), v)
                           : __fadd_rn(al[p1[t]], v);
          ab_of(rj<kB>(js, q))[t] = v;
        }
      });
      __syncthreads();
    }
    // (B) count / denominator of each multi-label class
    for_items<W>(run, nm, [&](const int* js, int nq, int m) {
      const int e = mcls[m];
      const int ls = lo[e], le = lo[e + 1];
      const float* ab[W];
      float den[W];
#pragma unroll
      for (int q = 0; q < W; ++q) ab[q] = ab_of(rj<kB>(js, q < nq ? q : 0));
      bool padded = false;
      if constexpr (kW || kB) padded = lmax > 0;
      if (padded) {
        // NumPy's pairwise order over the row padded to lmax
        np_row_sum<kW, W>(ab, lab_loc + ls, kW ? lab_w + ls : nullptr, le - ls, 0, lmax, den);
      } else {
#pragma unroll
        for (int q = 0; q < W; ++q) den[q] = 0.0f;
        for (int i = ls; i < le; ++i) {
          const int l = lab_loc[i];
#pragma unroll
          for (int q = 0; q < W; ++q) den[q] = __fadd_rn(den[q], ab[q][l]);
        }
      }
#pragma unroll
      for (int q = 0; q < W; ++q) {
        if (q >= nq) break;
        const float cnt = cnt_of(rj<kB>(js, q))[e];
        inv_of(rj<kB>(js, q))[e] = !(den[q] > 0.0f) ? 0.0f
                           : padded          ? __fdiv_rn(cnt, fmaxf(den[q], 1e-30f))
                                             : __fdiv_rn(cnt, den[q]);
      }
    });
    __syncthreads();
    // (C) each id's new value: its seed, then its multi-label occurrences
    unsigned mv = 0;
    for_items<W>(run, it == 0 ? nu : nmi, [&](const int* js, int nq, int i) {
      const int t = it == 0 ? i : mids[i];
      const int ks = mstart[t], end = oo[t + 1];
      float o[W], abt[W];
      const float* inv[W];
#pragma unroll
      for (int q = 0; q < W; ++q) {
        const int j = rj<kB>(js, q < nq ? q : 0);
        o[q] = seed_of(j)[t];
        inv[q] = inv_of(j);
        abt[q] = ks < end ? ab_of(j)[t] : 0.0f;
      }
      for (int k = ks; k < end; ++k) {
        const int v = occ[k];
        const float w = kW ? occ_w[k] : 1.0f;
#pragma unroll
        for (int q = 0; q < W; ++q) {
          const float m = kW ? __fmul_rn(abt[q], w) : abt[q];
          o[q] = __fadd_rn(o[q], __fmul_rn(m, inv[q][v]));
        }
      }
#pragma unroll
      for (int q = 0; q < W; ++q) {
        if (q >= nq) break;
        const int j = rj<kB>(js, q);
        float* al = alpha_of(j);
        if (o[q] > kCheckCutoff && fabsf(__fsub_rn(al[t], o[q])) > kRelTol) mv |= 1u << j;
        al[t] = o[q];
      }
    });
    mv = __reduce_or_sync(0xffffffffu, mv);
    if ((threadIdx.x & 31) == 0 && mv) atomicOr(&moved_s[it & 1], mv);
    __syncthreads();
    const unsigned moved = moved_s[it & 1];
    if (threadIdx.x == 0) moved_s[(it & 1) ^ 1] = 0;  // read a round ago, written next round
    ++it;
    const unsigned open = run & ~lst;
    const unsigned conv = it >= kMinIter ? open & ~moved : 0;
    unsigned fin = run & lst;  // their last round is done
    unsigned enter = 0;
    if (a.with_last_round) enter = conv;
    else fin |= conv;
    if (it >= kMaxIter) fin |= open & ~conv;
    if (threadIdx.x < 32 && ((fin >> threadIdx.x) & 1)) my_rounds = it;
    run &= ~fin;
    lst |= enter;
    // a replicate entering its last round zeroes its values below 0.01
    for_items<1>(enter, nu, [&](const int* js, int, int t) {
      float* al = alpha_of(rj<kB>(js, 0));
      if (al[t] < kMinOut) al[t] = 0.0f;
    });
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nt * nu; i += blockDim.x) {
    const int j = i / nu, t = i - j * nu;
    const float v = alpha_of(j)[t];
    a.alpha_out[(kB ? static_cast<long long>(rep0 + j) * a.n_dict : 0) + d0 + t] =
        v < kMinOut ? 0.0f : v;
  }
  if (threadIdx.x < nt)
    a.rounds_out[(kB ? static_cast<long long>(rep0 + threadIdx.x) * a.n_cells : 0) + c] =
        my_rounds;
}

}  // namespace

extern "C" {

// The most dynamic shared memory one block of the current device may use
// (K6 and K7 keep a cell's state there up to this size).
long long aft_smem_limit() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return bytes;
}

// K6 over the n_list cells of cell_list, one block each of `threads`
// threads with smem_bytes of dynamic shared memory (ops/em.py::launch_plan
// sizes both): staged != 0 is route (a), else route (b) or (c) by each
// cell's scratch_off; weighted when lab_w and occ_w are not null, bootstrap
// when cell_lp and init are not null (countf, alpha_out and rounds_out then
// hold n_rep replicates of n_cls, n_dict and n_cells values, and a block
// runs `tile` of them: grid (n_list, ceil(n_rep / tile))).
// Returns the CUDA error of the launch (0 when it was accepted).
int aft_em_cells(const long long* cell_cls, const long long* lab_off, const int* lab_loc,
                 const float* countf, const long long* dict_off, const int* p1, const int* p2,
                 const long long* occ_off, const int* occ, const float* lab_w,
                 const float* occ_w, const int* cell_list, int n_list, int staged, int tile,
                 int threads, const long long* scratch_off, float* scratch,
                 long long smem_bytes, float init_value, int with_last_round, int usa,
                 float* alpha_out, int* rounds_out, const int* cell_lp, const float* init,
                 int n_rep, long long n_cls, long long n_dict, long long n_cells,
                 long long scratch_stride, void* stream) {
  if (n_list <= 0 || n_rep <= 0) return 0;
  const bool boot = cell_lp != nullptr;
  const int tiles = tile > 0 ? (n_rep + tile - 1) / tile : 0;
  if (tile < 1 || tile > kMaxTile || (!boot && (tile != 1 || n_rep != 1)) || tiles > 65535 ||
      (!staged && tile != 1) || threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      smem_bytes < kHeader)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if ((usa && (boot || lab_w != nullptr))) return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(EmArgs);
  if (staged)
    kernel = lab_w != nullptr ? em_cell_kernel<kWeighted, true, false>
             : boot           ? em_cell_kernel<kBoot, true, false>
             : usa            ? em_cell_kernel<kPlain, true, true>
                              : em_cell_kernel<kPlain, true, false>;
  else
    kernel = lab_w != nullptr ? em_cell_kernel<kWeighted, false, false>
             : boot           ? em_cell_kernel<kBoot, false, false>
             : usa            ? em_cell_kernel<kPlain, false, true>
                              : em_cell_kernel<kPlain, false, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  EmArgs a{cell_cls,    lab_off,   lab_loc,   countf,    dict_off,        p1,
           p2,          occ_off,   occ,       lab_w,     occ_w,           cell_list,
           scratch_off, scratch,   init_value, with_last_round, alpha_out, rounds_out,
           cell_lp,     init,      n_cls,     n_dict,    n_cells,         scratch_stride,
           n_rep,       tile};
  kernel<<<dim3(n_list, tiles), threads, static_cast<size_t>(smem_bytes),
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
