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
// of addition: no atomics, and no run-to-run change.  Every float operation
// is an explicit round-to-nearest intrinsic (__fadd_rn, __fmul_rn,
// __fdiv_rn, __fsub_rn), so nvcc contracts no product and sum into an FMA,
// which the host never does.
//
// A round is three phases between barriers: (A) the abundance of every id,
// (B) the inverse of every multi-label class, (C) the new value of every
// id, written over its alpha (only its own thread reads it then), with the
// convergence flag combined by __syncthreads_or.  The alphas, the
// abundances (U floats each), the inverses (E floats) and one int (the
// longest multi-label class, for the weighted mode) live in dynamic
// shared memory when they fit the block's limit (227 KB on the H100, opted
// in with cudaFuncSetAttribute); a larger cell's live in its slice of a
// global scratch buffer, through the same pointers.  The wrapper launches
// the cells in groups of like shared-memory size, so that a few large cells
// do not limit how many blocks of small ones an SM holds.
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
// bootstraps (alevin_fry_tpu/ops/bootstrap.py:71-340): one block per (cell,
// replicate) row, grid (cells, replicates), over the same layout, with the
// row's resampled counts (countf, E floats a replicate) and its random init
// (init, U floats a replicate; kernel K8 draws it).  Every row runs its
// rounds from that init, even a cell whose classes all have one label, with
// the last round.  A cell of at most 1,024 classes took em_batch_np there,
// whose denominators NumPy sums over rows padded to its rung's width Lp
// (cell_lp: np_row_sum at n = Lp) with inv = count / max(denom, 1e-30); a
// larger cell took em_optimize_cell_np (cell_lp 0): sequential
// denominators, inv = count / denom.  A row on the global-memory route
// takes its slice of scratch at scratch_off[c] + r * scratch_stride.
//
// Bound: what each round reads again is the cell's own labels, occurrence
// lists and inverses, which stay in shared memory and L1/L2; the device
// memory traffic is one read of the layout and one write of the values.
// The work is sequential along each id's list and each class's labels, and
// a cell's rounds depend on each other, so the kernel is bound by the
// latency of those chains, not by bytes or operations (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
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
  const float* countf;           // (E) class counts
  const long long* dict_off;     // (C+1) dictionary of each cell
  const int* p1;                 // (U) first partner (local), -1 none
  const int* p2;                 // (U) second partner (local), -1 none
  const long long* occ_off;      // (U+1) occurrence list of each entry
  const int* occ;                // (L) ~e single / e multi, class-local
  const float* lab_w;            // (L) each label's weight; null: unweighted
  const float* occ_w;            // (L) the same weights in occurrence order
  const int* cell_list;          // the cells of this launch
  const long long* scratch_off;  // (C) float offset in scratch, -1: shared
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
};

// One label value of a class (weighted by w when kW), or 0 past the
// class's labels.
template <bool kW>
__device__ __forceinline__ float row_value(const float* ab, const int* loc, const float* w,
                                           int len, int i) {
  if (i >= len) return 0.0f;
  return kW ? __fmul_rn(ab[loc[i]], w[i]) : ab[loc[i]];
}

// NumPy's float32 sum of one row of n values (pairwise_sum in its
// loops_utils.h; the add reduction starts from the identity 0): under 8
// values left to right; up to 128, eight strided partial sums combined
// as ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)) and then the tail one by one;
// past 128, the two halves split at n/2 rounded down to a multiple of 8,
// each summed the same way.  The row is the class's len values padded
// with zeros to n; a part wholly in the padding adds nothing.
template <bool kW>
__device__ float np_row_sum(const float* ab, const int* loc, const float* w, int len, int lo,
                            int n) {
  if (lo >= len) return 0.0f;
  if (n < 8) {
    float r = 0.0f;
    for (int i = 0; i < n; ++i) r = __fadd_rn(r, row_value<kW>(ab, loc, w, len, lo + i));
    return r;
  }
  if (n <= 128) {
    float r[8];
    for (int k = 0; k < 8; ++k) r[k] = row_value<kW>(ab, loc, w, len, lo + k);
    int i = 8;
    for (; i < n - n % 8; i += 8)
      for (int k = 0; k < 8; ++k)
        r[k] = __fadd_rn(r[k], row_value<kW>(ab, loc, w, len, lo + i + k));
    float res = __fadd_rn(__fadd_rn(__fadd_rn(r[0], r[1]), __fadd_rn(r[2], r[3])),
                          __fadd_rn(__fadd_rn(r[4], r[5]), __fadd_rn(r[6], r[7])));
    for (; i < n; ++i) res = __fadd_rn(res, row_value<kW>(ab, loc, w, len, lo + i));
    return res;
  }
  int n2 = n / 2;
  n2 -= n2 % 8;
  return __fadd_rn(np_row_sum<kW>(ab, loc, w, len, lo, n2),
                   np_row_sum<kW>(ab, loc, w, len, lo + n2, n - n2));
}

// kMode: plain, weighted (its recursive row sum takes registers and a
// stack frame that the plain mode is kept free of) or bootstrap.
template <int kMode>
__global__ void __launch_bounds__(kThreads) em_cell_kernel(EmArgs a) {
  constexpr bool kW = kMode == kWeighted;
  constexpr bool kB = kMode == kBoot;
  extern __shared__ float smem[];
  const int c = a.cell_list[blockIdx.x];
  const long long r = kB ? blockIdx.y : 0;  // the replicate
  const long long e0 = a.cell_cls[c];
  const int ne = static_cast<int>(a.cell_cls[c + 1] - e0);
  const long long d0 = a.dict_off[c];
  const int nu = static_cast<int>(a.dict_off[c + 1] - d0);
  float* alpha = smem;
  if (a.scratch_off[c] >= 0) alpha = a.scratch + (kB ? r * a.scratch_stride : 0) + a.scratch_off[c];
  float* ab = alpha + nu;
  float* inv = ab + nu;
  int* lmax_slot = reinterpret_cast<int*>(inv + ne);  // the longest multi-label class
  const long long* lo = a.lab_off + e0;
  const float* cnt = a.countf + (kB ? r * a.n_cls : 0) + e0;
  const long long* oo = a.occ_off + d0;
  const int* p1 = a.p1 + d0;
  const int* p2 = a.p2 + d0;
  const long long out0 = (kB ? r * a.n_dict : 0) + d0;

  bool needs_em = true;
  int lmax = 0;
  if constexpr (kB) {
    lmax = a.cell_lp[c];
    for (int t = threadIdx.x; t < nu; t += kThreads) alpha[t] = a.init[out0 + t];
  } else {
    if (threadIdx.x == 0) *lmax_slot = 0;
    __syncthreads();
    int multi = 0;
    for (int e = threadIdx.x; e < ne; e += kThreads) {
      const int len = static_cast<int>(lo[e + 1] - lo[e]);
      if (len > 1) {
        multi = 1;
        if (kW) atomicMax(lmax_slot, len);
      }
    }
    needs_em = __syncthreads_or(multi);
    lmax = *lmax_slot;

    for (int t = threadIdx.x; t < nu; t += kThreads) {
      float seed = 0.0f;
      for (long long k = oo[t]; k < oo[t + 1]; ++k) {
        const int v = a.occ[k];
        if (v >= 0) break;  // the single-label classes come first
        seed = __fadd_rn(seed, cnt[~v]);
      }
      alpha[t] = !needs_em           ? seed
                 : a.init_value > 0  ? a.init_value
                                     : __fmul_rn(__fadd_rn(seed, 0.5f), 1e-3f);
    }
  }

  int it = 0;
  if (needs_em) {
    bool last = false;
    for (;;) {
      __syncthreads();
      // (A) abundances
      for (int t = threadIdx.x; t < nu; t += kThreads) {
        float v = alpha[t];
        if (p1[t] >= 0)
          v = p2[t] >= 0 ? __fadd_rn(__fadd_rn(alpha[p1[t]], alpha[p2[t]]), v)
                         : __fadd_rn(alpha[p1[t]], v);
        ab[t] = v;
      }
      __syncthreads();
      // (B) count / denominator of each multi-label class
      for (int e = threadIdx.x; e < ne; e += kThreads) {
        const long long ls = lo[e], le = lo[e + 1];
        if (le - ls < 2) continue;
        if constexpr (kW || kB) {
          if (lmax > 0) {
            // NumPy's pairwise order over the row padded to lmax
            const float denom = np_row_sum<kW>(ab, a.lab_loc + ls, kW ? a.lab_w + ls : nullptr,
                                               static_cast<int>(le - ls), 0, lmax);
            inv[e] = denom > 0.0f ? __fdiv_rn(cnt[e], fmaxf(denom, 1e-30f)) : 0.0f;
            continue;
          }
        }
        float denom = 0.0f;
        for (long long j = ls; j < le; ++j) denom = __fadd_rn(denom, ab[a.lab_loc[j]]);
        inv[e] = denom > 0.0f ? __fdiv_rn(cnt[e], denom) : 0.0f;
      }
      __syncthreads();
      // (C) each id's new value, in its list's order
      int moved = 0;
      for (int t = threadIdx.x; t < nu; t += kThreads) {
        const float abt = ab[t];
        float o = 0.0f;
        for (long long k = oo[t]; k < oo[t + 1]; ++k) {
          const int v = a.occ[k];
          const float m = kW ? __fmul_rn(abt, a.occ_w[k]) : abt;
          o = __fadd_rn(o, v < 0 ? cnt[~v] : __fmul_rn(m, inv[v]));
        }
        moved |= o > kCheckCutoff && fabsf(__fsub_rn(alpha[t], o)) > kRelTol;
        alpha[t] = o;
      }
      const bool converged = !__syncthreads_or(moved);
      ++it;
      if (last) break;
      if (converged && it >= kMinIter) {
        if (!a.with_last_round) break;
        for (int t = threadIdx.x; t < nu; t += kThreads)
          if (alpha[t] < kMinOut) alpha[t] = 0.0f;
        last = true;
      } else if (it >= kMaxIter) {
        break;
      }
    }
  }
  for (int t = threadIdx.x; t < nu; t += kThreads) {
    const float v = alpha[t];
    a.alpha_out[out0 + t] = v < kMinOut ? 0.0f : v;
  }
  if (threadIdx.x == 0) a.rounds_out[(kB ? r * a.n_cells : 0) + c] = it;
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

// K6 over the n_list cells of cell_list, one block each (bootstrap mode:
// one block per cell and replicate, grid (n_list, n_rep)), with smem_bytes
// of dynamic shared memory (0 for cells whose scratch_off is >= 0);
// weighted when lab_w and occ_w are not null, bootstrap when cell_lp and
// init are not null (countf, alpha_out and rounds_out then hold n_rep
// replicates of n_cls, n_dict and n_cells values).
// Returns the CUDA error of the launch (0 when it was accepted).
int aft_em_cells(const long long* cell_cls, const long long* lab_off, const int* lab_loc,
                 const float* countf, const long long* dict_off, const int* p1, const int* p2,
                 const long long* occ_off, const int* occ, const float* lab_w,
                 const float* occ_w, const int* cell_list, int n_list,
                 const long long* scratch_off, float* scratch, long long smem_bytes,
                 float init_value, int with_last_round, float* alpha_out, int* rounds_out,
                 const int* cell_lp, const float* init, int n_rep, long long n_cls,
                 long long n_dict, long long n_cells, long long scratch_stride, void* stream) {
  if (n_list <= 0 || n_rep <= 0) return 0;
  const bool boot = cell_lp != nullptr;
  if (n_rep > (boot ? 65535 : 1)) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto kernel = lab_w != nullptr ? em_cell_kernel<kWeighted>
                      : boot           ? em_cell_kernel<kBoot>
                                       : em_cell_kernel<kPlain>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  EmArgs a{cell_cls,   lab_off,  lab_loc,        countf,          dict_off,  p1,
           p2,         occ_off,  occ,            lab_w,           occ_w,     cell_list,
           scratch_off, scratch, init_value,     with_last_round, alpha_out, rounds_out,
           cell_lp,    init,     n_cls,          n_dict,          n_cells,   scratch_stride};
  kernel<<<dim3(n_list, n_rep), kThreads, static_cast<size_t>(smem_bytes),
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
