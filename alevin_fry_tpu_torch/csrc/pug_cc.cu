// K7: connected components of the per-cell UMI graphs (PUGs) for Hopper
// (sm_90a).
//
// Replaces the JAX package's device programs for the same function, XLA
// and not Pallas: alevin_fry_tpu/ops/pug_device.py::connected_components_batched
// (:122, gather label propagation :165-202) and _dense_cc_run (:72, boolean
// matrix squaring on the MXU).  The TPU squared a dense N x N matrix
// because its gathers were slow; on Hopper gathers from shared memory are
// cheap, so this kernel propagates labels over the graph's CSR directly:
// no padding to a (B, N, D) ladder, no N^2 matrix, and no cell left to the
// host.
//
// What it computes: for every node v of every cell, the smallest
// cell-local node index of v's weakly connected component, given each
// cell's symmetrized adjacency (csrc/radc.cpp::radc_pug_graph_export: a
// degree per node and the cell-local neighbours, node by node).  That is
// what the reference's union-find defines (pugutils.rs:278-301) and what
// radc_pug_cover takes.
//
// Layout: one 256-thread block per cell.  The cell's labels live in
// dynamic shared memory when its 4n bytes fit the block's limit (227 KB on
// the H100, opted in with cudaFuncSetAttribute); a larger cell's live in
// its slice of a global scratch buffer, through the same pointer.  The
// wrapper launches the cells in groups of like shared-memory size.
//
// A round: each thread takes nodes v = tid, tid + 256, ... and computes
// m = min(lab[v], lab[w] for every neighbour w), then m = min(m, lab[m])
// (pointer jumping); where m < lab[v] it lowers lab[v] and lab[lab[v]]
// (the old label's node: hooking) to m with atomicMin, and marks the round
// as changed.  __syncthreads_or ends the loop after a round in which no
// label moved.
//
// Why the result is exact, whatever the order the threads run in: labels
// only decrease, each is always the index of a node of the same component
// (the min of such indices), and lab[x] <= x.  In a round where no thread
// lowered anything every value was constant, so every v had lab[v] <=
// lab[w] for each neighbour w, which makes labels constant over each
// component (the adjacency is symmetric), and lab[lab[v]] = lab[v]: the
// label is a node of the component whose own label is itself, that is the
// component's smallest index.  Reads are volatile and writes atomic, so no
// update is lost to a stale register.
//
// Bound: the degrees (8 bytes), the neighbours (4 bytes each) and the
// labels out (4 bytes per node) once each; each round reads them again
// from shared memory and L1/L2.  The work per round is one min per
// adjacency entry; the rounds a component needs depend on its diameter,
// so the kernel is bound by the latency of its rounds, not by bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct CcArgs {
  const long long* node_off;     // (C+1) first global node of each cell
  const long long* adj_off;      // (N+1) first neighbour of each node
  const int* nbr;                // (A) cell-local neighbour ids
  const int* cell_list;          // the cells of this launch
  const long long* scratch_off;  // (C) int offset in scratch, -1: shared
  int* scratch;
  int* labels_out;               // (N) cell-local component label
  int* rounds_out;               // (C) rounds run
};

__global__ void __launch_bounds__(kThreads) pug_cc_kernel(CcArgs a) {
  extern __shared__ int smem[];
  const int c = a.cell_list[blockIdx.x];
  const long long v0 = a.node_off[c];
  const int n = static_cast<int>(a.node_off[c + 1] - v0);
  int* lab_rw = a.scratch_off[c] >= 0 ? a.scratch + a.scratch_off[c] : smem;
  volatile int* lab = lab_rw;
  const long long* ao = a.adj_off + v0;

  for (int v = threadIdx.x; v < n; v += kThreads) lab[v] = v;
  int rounds = 0;
  for (;;) {
    __syncthreads();
    int changed = 0;
    for (int v = threadIdx.x; v < n; v += kThreads) {
      const int old = lab[v];
      int m = old;
      for (long long k = ao[v]; k < ao[v + 1]; ++k) m = min(m, lab[a.nbr[k]]);
      m = min(m, lab[m]);
      if (m < old) {
        atomicMin(lab_rw + v, m);
        atomicMin(lab_rw + old, m);
        changed = 1;
      }
    }
    ++rounds;
    if (!__syncthreads_or(changed)) break;
  }
  for (int v = threadIdx.x; v < n; v += kThreads) a.labels_out[v0 + v] = lab[v];
  if (threadIdx.x == 0) a.rounds_out[c] = rounds;
}

}  // namespace

extern "C" {

// K7 over the n_list cells of cell_list, one block each, with smem_bytes of
// dynamic shared memory (0 for cells whose scratch_off is >= 0).  Returns
// the CUDA error of the launch (0 when it was accepted).
int aft_pug_cc(const long long* node_off, const long long* adj_off, const int* nbr,
               const int* cell_list, int n_list, const long long* scratch_off, int* scratch,
               long long smem_bytes, int* labels_out, int* rounds_out, void* stream) {
  if (n_list <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      pug_cc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  CcArgs a{node_off, adj_off, nbr, cell_list, scratch_off, scratch, labels_out, rounds_out};
  pug_cc_kernel<<<n_list, kThreads, static_cast<size_t>(smem_bytes),
                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
