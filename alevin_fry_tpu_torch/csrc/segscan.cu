// Segmented-scan kernels K1-K3 for Hopper (sm_90a).
//
// Replaces the three single-pass Pallas scans of
// alevin_fry_tpu/ops/pallas_segscan.py:
//   K1  _fwd_fn  (:82)  inclusive cumsum c of int32 x, and the running max b
//                       of where(start, c - x, -1), in one pass;
//   K2  _min_fn  (:135) running min of int32 values (callers scan it in
//                       reverse to broadcast segment totals);
//   K3  _lex_fn  (:226) running lexicographic max / min over (hi, lo) int32
//                       pairs.  Here the pair arrives packed into one int64
//                       word (hi << 32 | lo + 2^31), whose signed order is
//                       the lexicographic order, so the scan is a plain
//                       64-bit max / min: Hopper compares 64-bit integers
//                       natively, and the pairwise select the TPU needed is
//                       unnecessary.
//
// On the TPU the grid ran in order on one core and carried the scan state
// through SMEM between grid steps.  Blocks on the H100 run in parallel and
// in no order.  All three run lookback_scan_kernel, a single-pass scan with
// decoupled look-back (Merrill and Garland; the scheme of CUB's DeviceScan):
// every element is read once and every output written once, in one launch.
//   * A block takes its tile index from an atomicAdd on a counter in the
//     scratch buffer, so it only ever waits on tiles that blocks already
//     running have taken: blocks need not start in blockIdx order.
//   * The tile scans its elements, publishes its aggregate (status A), then
//     one warp walks back over its predecessors, one per lane, 32 tiles a
//     step, combining aggregates from the nearest backwards until a tile
//     that has published its inclusive prefix (status P); it publishes its
//     own P and writes its outputs.  The states (8 bytes) leave no spare
//     bits for a flag, so each tile has a 32-bit status word beside its
//     aggregate and its prefix: the value is stored first, then the status
//     with st.release.gpu; readers load the status with ld.acquire.gpu
//     and only then the value, through L2.  The C entry points clear the
//     counter and the status words on the caller's stream before each
//     launch, so no flag survives from an earlier call.
//   * Memory is read and written warp-striped in 16-byte vectors (int4 of
//     K1's x with the 4 mask bytes as one 32-bit word, int4 of K2's values,
//     longlong2 of K3's words):
//     lane l of a warp takes the l-th vector of 32 consecutive ones, so
//     one warp instruction touches one contiguous 512-byte span.  Each
//     thread scans its vector serially, the warp scans the thread totals
//     with shuffles and carries across the warp's successive vectors.
//   * While it waits for its prefix the tile sits in shared memory, not in
//     registers.  A block's life is its loads, its wait and its stores,
//     and the card's rate is the bytes of the resident tiles over that
//     life; staging cut the registers (K1 64 -> 48, K3 76 -> 60) and so
//     raised the blocks per SM, where the wait (the largest part of a
//     block's life) cannot be shortened much: a tile walks back a few
//     windows to the nearest P.  The warp polls only while a tile
//     nearer than the nearest P is still X, and sleeps 200 ns per poll.
//   * The vector grid starts where the first input's pointer is 16-byte
//     aligned, so a view such as w[1:] costs nothing; the partial vectors
//     at either end, and any array whose alignment differs from the first
//     input's, take scalar accesses.  A reverse scan walks the vectors from
//     the back and reverses each vector's elements in registers.
//   * The combine need not commute (K1's is not): every combine takes the
//     earlier span first, in the tile and over the look-back window.
// Bound: device memory.  K1 reads 5 B and writes 8 B per element, K2 reads
// and writes 4 B, K3 reads and writes 8 B.  Tile: 256 threads x Op::Items
// elements.  K1 and K3 take 16, the fastest of 8, 12 and 16 on the RNA
// path's inputs (24 and more exceed the 48 KB of static shared memory for
// K3).  K2 moves fewer bytes per element while its look-back waits as
// long, so a larger tile pays: it takes 32, the fastest of 16, 24 and 32
// on the paths' inputs (PERF.md has the ranking).
//
// The kernels allocate nothing: the caller passes a scratch buffer of
// aft_segscan_scratch_bytes(n) bytes, and launches go on the caller's
// stream.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// lookback_scan_kernel: the fewest elements per thread of any op (the
// scratch bound follows its tile), and the scratch layout (tile counter,
// one status word per tile, then the aggregates and the inclusive
// prefixes, 8 bytes each).
constexpr int kMinItems = 16;
constexpr unsigned kStatusX = 0, kStatusA = 1, kStatusP = 2;

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// K1 state over a span: s = sum of x; m = largest in-span exclusive prefix
// sum at a start row of the span, or INT_MIN when the span has none.
struct Fwd {
  int s;
  int m;
};

__device__ __forceinline__ int shfl_up(int v, int d) {
  return __shfl_up_sync(kFull, v, d);
}
__device__ __forceinline__ long long shfl_up(long long v, int d) {
  return __shfl_up_sync(kFull, v, d);
}
__device__ __forceinline__ Fwd shfl_up(Fwd v, int d) {
  return Fwd{__shfl_up_sync(kFull, v.s, d), __shfl_up_sync(kFull, v.m, d)};
}
__device__ __forceinline__ int shfl_down(int v, int d) {
  return __shfl_down_sync(kFull, v, d);
}
__device__ __forceinline__ long long shfl_down(long long v, int d) {
  return __shfl_down_sync(kFull, v, d);
}
__device__ __forceinline__ Fwd shfl_down(Fwd v, int d) {
  return Fwd{__shfl_down_sync(kFull, v.s, d), __shfl_down_sync(kFull, v.m, d)};
}
__device__ __forceinline__ int shfl_idx(int v, int src) {
  return __shfl_sync(kFull, v, src);
}
__device__ __forceinline__ long long shfl_idx(long long v, int src) {
  return __shfl_sync(kFull, v, src);
}
__device__ __forceinline__ Fwd shfl_idx(Fwd v, int src) {
  return Fwd{__shfl_sync(kFull, v.s, src), __shfl_sync(kFull, v.m, src)};
}

// A state as the 8-byte aggregate and prefix slots hold it (an int
// zero-extended).
__device__ __forceinline__ unsigned long long to_bits(int v) {
  return (unsigned long long)(unsigned)v;
}
__device__ __forceinline__ unsigned long long to_bits(long long v) {
  return (unsigned long long)v;
}
__device__ __forceinline__ unsigned long long to_bits(Fwd v) {
  return (unsigned long long)(unsigned)v.s | ((unsigned long long)(unsigned)v.m << 32);
}
__device__ __forceinline__ void from_bits(unsigned long long b, int* v) {
  *v = (int)(unsigned)b;
}
__device__ __forceinline__ void from_bits(unsigned long long b, long long* v) {
  *v = (long long)b;
}
__device__ __forceinline__ void from_bits(unsigned long long b, Fwd* v) {
  *v = Fwd{(int)(unsigned)b, (int)(unsigned)(b >> 32)};
}

// Whether array a (elements of `size` bytes) can be read or written in
// vectors of `vec` elements on the grid whose vectors start at elements
// q * vec - phase.
inline bool on_grid(const void* a, int size, int vec, int phase) {
  const uintptr_t p = (uintptr_t)a;
  return p % size == 0 && (int)((p / size) % vec) == phase;
}

template <int V, class E>
__device__ __forceinline__ void reverse_lanes(E (&e)[V]) {
#pragma unroll
  for (int k = 0; k < V / 2; ++k) {
    E t = e[k];
    e[k] = e[V - 1 - k];
    e[V - 1 - k] = t;
  }
}

struct FwdOp {
  using T = Fwd;
  static constexpr int V = 4;  // one int4 of x per vector
  static constexpr int Items = 16;
  struct In {
    int x[V];
    unsigned char f[V];
  };
  struct Out {
    int c[V];
    int b[V];
  };
  const int* x;
  const unsigned char* st;
  int* c;
  int* b;
  // which arrays lie on the vector grid (x always does: it defines it)
  bool vst, vc, vb;

  void place(int phase) {
    vst = on_grid(st, 1, V, phase);
    vc = on_grid(c, 4, V, phase);
    vb = on_grid(b, 4, V, phase);
  }
  __device__ T identity() const { return T{0, INT_MIN}; }
  __device__ T combine(T a, T z) const {
    int m = z.m == INT_MIN ? a.m : max(a.m, wrap_add(a.s, z.m));
    return T{wrap_add(a.s, z.s), m};
  }
  __device__ T elem(const In& in, int k) const { return T{in.x[k], in.f[k] ? 0 : INT_MIN}; }
  __device__ void put(Out& o, int k, T v) const {
    o.c[k] = v.s;
    o.b[k] = max(v.m, -1);
  }
  // Elements j0 .. j0 + V - 1; `whole` when all lie in [0, n).  Elements
  // outside read as x = 0, no start: the identity.  Vectors load and store
  // with the evict-first hint (measured faster for K1, slower for K3).
  __device__ void load(In& in, long long j0, bool whole, long long n) const {
    if (whole) {
      const int4 v = __ldcs(reinterpret_cast<const int4*>(x + j0));
      in.x[0] = v.x, in.x[1] = v.y, in.x[2] = v.z, in.x[3] = v.w;
    }
    if (whole && vst) {
      const uchar4 f = __ldcs(reinterpret_cast<const uchar4*>(st + j0));
      in.f[0] = f.x, in.f[1] = f.y, in.f[2] = f.z, in.f[3] = f.w;
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const long long j = j0 + k;
      const bool in_range = j >= 0 && j < n;
      if (!whole) in.x[k] = in_range ? x[j] : 0;
      if (!(whole && vst)) in.f[k] = in_range ? st[j] : 0;
    }
  }
  __device__ void store(const Out& o, long long j0, bool whole, long long n) const {
    if (whole && vc) __stcs(reinterpret_cast<int4*>(c + j0), make_int4(o.c[0], o.c[1], o.c[2], o.c[3]));
    if (whole && vb) __stcs(reinterpret_cast<int4*>(b + j0), make_int4(o.b[0], o.b[1], o.b[2], o.b[3]));
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const long long j = j0 + k;
      if (j < 0 || j >= n) continue;
      if (!(whole && vc)) c[j] = o.c[k];
      if (!(whole && vb)) b[j] = o.b[k];
    }
  }
  __device__ static void flip(In& in) {
    reverse_lanes<V>(in.x);
    reverse_lanes<V>(in.f);
  }
  __device__ static void flip(Out& o) {
    reverse_lanes<V>(o.c);
    reverse_lanes<V>(o.b);
  }
};

struct MinOp {
  using T = int;
  static constexpr int V = 4;  // one int4 per vector
  static constexpr int Items = 32;
  struct alignas(16) In {
    int e[V];
  };
  struct Out {
    int o[V];
  };
  const int* e;
  int* out;
  bool vout;

  void place(int phase) { vout = on_grid(out, 4, V, phase); }
  __device__ T identity() const { return INT_MAX; }
  __device__ T combine(T a, T z) const { return z < a ? z : a; }
  __device__ T elem(const In& in, int k) const { return in.e[k]; }
  __device__ void put(Out& o, int k, T v) const { o.o[k] = v; }
  // Elements outside [0, n) read as INT_MAX, the identity.  Vectors load
  // and store with the evict-first hint (measured faster, as for K1).
  __device__ void load(In& in, long long j0, bool whole, long long n) const {
    if (whole) {
      const int4 v = __ldcs(reinterpret_cast<const int4*>(e + j0));
      in.e[0] = v.x, in.e[1] = v.y, in.e[2] = v.z, in.e[3] = v.w;
      return;
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const long long j = j0 + k;
      in.e[k] = j >= 0 && j < n ? e[j] : INT_MAX;
    }
  }
  __device__ void store(const Out& o, long long j0, bool whole, long long n) const {
    if (whole && vout) {
      __stcs(reinterpret_cast<int4*>(out + j0), make_int4(o.o[0], o.o[1], o.o[2], o.o[3]));
      return;
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const long long j = j0 + k;
      if (j >= 0 && j < n) out[j] = o.o[k];
    }
  }
  __device__ static void flip(In& in) { reverse_lanes<V>(in.e); }
  __device__ static void flip(Out& o) { reverse_lanes<V>(o.o); }
};

struct LexOp {
  using T = long long;
  static constexpr int V = 2;  // one longlong2 per vector
  static constexpr int Items = 16;
  struct alignas(16) In {
    long long w[V];
  };
  struct Out {
    long long o[V];
  };
  const long long* w;
  long long* out;
  int bigger;
  bool vout;

  void place(int phase) { vout = on_grid(out, 8, V, phase); }
  __device__ T identity() const { return bigger ? LLONG_MIN : LLONG_MAX; }
  __device__ T combine(T a, T z) const {
    return bigger ? (z > a ? z : a) : (z < a ? z : a);
  }
  __device__ T elem(const In& in, int k) const { return in.w[k]; }
  __device__ void put(Out& o, int k, T v) const { o.o[k] = v; }
  __device__ void load(In& in, long long j0, bool whole, long long n) const {
    if (whole) {
      const longlong2 v = *reinterpret_cast<const longlong2*>(w + j0);
      in.w[0] = v.x, in.w[1] = v.y;
      return;
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const long long j = j0 + k;
      in.w[k] = j >= 0 && j < n ? w[j] : identity();
    }
  }
  __device__ void store(const Out& o, long long j0, bool whole, long long n) const {
    if (whole && vout) {
      *reinterpret_cast<longlong2*>(out + j0) = make_longlong2(o.o[0], o.o[1]);
      return;
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const long long j = j0 + k;
      if (j >= 0 && j < n) out[j] = o.o[k];
    }
  }
  __device__ static void flip(In& in) { reverse_lanes<V>(in.w); }
  __device__ static void flip(Out& o) { reverse_lanes<V>(o.o); }
};

// --- single-pass scan ---------------------------------------------------------

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

struct ScanScratch {
  unsigned* counter;
  unsigned* status;
  unsigned long long* aggs;
  unsigned long long* prefix;
};

inline long long round16(long long b) { return (b + 15) / 16 * 16; }

// Bytes to clear before a launch over n_tiles tiles: the counter and the
// status words.
inline long long lookback_flag_bytes(long long n_tiles) { return 16 + round16(4 * n_tiles); }

inline ScanScratch lookback_scratch(void* scratch, long long n_tiles) {
  char* p = (char*)scratch;
  ScanScratch s;
  s.counter = (unsigned*)p;
  s.status = (unsigned*)(p + 16);
  s.aggs = (unsigned long long*)(p + lookback_flag_bytes(n_tiles));
  s.prefix = s.aggs + n_tiles;
  return s;
}

inline long long lookback_bytes(long long n_tiles) {
  return lookback_flag_bytes(n_tiles) + 16 * n_tiles;
}

template <class Op, class T>
__device__ __forceinline__ T warp_inclusive_scan(const Op& op, T v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    T y = shfl_up(v, d);
    if (lane >= d) v = op.combine(y, v);
  }
  return v;
}

template <class T>
__device__ __forceinline__ void publish(const ScanScratch& s, unsigned long long* vals,
                                        long long tile, unsigned status, T v) {
  __stcg(vals + tile, to_bits(v));
  st_release(s.status + tile, status);
}

// Exclusive prefix of tile `tile` (> 0), by warp-wide decoupled look-back:
// lane i reads tile win - i; the window's values are combined older first
// up to the nearest tile with status P.  The warp waits only while a tile
// nearer than that one (any tile of the window when none has P) has
// published nothing.  Every lane returns the prefix.
template <class Op>
__device__ typename Op::T look_back(const Op& op, const ScanScratch& s, long long tile,
                                    int lane) {
  using T = typename Op::T;
  T excl = op.identity();
  for (long long win = tile - 1;; win -= 32) {
    const long long p = win - lane;
    unsigned st, done;
    for (;;) {
      st = p >= 0 ? ld_acquire(s.status + p) : kStatusP;
      done = __ballot_sync(kFull, st == kStatusP);
      // lanes 0 .. the nearest P, or all 32 (the shift wraps to 0 at lane 31)
      const unsigned needed = done ? ((done & (0u - done)) << 1) - 1u : kFull;
      if (!(__ballot_sync(kFull, st == kStatusX) & needed)) break;
      __nanosleep(200);
    }
    const int last = done ? __ffs(done) - 1 : 31;
    T v = op.identity();
    if (p >= 0 && lane <= last) from_bits(__ldcg((st == kStatusP ? s.prefix : s.aggs) + p), &v);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      T y = shfl_down(v, d);
      if (lane + d < 32) v = op.combine(y, v);
    }
    excl = op.combine(shfl_idx(v, 0), excl);
    if (done) return excl;
  }
}

template <class Op>
__global__ void __launch_bounds__(kThreads)
lookback_scan_kernel(Op op, long long n, int reverse, int phase, ScanScratch s) {
  using T = typename Op::T;
  constexpr int V = Op::V;
  constexpr int kSlots = Op::Items / V;  // vectors per thread
  static_assert(Op::Items % V == 0, "Items must be a multiple of the vector width");
  static_assert(Op::Items >= kMinItems, "the scratch bound assumes at least kMinItems");
  static_assert(sizeof(typename Op::In) * kSlots * kThreads <= 47 * 1024,
                "the staged tile must fit the 48 KB of static shared memory");
  __shared__ unsigned long long tile_idx;
  __shared__ T warp_pre[kWarps];
  __shared__ T tile_pre;
  // the tile, vector k of thread t at stage[k][t], held here and not in
  // registers while the tile waits for its prefix
  __shared__ typename Op::In stage[kSlots][kThreads];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) tile_idx = atomicAdd(s.counter, 1u);
  __syncthreads();
  const long long tile = (long long)tile_idx;

  // vector q holds elements q * V - phase ... q * V - phase + V - 1; logical
  // vector i of the scan is vector i, or nv - 1 - i from the back
  const long long nv = (n + phase + V - 1) / V;
  const long long first = tile * (kSlots * kThreads) + (long long)warp * 32 * kSlots + lane;
  typename Op::In in[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const long long i = first + 32 * k;
    const long long q = reverse ? nv - 1 - i : i;
    const long long j0 = q * V - phase;
    op.load(in[k], j0, i < nv && j0 >= 0 && j0 + V <= n, n);
  }

  // thread-serial reduce of each vector, warp scan of the thread totals,
  // carry across the warp's successive vectors
  T pre[kSlots];
  T carry = op.identity();
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    if (reverse) Op::flip(in[k]);
    stage[k][threadIdx.x] = in[k];
    T t = op.elem(in[k], 0);
#pragma unroll
    for (int e = 1; e < V; ++e) t = op.combine(t, op.elem(in[k], e));
    const T inc = warp_inclusive_scan(op, t, lane);
    T ex = shfl_up(inc, 1);
    if (lane == 0) ex = op.identity();
    pre[k] = op.combine(carry, ex);
    carry = op.combine(carry, shfl_idx(inc, 31));
  }
  if (lane == 0) warp_pre[warp] = carry;
  __syncthreads();

  if (warp == 0) {
    T v = lane < kWarps ? warp_pre[lane] : op.identity();
    v = warp_inclusive_scan(op, v, lane);
    const T agg = shfl_idx(v, kWarps - 1);
    T ex = shfl_up(v, 1);
    if (lane == 0) ex = op.identity();
    if (lane < kWarps) warp_pre[lane] = ex;
    T tp = op.identity();
    if (tile == 0) {
      if (lane == 0) publish(s, s.prefix, tile, kStatusP, agg);
    } else {
      if (lane == 0) publish(s, s.aggs, tile, kStatusA, agg);
      tp = look_back(op, s, tile, lane);
      if (lane == 0) publish(s, s.prefix, tile, kStatusP, op.combine(tp, agg));
    }
    if (lane == 0) tile_pre = tp;
  }
  __syncthreads();

  const T base = op.combine(tile_pre, warp_pre[warp]);
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const long long i = first + 32 * k;
    if (i >= nv) break;
    const long long q = reverse ? nv - 1 - i : i;
    const long long j0 = q * V - phase;
    T run = op.combine(base, pre[k]);
    const typename Op::In v = stage[k][threadIdx.x];
    typename Op::Out o;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      run = op.combine(run, op.elem(v, e));
      op.put(o, e, run);
    }
    if (reverse) Op::flip(o);
    op.store(o, j0, j0 >= 0 && j0 + V <= n, n);
  }
}

// One launch of lookback_scan_kernel over n elements of op.  The vector
// grid follows `first`, the pointer of op's first input (elements of
// `size` bytes); op.place marks the other arrays that share it.
template <class Op>
int run_lookback(Op op, const void* first, int size, long long n, int reverse, void* scratch,
                 void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int phase = (int)(((uintptr_t)first / size) % Op::V);
  op.place(phase);
  const long long nv = (n + phase + Op::V - 1) / Op::V;
  constexpr long long kTileVectors = (long long)kThreads * Op::Items / Op::V;
  const long long n_tiles = (nv + kTileVectors - 1) / kTileVectors;
  cudaError_t err = cudaMemsetAsync(scratch, 0, lookback_flag_bytes(n_tiles), st);
  if (err != cudaSuccess) return (int)err;
  lookback_scan_kernel<Op><<<(unsigned)n_tiles, kThreads, 0, st>>>(
      op, n, reverse, phase, lookback_scratch(scratch, n_tiles));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch bytes a scan over n elements needs, for any op: the counter,
// the status words and two 8-byte states per tile at the smallest tile,
// plus one tile for the grid's phase.
long long aft_segscan_scratch_bytes(long long n) {
  return lookback_bytes((n + 8) / (kThreads * kMinItems) + 1);
}

// Elements per tile of kernel K<k> (1, 2 or 3).
int aft_segscan_tile(int k) {
  return kThreads * (k == 1 ? FwdOp::Items : k == 2 ? MinOp::Items : LexOp::Items);
}

// K1: c = inclusive cumsum of x; b = running max of where(st, c - x, -1).
int aft_segscan_fwd(const void* x, const void* st, void* c, void* b, long long n,
                    void* scratch, void* stream) {
  FwdOp op{(const int*)x, (const unsigned char*)st, (int*)c, (int*)b};
  return run_lookback(op, x, 4, n, 0, scratch, stream);
}

// K2: running min of e, from the back when reverse != 0.
int aft_segscan_min(const void* e, void* out, long long n, int reverse,
                    void* scratch, void* stream) {
  MinOp op{(const int*)e, (int*)out};
  return run_lookback(op, e, 4, n, reverse, scratch, stream);
}

// K3: running max (bigger != 0) or min of packed int64 words, from the back
// when reverse != 0.
int aft_segscan_lex(const void* w, void* out, long long n, int bigger, int reverse,
                    void* scratch, void* stream) {
  LexOp op{(const long long*)w, (long long*)out, bigger};
  return run_lookback(op, w, 8, n, reverse, scratch, stream);
}

}  // extern "C"
