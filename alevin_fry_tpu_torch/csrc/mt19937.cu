// K8: the bootstraps' random EM init for Hopper (sm_90a): NumPy's legacy
// RandomState(seed).random_sample stream, one stream per (cell, replicate)
// row, read at the ids of the cell's dictionary.
//
// Replaces the init of the JAX package's bootstraps: its host path draws
// np.random.RandomState(seed_i).random_sample(R + 1).astype(np.float32)
// + 1e-5 per row (alevin_fry_tpu/ops/bootstrap.py:237-241, :322-324), and
// its device path generated a threefry init on the chip instead
// (ops/em.py:340-345, :639-650).  This kernel gives the host path's numbers
// on the card, so the port's bootstraps equal the reference's host path
// byte for byte.
//
// The stream: MT19937 seeded by init_genrand (mt[0] = seed, mt[i] =
// 1812433253 * (mt[i-1] ^ (mt[i-1] >> 30)) + i), twisted before each 624
// words, each word tempered; double k is ((a >> 5) * 2^26 + (b >> 6)) / 2^53
// of words 2k and 2k + 1 (exact in double), rounded to float and added to
// 1e-5f with round-to-nearest intrinsics, as NumPy does in float32.
//
// Bound: per row the seeding's 623 sequential steps (3 instructions each),
// the twists up to the row's largest id (5 a word: LOP3, shift, the
// matrix select in two, LOP3), and per entry two tempered words (8 each:
// a shift and a LOP3 a step) and the two shifts that pair them; the output
// is one float per entry.  So the kernel is bound by its int32 instructions
// (it runs at 2.5x that bound, PERF.md), and the design's aim is to keep
// enough rows in flight that the SM's issue slots, not barriers or
// dependent loads, are the limit.
//
// One warp runs one row, with the row's 624-word state in shared memory
// (2,496 B), and a block holds kWarps rows (the replicates of a cell side
// by side, so they read the same ids), so an SM holds up to 64 rows.  A
// twist runs in four dependency-free runs (i < 227, 227 <= i < 454,
// 454 <= i < 623, then i = 623, which reads the new word 0): each lane
// reads its words of a run into registers, __syncwarp, writes them.  The
// seeding stays a sequential chain on one lane; the other warps' twists
// hide its latency.  After each twist a cursor walks the row's entries:
// the ids ascend, so a ballot of id < base + 312 over the next 32 entries
// finds those the twist serves, with no search; each such lane tempers its
// entry's two words and writes its value.  The warp stops after the twist
// that holds the row's largest id.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;  // rows a block
constexpr int kN = 624;
constexpr int kM = 397;
constexpr int kRun = kN - kM;  // 227 words in each of the first two runs
constexpr int kDoubles = kN / 2;
constexpr unsigned kMatrixA = 0x9908B0DFu;
constexpr unsigned kUpper = 0x80000000u;
constexpr unsigned kLower = 0x7FFFFFFFu;

__device__ __forceinline__ unsigned twist_word(unsigned cur, unsigned next, unsigned far) {
  const unsigned y = (cur & kUpper) | (next & kLower);
  return far ^ (y >> 1) ^ ((y & 1u) ? kMatrixA : 0u);
}

__device__ __forceinline__ unsigned temper(unsigned y) {
  y ^= y >> 11;
  y ^= (y << 7) & 0x9D2C5680u;
  y ^= (y << 15) & 0xEFC60000u;
  return y ^ (y >> 18);
}

// One run of the twist by one warp: words [lo, lo + n) take
// twist_word(mt[i], mt[i+1], mt[i + off]); every read lands before any write.
template <int kLo, int kCount, int kOff>
__device__ __forceinline__ void twist_run(unsigned* mt, int lane) {
  constexpr int kPer = (kCount + 31) / 32;
  unsigned v[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int i = kLo + lane + 32 * q;
    if (lane + 32 * q < kCount) v[q] = twist_word(mt[i], mt[i + 1], mt[i + kOff]);
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < kPer; ++q)
    if (lane + 32 * q < kCount) mt[kLo + lane + 32 * q] = v[q];
  __syncwarp();
}

__global__ void __launch_bounds__(kWarps * 32) mt_init_kernel(const long long* seeds,
                                                              const long long* dict_off,
                                                              const int* ids, int n_cells,
                                                              int n_rep, long long n_dict,
                                                              float* out) {
  __shared__ unsigned state[kWarps][kN];
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= static_cast<long long>(n_cells) * n_rep) return;  // the whole warp
  const int c = static_cast<int>(row / n_rep);
  const int r = static_cast<int>(row - static_cast<long long>(c) * n_rep);
  const long long d0 = dict_off[c];
  const int n = static_cast<int>(dict_off[c + 1] - d0);
  if (n <= 0) return;
  unsigned* mt = state[threadIdx.x >> 5];
  const int* id = ids + d0;
  float* o = out + static_cast<long long>(r) * n_dict + d0;
  const int last = id[n - 1];

  if (lane == 0) {
    unsigned s = static_cast<unsigned>(seeds[static_cast<long long>(r) * n_cells + c]);
    mt[0] = s;
    for (int i = 1; i < kN; ++i) {
      s = 1812433253u * (s ^ (s >> 30)) + static_cast<unsigned>(i);
      mt[i] = s;
    }
  }
  __syncwarp();

  const float eps = __int_as_float(0x3727C5AC);  // float32(1e-5)
  int j = 0;  // the next entry
  for (int base = 0; base <= last; base += kDoubles) {
    twist_run<0, kRun, kM>(mt, lane);
    twist_run<kRun, kRun, -kRun>(mt, lane);
    twist_run<2 * kRun, kN - 1 - 2 * kRun, -kRun>(mt, lane);
    if (lane == 0) mt[kN - 1] = twist_word(mt[kN - 1], mt[0], mt[kM - 1]);
    __syncwarp();
    for (;;) {
      const int k = j + lane;
      const bool in = k < n && id[k] < base + kDoubles;
      const unsigned m = __ballot_sync(0xffffffffu, in);
      if (in) {
        const int t = id[k] - base;
        const unsigned a = temper(mt[2 * t]) >> 5;
        const unsigned b = temper(mt[2 * t + 1]) >> 6;
        const double d = __ull2double_rn((static_cast<unsigned long long>(a) << 26) | b) *
                         (1.0 / 9007199254740992.0);
        o[k] = __fadd_rn(__double2float_rn(d), eps);
      }
      j += __popc(m);
      if (m != 0xffffffffu) break;
    }
    __syncwarp();  // the next twist writes the words these lanes read
  }
}

}  // namespace

extern "C" {

// K8 over n_cells x n_rep rows, one warp each, kWarps a block: row (c, r)
// seeds from seeds[r * n_cells + c] and writes out[r * n_dict + e] for each
// entry e of cell c's dictionary (ids[dict_off[c]:dict_off[c+1]], ascending).
// Returns the CUDA error of the launch (0 when it was accepted).
int aft_mt_init(const long long* seeds, const long long* dict_off, const int* ids, int n_cells,
                int n_rep, long long n_dict, float* out, void* stream) {
  if (n_cells <= 0 || n_rep <= 0) return 0;
  const long long blocks = (static_cast<long long>(n_cells) * n_rep + kWarps - 1) / kWarps;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  mt_init_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(seeds, dict_off, ids, n_cells, n_rep,
                                                         n_dict, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
