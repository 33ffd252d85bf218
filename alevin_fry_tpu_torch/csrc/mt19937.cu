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
// One block runs one row, with the 624-word state in shared memory.  A
// twist runs in four dependency-free phases (i < 227, 227 <= i < 454,
// 454 <= i < 623, then i = 623, which reads the new word 0), each a read
// into registers, a barrier and a write.  After each twist the block finds
// the dictionary entries whose ids fall in its 312 doubles (the ids
// ascend), and each such entry tempers its own two words and writes its
// value; the next twist's first barrier orders those reads before its
// writes.  The block stops after the twist that holds the row's largest id.
//
// Bound: per row the seeding's 623 sequential steps (3 instructions each),
// the twists up to the row's largest id (5 a word: LOP3, shift, the
// matrix select in two, LOP3), and per entry two tempered words (8 each:
// a shift and a LOP3 a step) and the two shifts that pair them; the output
// is one float per entry.  The work per twist is a few hundred cycles
// between barriers, so enough blocks must be resident: 320 threads and
// 2.5 KB of shared memory a block let an SM hold six.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 320;
constexpr int kN = 624;
constexpr int kM = 397;
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

// One phase of the twist: words [lo, hi) take twist_word(mt[i], mt[i+1],
// mt[i + off]); every read lands before any write.
__device__ __forceinline__ void twist_phase(unsigned* mt, int lo, int hi, int off) {
  const int i = lo + static_cast<int>(threadIdx.x);
  unsigned v = 0;
  if (i < hi) v = twist_word(mt[i], mt[i + 1], mt[i + off]);
  __syncthreads();
  if (i < hi) mt[i] = v;
  __syncthreads();
}

// The first entry at or past `from` whose id is >= bound (ids ascend).
__device__ __forceinline__ long long lower_bound(const int* id, long long from, long long n,
                                                 int bound) {
  long long lo = from, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (id[mid] < bound) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads) mt_init_kernel(const long long* seeds,
                                                           const long long* dict_off,
                                                           const int* ids, int n_cells,
                                                           long long n_dict, float* out) {
  __shared__ unsigned mt[kN];
  const int c = blockIdx.x;
  const int r = blockIdx.y;
  const long long d0 = dict_off[c];
  const long long n = dict_off[c + 1] - d0;
  if (n <= 0) return;
  const int* id = ids + d0;
  float* o = out + static_cast<long long>(r) * n_dict + d0;
  const int last = id[n - 1];

  if (threadIdx.x == 0) {
    unsigned s = static_cast<unsigned>(seeds[static_cast<long long>(r) * n_cells + c]);
    mt[0] = s;
    for (int i = 1; i < kN; ++i) {
      s = 1812433253u * (s ^ (s >> 30)) + static_cast<unsigned>(i);
      mt[i] = s;
    }
  }
  __syncthreads();

  const float eps = __int_as_float(0x3727C5AC);  // float32(1e-5)
  long long j = 0;  // the next dictionary entry
  for (int base = 0; base <= last; base += kDoubles) {
    twist_phase(mt, 0, kN - kM, kM);
    twist_phase(mt, kN - kM, 2 * (kN - kM), -(kN - kM));
    twist_phase(mt, 2 * (kN - kM), kN - 1, -(kN - kM));
    if (threadIdx.x == 0)
      mt[kN - 1] = twist_word(mt[kN - 1], mt[0], mt[kM - 1]);
    __syncthreads();
    const long long hi = lower_bound(id, j, n, base + kDoubles);
    for (long long k = j + threadIdx.x; k < hi; k += kThreads) {
      const int t = id[k] - base;
      const unsigned a = temper(mt[2 * t]) >> 5;
      const unsigned b = temper(mt[2 * t + 1]) >> 6;
      const double d = __ull2double_rn((static_cast<unsigned long long>(a) << 26) | b) *
                       (1.0 / 9007199254740992.0);
      o[k] = __fadd_rn(__double2float_rn(d), eps);
    }
    j = hi;
  }
}

}  // namespace

extern "C" {

// K8 over n_cells x n_rep rows, one block each: row (c, r) seeds from
// seeds[r * n_cells + c] and writes out[r * n_dict + e] for each entry e of
// cell c's dictionary (ids[dict_off[c]:dict_off[c+1]], ascending).
// Returns the CUDA error of the launch (0 when it was accepted).
int aft_mt_init(const long long* seeds, const long long* dict_off, const int* ids, int n_cells,
                int n_rep, long long n_dict, float* out, void* stream) {
  if (n_cells <= 0 || n_rep <= 0) return 0;
  if (n_rep > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  mt_init_kernel<<<dim3(n_cells, n_rep), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      seeds, dict_off, ids, n_cells, n_dict, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
