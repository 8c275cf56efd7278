// K4: exact per-row percentiles of a (T, V) tile matrix, for Hopper.
//
// Replaces the TPU kernel tile_percentiles_pallas / _tile_pct_kernel
// (magellanmapper_tpu/ops/pallas_kernels.py:205-336), which bisected in
// value domain (uint16) or on float-bit keys (f32) with a static iteration
// count, one full count pass per step. This kernel finds the exact k-th and
// (k+1)-th order statistics of both percentiles' ranks by radix select with
// 8-bit digits from the top: 2 passes over a uint16 row, 4 over an f32 row.
// Keys are the uint16 values, or the f32 bits under the order-preserving
// sign flip (negative: ~bits, else bits | 0x80000000), so key order is value
// order for every finite float, negatives included. The result is
// np.percentile's linear interpolation v0 + frac * (v1 - v0), rounded step
// by step as the plain version does it (__f*_rn, built with -fmad=false).
//
// Bound on the card: the bytes of the matrix, read once (7.9 MB for the
// detect path's 252 tiles of 25^3 uint16: 2.4 us at 3.35 TB/s). What holds
// it back is the shared-memory atomics of the counting. Lanes of a warp that
// add to one counter cost little on this card; lanes that add to scattered
// counters cost much more. The pass whose digits scatter (the low byte of
// image values) takes more than half of the time, nearly all of it in its
// increments, and neither conflict-free per-lane counters nor plain (racy)
// increments were faster (PERF.md §6). What the design does:
//
// - Short rows (the host's split gives one chunk a row): one CTA a row
//   reads the row from global memory once, 16 bytes a load and four loads
//   in flight a thread (scalar loads for the ragged head and tail), counts
//   the top digit as it goes and stores the row to shared memory at the
//   same offset within 16 bytes; the later passes read shared memory, 16
//   bytes a load.
// - One histogram a pass, not lane-striped copies: image tiles put the
//   top pass's keys in a few bins, but copies of the histogram (2 to 32 a
//   pass, measured) only add counters and a summing step, and were slower
//   at every count.
// - Ranks that share a prefix share a histogram: later passes keep one
//   histogram per distinct prefix (mostly 1 or 2 of the 4 ranks), so an
//   element takes at most one atomic a pass.
// - The bin search is one warp per rank: 8 bins a lane, a shuffle scan, and
//   a ballot for the lane whose bins cross the rank. Every thread then
//   works out the distinct prefixes itself, and the histograms alternate
//   between two buffers: two barriers a pass.
// - Long rows (more chunks than one a row): a row is split over many CTAs,
//   one launch a pass. Each CTA streams its chunk from global memory (the
//   later passes from L2), adds its histograms into the row's global ones,
//   and the last CTA of the row (__threadfence and a counter) reads them,
//   chooses the digits and leaves the state for the next pass, or writes
//   the result after the last one. Each pass has histograms and a counter
//   of its own in the scratch, which the caller hands over zeroed, so
//   nothing is cleared on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 256;          // 8-bit digits
constexpr int kRanks = 4;           // k_lo, k_lo + 1, k_hi, k_hi + 1
constexpr int kHistWords = kRanks * kBins;
constexpr int kMaxPasses = 4;       // f32 keys: 4 digits
constexpr int kMaxSmem = 232448;    // a CTA's shared memory on sm_90
constexpr int kThreads = 512;       // of 256 to 1024 (PERF.md §6)
constexpr int kMaxDevices = 64;
static_assert(kThreads % 32 == 0 && kThreads >= 32 * kRanks,
              "one warp a rank picks the digits");

// the radix select of the four ranks of one row
struct Select {
  uint32_t prefix[kRanks];   // key bits chosen so far
  uint32_t rank[kRanks];     // 1-indexed rank among the keys of the prefix
};

// the distinct prefixes of a Select, one histogram each
struct Groups {
  uint32_t prefix[kRanks];
  uint32_t of_rank[kRanks];  // index of each rank's prefix
  uint32_t n;
};

__device__ __forceinline__ Groups groups_of(const Select& s) {
  Groups g = {{0u, 0u, 0u, 0u}, {0u, 0u, 0u, 0u}, 0u};
#pragma unroll
  for (int r = 0; r < kRanks; ++r) {
    const uint32_t p = s.prefix[r];
    uint32_t at = g.n;
    // constant indices only, so g stays in registers
#pragma unroll
    for (int j = 0; j < r; ++j)
      if (j < static_cast<int>(g.n) && g.prefix[j] == p && at == g.n) at = j;
#pragma unroll
    for (int j = 0; j <= r; ++j)
      if (at == g.n && j == static_cast<int>(g.n)) g.prefix[j] = p;
    if (at == g.n) ++g.n;
    g.of_rank[r] = at;
  }
  return g;
}

template <bool kU16>
struct Keys {
  using Elem = uint16_t;
  static constexpr int kBits = 16;
  __device__ static uint32_t key(uint32_t e) { return e; }
  __device__ static float value(uint32_t k) { return static_cast<float>(k); }
};

template <>
struct Keys<false> {
  using Elem = uint32_t;
  static constexpr int kBits = 32;
  __device__ static uint32_t key(uint32_t b) {
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  }
  __device__ static float value(uint32_t k) {
    return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
  }
};

template <bool kU16, typename F>
__device__ __forceinline__ void visit(uint4 w, F& f) {
  using K = Keys<kU16>;
  if constexpr (kU16) {
    f(w.x & 0xffffu); f(w.x >> 16); f(w.y & 0xffffu); f(w.y >> 16);
    f(w.z & 0xffffu); f(w.z >> 16); f(w.w & 0xffffu); f(w.w >> 16);
  } else {
    f(K::key(w.x)); f(K::key(w.y)); f(K::key(w.z)); f(K::key(w.w));
  }
}

// f(key) for each of the n elements at p (global or shared memory): the
// 16-byte-aligned body as uint4 reads, four in flight a thread, the ragged
// head and tail one element a thread. Where dst is not null, the elements
// are also stored there (dst has p's offset within 16 bytes).
template <bool kU16, typename F>
__device__ __forceinline__ void for_each_key(
    const typename Keys<kU16>::Elem* __restrict__ p, long long n, F f,
    typename Keys<kU16>::Elem* __restrict__ dst) {
  using K = Keys<kU16>;
  using Elem = typename K::Elem;
  constexpr int kPer = 16 / sizeof(Elem);
  const long long head = min(
      n, static_cast<long long>(
             ((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) /
             sizeof(Elem)));
  const long long body = (n - head) / kPer;
  const uint4* __restrict__ v = reinterpret_cast<const uint4*>(p + head);
  uint4* __restrict__ dv = reinterpret_cast<uint4*>(dst + head);
  const long long bd = kThreads;
  long long i = threadIdx.x;
  for (; i + 3 * bd < body; i += 4 * bd) {
    const uint4 w0 = v[i], w1 = v[i + bd], w2 = v[i + 2 * bd],
                w3 = v[i + 3 * bd];
    if (dst) {
      dv[i] = w0; dv[i + bd] = w1; dv[i + 2 * bd] = w2; dv[i + 3 * bd] = w3;
    }
    visit<kU16>(w0, f); visit<kU16>(w1, f);
    visit<kU16>(w2, f); visit<kU16>(w3, f);
  }
  for (; i < body; i += bd) {
    const uint4 w = v[i];
    if (dst) dv[i] = w;
    visit<kU16>(w, f);
  }
  auto one = [&](long long e) {
    const Elem x = p[e];
    if (dst) dst[e] = x;
    f(K::key(x));
  };
  if (threadIdx.x < head) one(threadIdx.x);
  for (long long e = head + body * kPer + threadIdx.x; e < n; e += bd)
    one(e);
}

// count the keys of each distinct prefix (the bits hi_mask keeps) by
// their digit at `shift` into hist[prefix * 256 + digit], storing the
// elements at dst where it is not null; the top pass (hi_mask 0) has the
// one prefix 0
template <bool kU16>
__device__ __forceinline__ void accumulate(
    const typename Keys<kU16>::Elem* p, long long n, const Groups& g,
    int shift, uint32_t hi_mask, uint32_t* hist,
    typename Keys<kU16>::Elem* dst) {
  const uint32_t ng = g.n;
  const uint32_t g0 = g.prefix[0] & hi_mask, g1 = g.prefix[1] & hi_mask,
                 g2 = g.prefix[2] & hi_mask, g3 = g.prefix[3] & hi_mask;
  for_each_key<kU16>(p, n, [&](uint32_t key) {
    const uint32_t hk = key & hi_mask;
    uint32_t h;
    if (hk == g0) h = 0u;
    else if (ng > 1u && hk == g1) h = 1u;
    else if (ng > 2u && hk == g2) h = 2u;
    else if (ng > 3u && hk == g3) h = 3u;
    else return;
    atomicAdd(&hist[(h << 8) | ((key >> shift) & 0xffu)], 1u);
  }, dst);
}

// warp r < 4 chooses rank r's digit at `shift` from its prefix's histogram
__device__ __forceinline__ void select_digits(const uint32_t* hist,
                                              const Groups& g, Select& s,
                                              int shift) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= kRanks) return;
  const uint32_t of = warp == 0 ? g.of_rank[0] : warp == 1 ? g.of_rank[1]
                      : warp == 2 ? g.of_rank[2] : g.of_rank[3];
  const uint4* h =
      reinterpret_cast<const uint4*>(hist + (of << 8) + lane * 8);
  const uint4 a = h[0], b = h[1];
  const uint32_t c[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t sum = 0u;
#pragma unroll
  for (int d = 0; d < 8; ++d) sum += c[d];
  uint32_t incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  const uint32_t want = s.rank[warp];
  const unsigned ball = __ballot_sync(0xffffffffu, incl >= want);
  if (lane != __ffs(ball) - 1) return;
  uint32_t below = incl - sum;
  uint32_t digit = 7u;
  bool found = false;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    if (!found) {
      if (below + c[d] >= want) {
        digit = d;
        found = true;
      } else {
        below += c[d];
      }
    }
  }
  s.prefix[warp] |= (static_cast<uint32_t>(lane * 8) + digit) << shift;
  s.rank[warp] = want - below;
}

__device__ void init_select(Select& s, long long V, int k_lo, int k_hi) {
  for (int r = 0; r < kRanks; ++r) {
    const long long k = (r < 2 ? k_lo : k_hi) + (r & 1);
    s.rank[r] = static_cast<uint32_t>(k < V ? k : V);
    s.prefix[r] = 0u;
  }
}

__device__ __forceinline__ float interpolate(float v0, float v1,
                                             float frac) {
  if (!(frac > 0.0f)) return v0;
  return __fadd_rn(v0, __fmul_rn(frac, __fsub_rn(v1, v0)));
}

template <bool kU16>
__device__ void write_out(const Select& s, float frac_lo, float frac_hi,
                          float* o) {
  using K = Keys<kU16>;
  o[0] = interpolate(K::value(s.prefix[0]), K::value(s.prefix[1]), frac_lo);
  o[1] = interpolate(K::value(s.prefix[2]), K::value(s.prefix[3]), frac_hi);
}

__device__ __forceinline__ void zero(uint32_t* a, int n) {
  uint4* a4 = reinterpret_cast<uint4*>(a);
  for (int i = threadIdx.x; i < n / 4; i += kThreads)
    a4[i] = make_uint4(0u, 0u, 0u, 0u);
}

// one CTA a row: the top pass while the row is staged in shared memory,
// the later passes there
template <bool kU16>
__global__ void __launch_bounds__(kThreads)
    tile_percentiles_short_kernel(const void* __restrict__ tiles, int V,
                                  int k_lo, int k_hi, float frac_lo,
                                  float frac_hi, float* __restrict__ out) {
  using K = Keys<kU16>;
  using Elem = typename K::Elem;
  constexpr int kPasses = K::kBits / 8;
  extern __shared__ __align__(16) unsigned char smem[];  // the row
  __shared__ __align__(16) uint32_t hist[2][kHistWords];
  __shared__ Select s;
  const Elem* row = static_cast<const Elem*>(tiles) +
                    static_cast<long long>(blockIdx.x) * V;
  Elem* staged = reinterpret_cast<Elem*>(
      smem + (reinterpret_cast<uintptr_t>(row) & 15));
  if (threadIdx.x == 0) init_select(s, V, k_lo, k_hi);
  zero(&hist[0][0], 2 * kHistWords);
  __syncthreads();
  Groups g = groups_of(s);
  accumulate<kU16>(row, V, g, K::kBits - 8, 0u, hist[0], staged);
  __syncthreads();
  for (int pass = 0; pass < kPasses; ++pass) {
    const int shift = K::kBits - 8 * (pass + 1);
    uint32_t* h = hist[pass & 1];
    if (pass > 0) {
      accumulate<kU16>(staged, V, g, shift, 0xffffffffu << (shift + 8), h,
                       nullptr);
      __syncthreads();
    }
    select_digits(h, g, s, shift);
    zero(hist[(pass + 1) & 1], kHistWords);  // read last a pass ago
    __syncthreads();
    g = groups_of(s);
  }
  if (threadIdx.x == 0)
    write_out<kU16>(s, frac_lo, frac_hi, out + 2ll * blockIdx.x);
}

// one pass over a long row split in chunks: CTA (chunk, row); the last CTA
// of a row chooses the digits. ghist and counters are this pass's own.
template <bool kU16>
__global__ void __launch_bounds__(kThreads)
    tile_percentiles_long_kernel(const void* __restrict__ tiles, long long V,
                                 int chunk, int n_chunks, int pass, int k_lo,
                                 int k_hi, float frac_lo, float frac_hi,
                                 uint32_t* __restrict__ ghist,
                                 uint32_t* __restrict__ counters,
                                 Select* __restrict__ state,
                                 float* __restrict__ out) {
  using K = Keys<kU16>;
  using Elem = typename K::Elem;
  constexpr int kPasses = K::kBits / 8;
  __shared__ __align__(16) uint32_t hist[kHistWords];
  __shared__ Select s;
  __shared__ bool last;
  const long long row = blockIdx.y;
  const int shift = K::kBits - 8 * (pass + 1);
  const uint32_t hi_mask = pass == 0 ? 0u : (0xffffffffu << (shift + 8));
  if (threadIdx.x == 0) {
    if (pass == 0) init_select(s, V, k_lo, k_hi);
    else s = state[row];
  }
  zero(hist, kHistWords);
  __syncthreads();
  const Groups g = groups_of(s);
  const long long start = static_cast<long long>(blockIdx.x) * chunk;
  const long long n = min(static_cast<long long>(chunk), V - start);
  accumulate<kU16>(static_cast<const Elem*>(tiles) + row * V + start, n, g,
                   shift, hi_mask, hist, nullptr);
  __syncthreads();
  uint32_t* gh = ghist + row * kHistWords;
  for (uint32_t e = threadIdx.x; e < g.n * kBins; e += kThreads)
    if (hist[e]) atomicAdd(&gh[e], hist[e]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&counters[row], 1u) ==
           static_cast<uint32_t>(n_chunks - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (uint32_t e = threadIdx.x; e < g.n * kBins; e += kThreads)
    hist[e] = __ldcg(&gh[e]);
  __syncthreads();
  select_digits(hist, g, s, shift);
  __syncthreads();
  if (threadIdx.x == 0) {
    if (pass == kPasses - 1)
      write_out<kU16>(s, frac_lo, frac_hi, out + 2 * row);
    else
      state[row] = s;
  }
}

// let `kernel` take `bytes` of dynamic shared memory on the current device;
// the attribute is set per device, as the sizes grow (allowed[device])
template <typename Kern>
cudaError_t allow_smem(Kern kernel, int bytes, int* allowed) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool known = device >= 0 && device < kMaxDevices;
  if (known && bytes <= allowed[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && known) allowed[device] = bytes;
  return err;
}

template <bool kU16>
int launch(const void* tiles, int T, int V, int k_lo, int k_hi,
           float frac_lo, float frac_hi, float* out, int chunk, int n_chunks,
           void* scratch, cudaStream_t s) {
  using Elem = typename Keys<kU16>::Elem;
  constexpr int kPasses = Keys<kU16>::kBits / 8;
  if (n_chunks == 1) {
    // the row's bytes, rounded up to 16, plus its offset within 16 bytes;
    // beside them the two histograms and the select state
    const long long bytes =
        (static_cast<long long>(V) * sizeof(Elem) + 15) / 16 * 16 + 16;
    if (bytes + 2 * kHistWords * 4 + 64 > kMaxSmem)
      return static_cast<int>(cudaErrorInvalidValue);
    static int allowed[kMaxDevices] = {};
    const cudaError_t err = allow_smem(tile_percentiles_short_kernel<kU16>,
                                       static_cast<int>(bytes), allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    tile_percentiles_short_kernel<kU16><<<T, kThreads, bytes, s>>>(
        tiles, V, k_lo, k_hi, frac_lo, frac_hi, out);
    return static_cast<int>(cudaGetLastError());
  }
  // scratch: each pass's global histograms of the rows, then each pass's
  // counters, then the rows' states
  uint32_t* ghist = static_cast<uint32_t*>(scratch);
  uint32_t* counters = ghist + static_cast<long long>(kMaxPasses) * T *
                                   kHistWords;
  Select* state = reinterpret_cast<Select*>(
      counters + static_cast<long long>(kMaxPasses) * T);
  for (int r0 = 0; r0 < T; r0 += 65535) {
    const dim3 grid(n_chunks, min(T - r0, 65535));
    for (int pass = 0; pass < kPasses; ++pass) {
      const long long row0 = static_cast<long long>(pass) * T + r0;
      tile_percentiles_long_kernel<kU16><<<grid, kThreads, 0, s>>>(
          static_cast<const Elem*>(tiles) + static_cast<long long>(r0) * V,
          V, chunk, n_chunks, pass, k_lo, k_hi, frac_lo, frac_hi,
          ghist + row0 * kHistWords, counters + row0, state + r0,
          out + 2ll * r0);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}

}  // namespace

// scratch: on the long route (n_chunks > 1), T * (4 * (1024 + 1) + 8)
// zeroed 32-bit words; unused (may be null) on the short route
extern "C" int mm_tile_percentiles(
    const void* tiles, int is_u16, int T, int V, int k_lo, int k_hi,
    float frac_lo, float frac_hi, float* out, int chunk, int n_chunks,
    void* scratch, void* stream) {
  if (T <= 0) return static_cast<int>(cudaGetLastError());
  if (n_chunks < 1 || static_cast<long long>(chunk) * n_chunks < V ||
      (n_chunks > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_u16)
    return launch<true>(tiles, T, V, k_lo, k_hi, frac_lo, frac_hi, out,
                        chunk, n_chunks, scratch, s);
  return launch<false>(tiles, T, V, k_lo, k_hi, frac_lo, frac_hi, out, chunk,
                       n_chunks, scratch, s);
}
