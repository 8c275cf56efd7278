// K4: exact per-row percentiles of a (T, V) tile matrix.
//
// Replaces the TPU kernel tile_percentiles_pallas / _tile_pct_kernel
// (magellanmapper_tpu/ops/pallas_kernels.py:205-336), which bisected in
// value domain (uint16) or on float-bit keys (f32) with a static iteration
// count, one full count pass per step. For each row this kernel finds the
// exact k-th and (k+1)-th order statistics of both ranks by radix select:
// 8-bit digits from the top, one shared-memory histogram per wanted rank,
// so 2 passes over a uint16 row and 4 over an f32 row. Keys are the raw
// uint16 values, or the bit patterns of f32 values >= 0 (bit order equals
// value order there; the same contract as the TPU kernel). The result is
// np.percentile's linear interpolation, v0 + frac * (v1 - v0), rounded
// step by step as the reference does it (__f*_rn, no contraction).
//
// Bound on the card: one CTA per tile row reads the row once per pass
// (31 KB for a 25^3 uint16 tile, served from L2 after the first pass) and
// issues one shared-memory atomic per element and histogram. Image tiles
// concentrate in few high-byte bins, so the first pass is bound by atomic
// conflicts on those bins; the rows of a block (252 tiles of 25^3) spread
// over the SMs in two waves.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 256;
constexpr int kRanks = 4;  // k_lo, k_lo + 1, k_hi, k_hi + 1

template <bool kU16>
__device__ __forceinline__ uint32_t load_key(const void* tiles,
                                             long long off) {
  if (kU16) return static_cast<const uint16_t*>(tiles)[off];
  return __float_as_uint(static_cast<const float*>(tiles)[off]);
}

template <bool kU16>
__device__ __forceinline__ float key_value(uint32_t key) {
  if (kU16) return static_cast<float>(key);
  return __uint_as_float(key);
}

__device__ __forceinline__ float interpolate(float v0, float v1,
                                             float frac) {
  if (!(frac > 0.0f)) return v0;
  return __fadd_rn(v0, __fmul_rn(frac, __fsub_rn(v1, v0)));
}

template <bool kU16>
__global__ void tile_percentiles_kernel(
    const void* __restrict__ tiles, int V, int k_lo, int k_hi,
    float frac_lo, float frac_hi, float* __restrict__ out) {
  constexpr int kPasses = kU16 ? 2 : 4;
  __shared__ unsigned int hist[kRanks][kBins];
  __shared__ uint32_t prefix[kRanks];
  __shared__ unsigned int rank[kRanks];
  const long long row = static_cast<long long>(blockIdx.x) * V;
  if (threadIdx.x < kRanks) {
    const int k = (threadIdx.x < 2) ? k_lo : k_hi;
    rank[threadIdx.x] =
        static_cast<unsigned int>(min(k + static_cast<int>(threadIdx.x & 1),
                                      V));
    prefix[threadIdx.x] = 0u;
  }
  for (int pass = kPasses - 1; pass >= 0; --pass) {
    const int shift = 8 * pass;
    // the top pass has no prefix yet: one histogram serves every rank
    const bool top = pass == kPasses - 1;
    const int n_hist = top ? 1 : kRanks;
    const uint32_t hi_mask = top ? 0u : (0xffffffffu << (shift + 8));
    for (int b = threadIdx.x; b < kRanks * kBins; b += blockDim.x)
      (&hist[0][0])[b] = 0u;
    __syncthreads();
    for (int e = threadIdx.x; e < V; e += blockDim.x) {
      const uint32_t key = load_key<kU16>(tiles, row + e);
      const uint32_t digit = (key >> shift) & 0xffu;
      for (int r = 0; r < n_hist; ++r) {
        if ((key & hi_mask) == (prefix[r] & hi_mask))
          atomicAdd(&hist[r][digit], 1u);
      }
    }
    __syncthreads();
    if (threadIdx.x < kRanks) {
      const unsigned int* h = hist[top ? 0 : threadIdx.x];
      unsigned int want = rank[threadIdx.x];
      unsigned int below = 0u;
      for (int d = 0; d < kBins; ++d) {
        if (below + h[d] >= want) {
          prefix[threadIdx.x] |= static_cast<uint32_t>(d) << shift;
          rank[threadIdx.x] = want - below;
          break;
        }
        below += h[d];
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float lo0 = key_value<kU16>(prefix[0]);
    const float lo1 = key_value<kU16>(prefix[1]);
    const float hi0 = key_value<kU16>(prefix[2]);
    const float hi1 = key_value<kU16>(prefix[3]);
    out[2 * blockIdx.x] = interpolate(lo0, lo1, frac_lo);
    out[2 * blockIdx.x + 1] = interpolate(hi0, hi1, frac_hi);
  }
}

}  // namespace

extern "C" int mm_tile_percentiles(
    const void* tiles, int is_u16, int T, int V, int k_lo, int k_hi,
    float frac_lo, float frac_hi, float* out, void* stream) {
  if (T <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_u16) {
    tile_percentiles_kernel<true><<<T, kThreads, 0, s>>>(
        tiles, V, k_lo, k_hi, frac_lo, frac_hi, out);
  } else {
    tile_percentiles_kernel<false><<<T, kThreads, 0, s>>>(
        tiles, V, k_lo, k_hi, frac_lo, frac_hi, out);
  }
  return static_cast<int>(cudaGetLastError());
}
