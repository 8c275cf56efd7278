// K3: sphere-overlap pruning of a fixed-capacity blob buffer.
//
// Replaces the TPU kernel prune_overlap_pallas / _prune_kernel
// (magellanmapper_tpu/ops/pallas_kernels.py:32-133). Row i of K blobs
// loses when some other valid blob j overlaps it by more than the
// threshold (lens volume over the smaller sphere, radius sigma*sqrt(ndim))
// and j wins: r_j > r_i, or r_j == r_i and i < j. The result is the new
// validity mask. The mask must equal the plain version's bit for bit, so
// the arithmetic follows the jnp reference (ops/peaks.py:228-245,315-329):
// coordinate differences, not the matmul identity of the Pallas body, the
// same operation order, and no FMA contraction (the library is compiled
// with -fmad=false; no fast-math).
//
// Bound on the card: one overlap test per unordered pair of valid blobs
// (the win rule sends each pair to its loser's row only), ~40 float32
// operations each with a square root and a division, over 67 TFLOP/s:
// 4.5 us for 3,891 crowded valid blobs, below a launch's latency for a
// block's own ~10^2 peaks. With one thread a row and 128 rows a CTA, a
// block's peaks (a prefix of ~10^2 valid rows of 4096) would run on one to
// three CTAs walking every column tile. This design spreads the pairs over
// the card in two launches on one stream, with no host sync:
//
// 1. compact: one CTA scans the mask and writes the valid rows, in order,
//    as (z, y, x, radius) float4s, their original indices and their
//    count; every output row starts invalid. Order is kept, so the tie
//    rule's i < j is the compacted a < b.
// 2. pairs: one warp per valid row (warps stride over rows, so any count
//    fits the fixed grid); its lanes stride the valid columns 32 at a time,
//    a lane tests its column only when the column wins, and __any_sync
//    ends the row as soon as one lane finds a winner that overlaps it.

#include <cuda_runtime.h>

namespace {

constexpr int kCompactThreads = 1024;
constexpr int kPairThreads = 256;
constexpr int kWarpsPerCta = kPairThreads / 32;

// Same values, bit for bit, as the jnp reference's overlap fraction: the
// two early returns are its two final selects, in the same precedence (a
// NaN distance fails both and takes the lens formula, as there).
__device__ __forceinline__ float overlap_fraction(float d, float r1,
                                                  float r2) {
  const float kPi = static_cast<float>(3.141592653589793);
  const float kSphere = static_cast<float>(4.0 / 3.0 * 3.141592653589793);
  const float kTiny = static_cast<float>(1e-12);
  const float rsum = r1 + r2;
  if (d >= rsum) return 0.0f;
  const float rdiff = r1 - r2;
  if (d <= fabsf(rdiff)) return 1.0f;
  const float rmin = fminf(r1, r2);
  const float d_safe = fmaxf(d, kTiny);
  const float a = rsum - d_safe;
  const float b = d_safe * d_safe + 2.0f * d_safe * rsum
                  - 3.0f * (rdiff * rdiff);
  const float lens = kPi * (a * a) * b / (12.0f * d_safe);
  const float vol_min = kSphere * (rmin * (rmin * rmin));
  return lens / fmaxf(vol_min, kTiny);
}

__global__ void __launch_bounds__(kCompactThreads) compact_kernel(
    const float* __restrict__ coords, const float* __restrict__ sigmas,
    const unsigned char* __restrict__ valid, int K, float sqrt_ndim,
    float4* __restrict__ rows, int* __restrict__ orig,
    int* __restrict__ n_valid, unsigned char* __restrict__ out) {
  __shared__ int warp_sums[kCompactThreads / 32];
  const int per = (K + kCompactThreads - 1) / kCompactThreads;
  const int lo = min(K, threadIdx.x * per);
  const int hi = min(K, lo + per);
  int n = 0;
  for (int i = lo; i < hi; ++i) n += valid[i] != 0;
  // exclusive scan of the per-thread counts over the block
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = n;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += up;
    }
    warp_sums[lane] = w;            // inclusive sums of the warps
  }
  __syncthreads();
  int pos = incl - n + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    if (valid[i] != 0) {
      rows[pos] = make_float4(coords[3 * i], coords[3 * i + 1],
                              coords[3 * i + 2], sigmas[i] * sqrt_ndim);
      orig[pos] = i;
      ++pos;
    }
    out[i] = 0;
  }
  if (threadIdx.x == 0) *n_valid = warp_sums[kCompactThreads / 32 - 1];
}

__global__ void __launch_bounds__(kPairThreads) pairs_kernel(
    const float4* __restrict__ rows, const int* __restrict__ orig,
    const int* __restrict__ n_valid, float thresh,
    unsigned char* __restrict__ out) {
  const int n = *n_valid;
  const int lane = threadIdx.x & 31;
  const int n_warps = gridDim.x * kWarpsPerCta;
  for (int a = blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5); a < n;
       a += n_warps) {
    const float4 ri = rows[a];
    bool lost = false;
    for (int b0 = 0; b0 < n && !lost; b0 += 32) {
      const int b = b0 + lane;
      bool loses = false;
      if (b < n && b != a) {
        const float4 rj = rows[b];
        if (rj.w > ri.w || (rj.w == ri.w && a < b)) {
          const float dz = ri.x - rj.x;
          const float dy = ri.y - rj.y;
          const float dx = ri.z - rj.z;
          const float d = sqrtf((dz * dz + dy * dy) + dx * dx);
          loses = overlap_fraction(d, ri.w, rj.w) > thresh;
        }
      }
      lost = __any_sync(0xffffffffu, loses);
    }
    if (lane == 0) out[orig[a]] = static_cast<unsigned char>(!lost);
  }
}

}  // namespace

extern "C" int mm_prune_overlap(
    const float* coords, const float* sigmas, const unsigned char* valid,
    int K, float sqrt_ndim, float thresh, unsigned char* out, void* scratch,
    void* stream) {
  if (K <= 0) return static_cast<int>(cudaGetLastError());
  // scratch: K float4 rows, K original indices, the valid count
  float4* rows = static_cast<float4*>(scratch);
  int* orig = reinterpret_cast<int*>(rows + K);
  int* n_valid = orig + K;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  compact_kernel<<<1, kCompactThreads, 0, s>>>(
      coords, sigmas, valid, K, sqrt_ndim, rows, orig, n_valid, out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // a warp per row; at most a full wave of CTAs, the warps stride beyond
  static int max_ctas = 0;
  if (max_ctas == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pairs_kernel,
                                                  kPairThreads, 0);
    max_ctas = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  const int ctas = min((K + kWarpsPerCta - 1) / kWarpsPerCta, max_ctas);
  pairs_kernel<<<ctas, kPairThreads, 0, s>>>(rows, orig, n_valid, thresh,
                                            out);
  return static_cast<int>(cudaGetLastError());
}
