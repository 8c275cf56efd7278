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
// Bound on the card: K^2 pair tests of ~30 flops, a division and a square
// root each (K = 4096 on the block path), with K*20 bytes of input. One
// thread owns one row and walks column tiles staged in shared memory; it
// stops testing once its row has lost, a block leaves when none of its
// rows is still in play, and column tiles without a valid blob are
// skipped, so rows and columns past the last valid one cost only a load.
// That replaces the 1024-row tier of the TPU dispatcher.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;

__device__ __forceinline__ float overlap_fraction(float d, float r1,
                                                  float r2) {
  const float kPi = static_cast<float>(3.141592653589793);
  const float kSphere = static_cast<float>(4.0 / 3.0 * 3.141592653589793);
  const float kTiny = static_cast<float>(1e-12);
  const float rmin = fminf(r1, r2);
  const float d_safe = fmaxf(d, kTiny);
  const float rsum = r1 + r2;
  const float a = rsum - d_safe;
  const float rdiff = r1 - r2;
  const float b = d_safe * d_safe + 2.0f * d_safe * rsum
                  - 3.0f * (rdiff * rdiff);
  const float lens = kPi * (a * a) * b / (12.0f * d_safe);
  const float vol_min = kSphere * (rmin * (rmin * rmin));
  float frac = lens / fmaxf(vol_min, kTiny);
  if (d <= fabsf(rdiff)) frac = 1.0f;
  if (d >= rsum) frac = 0.0f;
  return frac;
}

__global__ void prune_overlap_kernel(
    const float* __restrict__ coords, const float* __restrict__ sigmas,
    const unsigned char* __restrict__ valid, int K, float sqrt_ndim,
    float thresh, unsigned char* __restrict__ out) {
  __shared__ float s_z[kTile], s_y[kTile], s_x[kTile], s_r[kTile];
  __shared__ unsigned char s_v[kTile];
  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool vi = i < K && valid[i] != 0;
  float zi = 0.f, yi = 0.f, xi = 0.f, ri = 0.f;
  if (vi) {
    zi = coords[3 * i];
    yi = coords[3 * i + 1];
    xi = coords[3 * i + 2];
    ri = sigmas[i] * sqrt_ndim;
  }
  bool alive = vi;
  if (__syncthreads_or(alive)) {
    for (int j0 = 0; j0 < K; j0 += kTile) {
      const int j = j0 + threadIdx.x;
      const bool vj = j < K && valid[j] != 0;
      if (vj) {
        s_z[threadIdx.x] = coords[3 * j];
        s_y[threadIdx.x] = coords[3 * j + 1];
        s_x[threadIdx.x] = coords[3 * j + 2];
        s_r[threadIdx.x] = sigmas[j] * sqrt_ndim;
      }
      s_v[threadIdx.x] = vj;
      if (__syncthreads_or(vj) && alive) {
        const int jn = min(kTile, K - j0);
        for (int jj = 0; jj < jn; ++jj) {
          if (!s_v[jj]) continue;
          const int jg = j0 + jj;
          if (jg == i) continue;
          const float rj = s_r[jj];
          if (!(rj > ri || (rj == ri && i < jg))) continue;
          const float dz = zi - s_z[jj];
          const float dy = yi - s_y[jj];
          const float dx = xi - s_x[jj];
          const float d = sqrtf((dz * dz + dy * dy) + dx * dx);
          if (overlap_fraction(d, ri, rj) > thresh) {
            alive = false;
            break;
          }
        }
      }
      // barrier before the next tile overwrites shared memory; leave when
      // every row of the block is settled
      if (!__syncthreads_or(alive)) break;
    }
  }
  if (i < K) out[i] = static_cast<unsigned char>(vi && alive);
}

}  // namespace

extern "C" int mm_prune_overlap(
    const float* coords, const float* sigmas, const unsigned char* valid,
    int K, float sqrt_ndim, float thresh, unsigned char* out,
    void* stream) {
  if (K <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned blocks = static_cast<unsigned>((K + kTile - 1) / kTile);
  prune_overlap_kernel<<<blocks, kTile, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      coords, sigmas, valid, K, sqrt_ndim, thresh, out);
  return static_cast<int>(cudaGetLastError());
}
