// K1: fused 3^4 local-maximum test and peak compaction over a LoG cube.
//
// Replaces the TPU kernel peak_candidates_pallas / _peak_harvest_kernel /
// _kernel_max3_planes (magellanmapper_tpu/ops/pallas_kernels.py:351-537).
// That kernel streamed plane pairs through VMEM, kept a ring of per-plane
// (s, y, x) maxima, and harvested at most 8 candidates per 128-lane group
// because the TPU has no scatter. Here every thread tests one voxel and
// the peaks of a warp are compacted with one ballot and one atomicAdd, so
// every peak is returned, with no per-group cap.
//
// Semantics (ops/peaks.py:24-48,105-106 of the TPU package): a voxel is a
// peak when its value is above the positive threshold and not below any of
// its 80 neighbours over (s, z, y, x). Out-of-range neighbours count as 0
// (reduce_window's init), which only matters through v >= 0 and is implied
// by v > threshold > 0; the wrapper rejects threshold <= 0. A NaN centre or
// neighbour makes the test false, as ``cube == max_filter`` does.
//
// Bound on the card: one read of the cube (S*Z*Y*X*4 bytes, 102 MB for a
// (10, 156, 128, 128) block), so device-memory bandwidth. Only voxels above
// the threshold (a few percent of a LoG cube) load their neighbours, which
// then mostly hit L1/L2. The output is a (value, flat index) list in
// arbitrary order plus an uncapped count; the wrapper selects and orders.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void peak_candidates_kernel(
    const float* __restrict__ cube, int S, int Z, int Y, int X,
    float thresh, float* __restrict__ vals, int* __restrict__ idx,
    int* __restrict__ count, int buf_cap) {
  const long long n = static_cast<long long>(S) * Z * Y * X;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  bool peak = false;
  float v = 0.f;
  if (i < n) {
    v = cube[i];
    if (v > thresh) {
      int x = static_cast<int>(i % X);
      long long t = i / X;
      int y = static_cast<int>(t % Y);
      t /= Y;
      int z = static_cast<int>(t % Z);
      int s = static_cast<int>(t / Z);
      peak = true;
      for (int ds = -1; ds <= 1 && peak; ++ds) {
        int ss = s + ds;
        if (ss < 0 || ss >= S) continue;
        for (int dz = -1; dz <= 1 && peak; ++dz) {
          int zz = z + dz;
          if (zz < 0 || zz >= Z) continue;
          for (int dy = -1; dy <= 1 && peak; ++dy) {
            int yy = y + dy;
            if (yy < 0 || yy >= Y) continue;
            const float* row =
                cube + ((static_cast<long long>(ss) * Z + zz) * Y + yy) * X;
            for (int dx = -1; dx <= 1; ++dx) {
              int xx = x + dx;
              if (xx < 0 || xx >= X) continue;
              if (ds == 0 && dz == 0 && dy == 0 && dx == 0) continue;
              if (!(v >= row[xx])) {
                peak = false;
                break;
              }
            }
          }
        }
      }
    }
  }
  // every lane of the warp reaches the ballot: no early return above
  const unsigned mask = __ballot_sync(0xffffffffu, peak);
  if (mask == 0u) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(mask) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(count, __popc(mask));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (peak) {
    const int slot = base + __popc(mask & ((1u << lane) - 1u));
    if (slot < buf_cap) {
      vals[slot] = v;
      idx[slot] = static_cast<int>(i);
    }
  }
}

}  // namespace

extern "C" int mm_peak_candidates(
    const float* cube, int S, int Z, int Y, int X, float thresh,
    float* vals, int* idx, int* count, int buf_cap, void* stream) {
  const long long n = static_cast<long long>(S) * Z * Y * X;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned blocks =
      static_cast<unsigned>((n + kThreads - 1) / kThreads);
  peak_candidates_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      cube, S, Z, Y, X, thresh, vals, idx, count, buf_cap);
  return static_cast<int>(cudaGetLastError());
}
