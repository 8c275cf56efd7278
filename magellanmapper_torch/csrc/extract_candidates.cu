// K2: per-row top-8 values and lanes of a (R, 128) float32 array.
//
// Replaces the TPU kernel extract_candidates_pallas / _extract_kernel
// (magellanmapper_tpu/ops/pallas_kernels.py:145-194). For every 128-lane row
// the result is what 8 rounds of masked argmax give: round r takes the
// largest value of the row and its lane, the lower lane on equal values,
// then sets that lane to -inf. Once only -inf is left, each round returns
// (-inf, lane 0), as argmax does over an all -inf row. The input holds no
// NaN (it is a masked LoG response of finite data); +inf is ordered as the
// largest value, as argmax orders it.
//
// Bound on the card: one read of the rows (512 bytes each) and a write of
// 64 bytes per row, so device-memory bandwidth: a (1,310,720, 128) peak
// field is 671 MB. The TPU kernel held 512-row tiles in VMEM; here one
// warp owns one row, each lane loads one float4 (the row is 512
// contiguous bytes, one coalesced load per warp), and the 8 rounds run in
// registers: a per-lane best over its 4 values, then a butterfly of
// __shfl_xor_sync that keeps the larger value and, on equal values, the
// lower lane. Most rows of a peak field hold no peak at all; a ballot finds
// them and the warp writes the all -inf answer without the rounds.

#include <cuda_runtime.h>

namespace {

constexpr int kRounds = 8;
constexpr int kWarps = 8;  // rows per block of 256 threads

__global__ void extract_candidates_kernel(
    const float4* __restrict__ rows, long long R, float* __restrict__ out_v,
    int* __restrict__ out_l) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= R) return;  // the whole warp leaves together
  const float4 q = rows[row * 32 + lane];
  float v[4] = {q.x, q.y, q.z, q.w};
  const float kNegInf = -__int_as_float(0x7f800000);
  float my_v = kNegInf;
  int my_l = 0;
  const bool any = v[0] > kNegInf || v[1] > kNegInf || v[2] > kNegInf ||
                   v[3] > kNegInf;
  if (__ballot_sync(0xffffffffu, any) != 0u) {
    for (int r = 0; r < kRounds; ++r) {
      // this lane's best of its 4 values, the lower lane on equal values
      float bv = v[0];
      int bl = lane * 4;
#pragma unroll
      for (int j = 1; j < 4; ++j) {
        if (v[j] > bv) {
          bv = v[j];
          bl = lane * 4 + j;
        }
      }
      // warp-wide best; every lane ends with the same (value, lane)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int ol = __shfl_xor_sync(0xffffffffu, bl, off);
        if (ov > bv || (ov == bv && ol < bl)) {
          bv = ov;
          bl = ol;
        }
      }
      if (lane == r) {
        my_v = bv;
        my_l = bl;
      }
      if ((bl >> 2) == lane) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if ((bl & 3) == j) v[j] = kNegInf;
        }
      }
    }
  }
  // lanes 0..7 hold rounds 0..7: one 32-byte store per output row
  if (lane < kRounds) {
    out_v[row * kRounds + lane] = my_v;
    out_l[row * kRounds + lane] = my_l;
  }
}

}  // namespace

extern "C" int mm_extract_candidates(const float* rows, long long R,
                                     float* out_v, int* out_l,
                                     void* stream) {
  if (R <= 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = (R + kWarps - 1) / kWarps;
  extract_candidates_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(rows), R, out_v, out_l);
  return static_cast<int>(cudaGetLastError());
}
