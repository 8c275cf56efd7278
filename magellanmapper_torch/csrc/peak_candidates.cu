// K1: fused 3^4 local-maximum test and peak compaction over a LoG cube.
//
// Replaces the TPU kernel peak_candidates_pallas / _peak_harvest_kernel /
// _kernel_max3_planes (magellanmapper_tpu/ops/pallas_kernels.py:351-537).
// That kernel streamed plane pairs through VMEM, kept a ring of per-plane
// (s, y, x) maxima, and harvested at most 8 candidates per 128-lane group
// because the TPU has no scatter. Here every peak is returned, with no
// per-group cap, in arbitrary order plus an exact count; the wrapper
// selects and orders.
//
// Semantics (ops/peaks.py:24-48,105-106 of the TPU package): a voxel is a
// peak when its value is above the positive threshold and equal to the
// maximum of its 3^4 window over (s, z, y, x), with out-of-range voxels
// counted as 0 (reduce_window's init; the wrapper rejects threshold <= 0,
// so a peak is never below that border). A NaN centre or neighbour makes
// the test false, as ``cube == max_filter`` does: the maxima propagate NaN
// (max.NaN), where fmaxf would drop it.
//
// Bound on the card: one read of the cube (S*Z*Y*X*4 bytes, 102 MB for a
// (10, 156, 128, 128) block) over device-memory bandwidth. With one thread
// per voxel, every voxel above the threshold (12% of a block's LoG cube)
// would walk its 80 neighbours with dependent scalar loads, and a warp
// would wait for its slowest lane. This design streams the cube once,
// independent of the data (the halos make it read ~1.5x the cube):
//
// - A CTA owns all scales of an s-chunk (up to kSc), a z-chunk, and a
//   (kTy, kTx) = (16, 32) y/x tile, and walks the z-chunk plane by plane.
//   One thread loads each plane into shared memory with one TMA copy of a
//   4D box (40 x 18 x 1 x S floats: the tile, its one-voxel halo, and
//   enough columns that the box's x start lies on 16 bytes, which TMA
//   requires; a box at x = -1 faults on the card). TMA fills what lies
//   outside the cube with 0, exactly the constant-0 border; the border
//   scales and planes outside the cube are zeroed by the threads. An
//   mbarrier per buffer reports a box's arrival; three buffers keep two
//   planes in flight while one is computed, and no thread spends
//   instructions on addresses. Where rows are not 16-byte aligned (X % 4
//   != 0), or the box would not fit (X < 40, Y < 18, S > kSc), every
//   voxel takes a 4-byte cp.async copy instead.
// - Separable maxima: a thread owns one x column and two y rows of the
//   tile. Per staged scale it takes the 3x3 (y, x) maximum from shared
//   memory (12 loads for its 2 rows), slides a 3-scale window over them in
//   registers for the (s, y, x) maximum P of the plane, and folds z through
//   a ring held in registers, as the TPU kernel's rolling ring did:
//   max81(z) = max(Q, P(z+1)) with Q = max(P(z-1), P(z)).
// - Compaction: a thread's peaks of one plane are a bit mask; a warp that
//   has any takes one inclusive scan and one atomicAdd, and each peak's
//   value is read back from the cube (a rare, cached load). All index math
//   is int32 (the wrapper rejects cubes of 2^31 voxels or more); the
//   indices are written as int64, as the caller takes them.

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda link)
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTx = 32;                        // x columns per tile (lanes)
constexpr int kTy = 16;                        // y rows per tile
constexpr int kThreads = kTx * kTy / 2;        // 256: two rows a thread
constexpr int kSc = 10;                        // scales per s-chunk
constexpr int kRowsY = kTy + 2;                // staged rows of a scale
constexpr int kPitch = 40;                     // staged columns (160 bytes)
constexpr int kBlock = kRowsY * kPitch;        // floats of one staged scale
constexpr int kStages = 3;                     // plane buffers
constexpr int kMinZChunk = 4;
// an mbarrier wait that never completes traps instead of hanging the card
constexpr long long kSpinLimit = 1LL << 26;

// floats of one plane buffer (sn scales and the two border scales),
// rounded up to 128 bytes so that every buffer keeps its alignment
__host__ __device__ constexpr int plane_floats(int sn) {
  return ((sn + 2) * kBlock + 31) / 32 * 32;
}

// floats before the first buffer: a thread on the cube's low x edge reads
// one float before its staged row (and drops it), and the lead puts scale
// block 1 of every buffer, where the TMA box lands, on a 128-byte boundary
// (kLeadFloats * 4 + kBlock * 4 = 0 mod 128)
constexpr int kLeadFloats = 48;

// 128 bytes of slack to align, the lead, the buffers, an mbarrier each
size_t smem_bytes(int sn) {
  return 128 + kLeadFloats * sizeof(float) +
         kStages * (plane_floats(sn) * sizeof(float) + sizeof(uint64_t));
}

__device__ __forceinline__ float nanmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (long long spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > kSpinLimit) __trap();
  }
}

// Where a CTA's staged plane starts in the cube: column x sits at x - bx
// and row y at y - by. A TMA box's x start must lie on 16 bytes (a box at
// x = -1 faults on the card), so the box starts at bx = max(x0 - 4, 0),
// by = y0 - 1; the 4-byte copies start at (x0 - 1, y0 - 1) and
// zero-fill.
struct Tile {
  int x0, y0, bx, by, z0, z1, s0, sn;
};

// Stage plane z with 4-byte copies: scales [s0 - 1, s0 + sn] into blocks
// 0 .. sn + 1, what lies outside the cube reads 0.
__device__ __forceinline__ void stage_plane_4b(
    float* buf, const float* __restrict__ cube, int S, int Z, int Y, int X,
    const Tile& t, int z) {
  constexpr int kItems = kTx + 2;
  const bool z_in = z >= 0 && z < Z;
  const int nrows = (t.sn + 2) * kRowsY;
  for (int i = threadIdx.x; i < nrows * kItems; i += kThreads) {
    const int row = i / kItems;
    const int c = i - row * kItems;
    const int ss = row / kRowsY;
    const int s = t.s0 - 1 + ss;
    const int y = t.by + (row - ss * kRowsY);
    const int x = t.bx + c;
    const bool ok =
        z_in && s >= 0 && s < S && y >= 0 && y < Y && x >= 0 && x < X;
    cp_async4(buf + row * kPitch + c,
              ok ? cube + ((s * Z + z) * Y + y) * X + x : cube, ok ? 4 : 0);
  }
}

// Load plane p (z = z0 - 1 + p) into buf; one cp.async group per call.
// TMA: one thread copies scales [0, S) as one box into blocks 1 .. S
// (blocks 0 and S + 1, the scale border, were zeroed once); a plane
// outside the cube is all border, zeroed by the threads, no box issued.
template <bool kTma>
__device__ __forceinline__ void load_plane(
    float* buf, int p, int n_planes, const CUtensorMap* map, uint64_t* bar,
    unsigned box_bytes, const float* __restrict__ cube, int S, int Z, int Y,
    int X, const Tile& t, int pf) {
  const int z = t.z0 - 1 + p;
  if (p < n_planes) {
    if (!kTma) {
      stage_plane_4b(buf, cube, S, Z, Y, X, t, z);
    } else if (z < 0 || z >= Z) {
      float4* b4 = reinterpret_cast<float4*>(buf);
      for (int i = threadIdx.x; i < pf / 4; i += kThreads) {
        b4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else if (threadIdx.x == 0) {
      // order earlier generic-proxy writes to buf (zeros) before the
      // copy's async-proxy writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              smem_addr(bar)),
          "r"(box_bytes)
          : "memory");
      asm volatile(
          "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
          "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
              smem_addr(buf + kBlock)),
          "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
          "r"(t.bx), "r"(t.by), "r"(z), "r"(0)
          : "memory");
    }
  }
  cp_async_commit();                         // empty where nothing was copied
}

template <bool kTma>
__global__ void __launch_bounds__(kThreads, 2) peak_candidates_kernel(
    const __grid_constant__ CUtensorMap map, const float* __restrict__ cube,
    int S, int Z, int Y, int X, float thresh, int z_chunk, int tiles_x,
    int sn_box, float* __restrict__ vals, long long* __restrict__ idx,
    int* __restrict__ count, int buf_cap) {
  extern __shared__ unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t{127}) +
      kLeadFloats;
  const int pf = plane_floats(sn_box);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kStages * pf);
  Tile t;
  t.x0 = (blockIdx.x % tiles_x) * kTx;
  t.y0 = (blockIdx.x / tiles_x) * kTy;
  t.bx = kTma ? max(t.x0 - 4, 0) : t.x0 - 1;
  t.by = t.y0 - 1;
  t.z0 = blockIdx.y * z_chunk;
  t.z1 = min(Z, t.z0 + z_chunk);
  t.s0 = blockIdx.z * kSc;
  t.sn = min(kSc, S - t.s0);
  const unsigned box_bytes = S * kBlock * sizeof(float);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int x = t.x0 + lane;
  const int ya = t.y0 + 2 * warp;            // this thread's rows ya, ya + 1
  const bool col_in = x < X;
  const bool in_a = col_in && ya < Y;
  const bool in_b = col_in && ya + 1 < Y;
  // the staged window of this thread: column x - 1 and row ya - 1
  const int col = x - 1 - t.bx;
  const int row0 = ya - 1 - t.by;
  // on the cube's low x edge the box starts at 0 and column -1 is not
  // staged: it reads as the border, 0
  const bool left_out = x == 0;

  if (kTma) {
    for (int b = 0; b < kStages; ++b) {
      float* buf = smem + b * pf;
      for (int i = threadIdx.x; i < kBlock; i += kThreads) {
        buf[i] = 0.f;
        buf[(t.sn + 1) * kBlock + i] = 0.f;
      }
    }
    if (threadIdx.x == 0) {
      for (int b = 0; b < kStages; ++b) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
            smem_addr(&bars[b])));
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
  }
  __syncthreads();

  // z ring per scale and row: Q = max(P(z-1), P(z)), P(z), centre v(z)
  float qa[kSc], qb[kSc], pa[kSc], pb[kSc], va[kSc], vb[kSc];
#pragma unroll
  for (int s = 0; s < kSc; ++s) {
    qa[s] = qb[s] = pa[s] = pb[s] = va[s] = vb[s] = 0.f;
  }

  // planes z0 - 1 .. z1 (p = 0 .. n_planes - 1): each tests the one before
  const int n_planes = t.z1 - t.z0 + 2;
  for (int p = 0; p < 2; ++p) {
    load_plane<kTma>(smem + p * pf, p, n_planes, &map, &bars[p], box_bytes,
                     cube, S, Z, Y, X, t, pf);
  }
  unsigned phases = 0u;                      // bit b: parity of buffer b
  for (int p = 0; p < n_planes; ++p) {
    const int b = p % kStages;
    const int z = t.z0 - 1 + p;
    cp_async_wait_all_but_one();
    if (kTma && z >= 0 && z < Z) {
      mbar_wait(&bars[b], (phases >> b) & 1u);
      phases ^= 1u << b;
    }
    // plane p is visible, and every thread is done with plane p - 1's
    // buffer, which plane p + 2 now fills
    __syncthreads();
    load_plane<kTma>(smem + ((p + 2) % kStages) * pf, p + 2, n_planes, &map,
                     &bars[(p + 2) % kStages], box_bytes, cube, S, Z, Y, X, t,
                     pf);
    const float* buf = smem + b * pf;
    const bool test = p >= 2;                // plane z - 1 is tested
    unsigned mask = 0u;                      // bit 2*s + row: a peak
    float m2a = 0.f, m2b = 0.f, m1a = 0.f, m1b = 0.f;
    float ca = 0.f, cb = 0.f;                // centres of the last scale
#pragma unroll
    for (int ss = 0; ss < kSc + 2; ++ss) {
      if (ss < t.sn + 2) {
        // 3x3 (y, x) maxima of this thread's two rows at staged scale ss
        const float* bp = buf + ss * kBlock + row0 * kPitch + col;
        float r[4], mid[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float* rw = bp + k * kPitch;
          const float left = left_out ? 0.f : rw[0];
          mid[k] = rw[1];
          r[k] = nanmax(nanmax(left, mid[k]), rw[2]);
        }
        const float ma = nanmax(nanmax(r[0], r[1]), r[2]);
        const float mb = nanmax(nanmax(r[1], r[2]), r[3]);
        if (ss >= 2) {
          // scale s = ss - 2 of the chunk: P of this plane, then the z fold
          const int s = ss - 2;
          const float pna = nanmax(nanmax(m2a, m1a), ma);
          const float pnb = nanmax(nanmax(m2b, m1b), mb);
          if (test) {
            const float wa = nanmax(qa[s], pna);
            const float wb = nanmax(qb[s], pnb);
            if (in_a && va[s] > thresh && va[s] == wa) mask |= 1u << (2 * s);
            if (in_b && vb[s] > thresh && vb[s] == wb) {
              mask |= 1u << (2 * s + 1);
            }
          }
          qa[s] = nanmax(pa[s], pna);
          qb[s] = nanmax(pb[s], pnb);
          pa[s] = pna;
          pb[s] = pnb;
          va[s] = ca;                        // centres of scale s, this plane
          vb[s] = cb;
        }
        ca = mid[1];
        cb = mid[2];
        m2a = m1a;
        m2b = m1b;
        m1a = ma;
        m1b = mb;
      }
    }
    // compaction: one scan and one atomicAdd per warp that holds a peak
    const int n = __popc(mask);
    if (__any_sync(0xffffffffu, n != 0)) {
      int incl = n;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += up;
      }
      const int total = __shfl_sync(0xffffffffu, incl, 31);
      int base = 0;
      if (lane == 0) base = atomicAdd(count, total);
      base = __shfl_sync(0xffffffffu, base, 0);
      int slot = base + incl - n;
      while (mask) {
        const int bit = __ffs(mask) - 1;
        mask &= mask - 1u;
        const int s = t.s0 + (bit >> 1);
        const int i = ((s * Z + z - 1) * Y + ya + (bit & 1)) * X + x;
        if (slot < buf_cap) {
          vals[slot] = __ldg(cube + i);
          idx[slot] = i;
        }
        ++slot;
      }
    }
  }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// the driver's tensor-map encoder, through the runtime (no libcuda link);
// null where the driver does not offer it
EncodeTiled encode_tiled() {
  static bool looked = false;
  static EncodeTiled fn = nullptr;
  if (!looked) {
    looked = true;
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
    cudaGetLastError();   // a failed lookup leaves no error behind
  }
  return fn;
}

// CTAs of one kernel variant that fit on the card at once (cached)
template <bool kTma>
int resident_ctas(int device, int sn_box) {
  constexpr int kMaxDevices = 64;
  static int cache[kMaxDevices][kSc + 1] = {};
  if (device < kMaxDevices && cache[device][sn_box]) {
    return cache[device][sn_box];
  }
  cudaFuncSetAttribute(peak_candidates_kernel<kTma>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem_bytes(kSc)));
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, peak_candidates_kernel<kTma>, kThreads, smem_bytes(sn_box));
  const int resident = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  if (device < kMaxDevices) cache[device][sn_box] = resident;
  return resident;
}

}  // namespace

extern "C" int mm_peak_candidates(
    const float* cube, int S, int Z, int Y, int X, float thresh,
    float* vals, long long* idx, int* count, int buf_cap, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (static_cast<long long>(S) * Z * Y * X <= 0) return 0;
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (X + kTx - 1) / kTx;
  const int tiles = tiles_x * ((Y + kTy - 1) / kTy);
  const int s_chunks = (S + kSc - 1) / kSc;
  const int sn_box = S < kSc ? S : kSc;

  // TMA where rows start on 16 bytes (its strides must be multiples of 16)
  // and one box, a plane of all scales (kPitch x kRowsY x 1 x S), fits in
  // the cube; else 4-byte copies
  CUtensorMap map{};
  bool tma = X % 4 == 0 && reinterpret_cast<uintptr_t>(cube) % 16 == 0 &&
             S <= kSc && X >= kPitch && Y >= kRowsY;
  const EncodeTiled encode = tma ? encode_tiled() : nullptr;
  if (encode == nullptr) {
    tma = false;
  } else {
    const cuuint64_t fs = sizeof(float);
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(X),
                                static_cast<cuuint64_t>(Y),
                                static_cast<cuuint64_t>(Z),
                                static_cast<cuuint64_t>(S)};
    const cuuint64_t strides[3] = {dims[0] * fs, dims[0] * dims[1] * fs,
                                   dims[0] * dims[1] * dims[2] * fs};
    const cuuint32_t box[4] = {kPitch, kRowsY, 1,
                               static_cast<cuuint32_t>(S)};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    tma = encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                 const_cast<float*>(cube), dims, strides, box, unit,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  }

  // z-chunks: as many as keep one wave of CTAs resident, at least
  // kMinZChunk planes each (a chunk re-stages two halo planes)
  const int resident = tma ? resident_ctas<true>(device, sn_box)
                           : resident_ctas<false>(device, sn_box);
  int z_chunks = resident / (tiles * s_chunks);
  if (z_chunks < 1) z_chunks = 1;
  int z_chunk = (Z + z_chunks - 1) / z_chunks;
  if (z_chunk < kMinZChunk) z_chunk = kMinZChunk < Z ? kMinZChunk : Z;
  z_chunks = (Z + z_chunk - 1) / z_chunk;
  const dim3 grid(tiles, z_chunks, s_chunks);
  const size_t smem = smem_bytes(sn_box);
  if (tma) {
    peak_candidates_kernel<true><<<grid, kThreads, smem, st>>>(
        map, cube, S, Z, Y, X, thresh, z_chunk, tiles_x, sn_box, vals, idx,
        count, buf_cap);
  } else {
    peak_candidates_kernel<false><<<grid, kThreads, smem, st>>>(
        map, cube, S, Z, Y, X, thresh, z_chunk, tiles_x, sn_box, vals, idx,
        count, buf_cap);
  }
  return static_cast<int>(cudaGetLastError());
}
