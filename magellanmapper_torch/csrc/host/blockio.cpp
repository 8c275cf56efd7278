// blockio: multithreaded block extraction from memmapped volumes.
//
// Native-runtime replacement for the data path the reference runs through
// an mp.Pool over a memmapped .npy (magmap/cv/chunking.py:143 +
// stack_detect.py:222): worker threads gather overlapping z,y,x blocks
// from a (possibly huge, page-faulting) source volume and cast them into
// one contiguous float32 batch buffer ready for device transfer. Page
// faults overlap across threads, which is where the win over a single
// Python loop comes from.
//
// The port builds this file with g++ at first use and loads it with
// ctypes (io/_blockio.py). ABI: plain C.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct CopyJob {
    const uint8_t* src;      // source volume base
    int dtype;               // 0=u8 1=u16 2=i16 3=u32 4=i32 5=f32 6=f64
    int64_t sz, sy, sx;      // source shape
    int64_t stz, sty, stx;   // source strides (bytes)
    const int64_t* starts;   // n_blocks x 3 window starts (clamped)
    int64_t bz, by, bx;      // block shape
    float* out;              // n_blocks * bz*by*bx
    int64_t n_blocks;
};

template <typename T>
inline void copy_row(float* dst, const uint8_t* src, int64_t n,
                     int64_t stride) {
    if (stride == static_cast<int64_t>(sizeof(T))) {
        const T* s = reinterpret_cast<const T*>(src);
        for (int64_t i = 0; i < n; ++i) dst[i] = static_cast<float>(s[i]);
    } else {
        for (int64_t i = 0; i < n; ++i) {
            dst[i] = static_cast<float>(
                *reinterpret_cast<const T*>(src + i * stride));
        }
    }
}

void copy_block(const CopyJob& job, int64_t bi) {
    const int64_t* st = job.starts + bi * 3;
    float* out = job.out + bi * job.bz * job.by * job.bx;
    for (int64_t z = 0; z < job.bz; ++z) {
        const uint8_t* zbase = job.src + (st[0] + z) * job.stz;
        for (int64_t y = 0; y < job.by; ++y) {
            const uint8_t* row = zbase + (st[1] + y) * job.sty
                                 + st[2] * job.stx;
            float* dst = out + (z * job.by + y) * job.bx;
            switch (job.dtype) {
                case 0: copy_row<uint8_t>(dst, row, job.bx, job.stx); break;
                case 1: copy_row<uint16_t>(dst, row, job.bx, job.stx); break;
                case 2: copy_row<int16_t>(dst, row, job.bx, job.stx); break;
                case 3: copy_row<uint32_t>(dst, row, job.bx, job.stx); break;
                case 4: copy_row<int32_t>(dst, row, job.bx, job.stx); break;
                case 5: copy_row<float>(dst, row, job.bx, job.stx); break;
                case 6: copy_row<double>(dst, row, job.bx, job.stx); break;
            }
        }
    }
}

}  // namespace

extern "C" {

// Extract n_blocks blocks of shape (bz,by,bx) from a strided source
// volume into a contiguous float32 buffer, using n_threads workers.
// starts must be pre-clamped so every window fits inside the volume.
// Returns 0 on success.
int blockio_extract(
        const void* src, int dtype,
        int64_t sz, int64_t sy, int64_t sx,
        int64_t stz, int64_t sty, int64_t stx,
        const int64_t* starts, int64_t n_blocks,
        int64_t bz, int64_t by, int64_t bx,
        float* out, int n_threads) {
    if (dtype < 0 || dtype > 6 || n_blocks < 0) return 1;
    CopyJob job{static_cast<const uint8_t*>(src), dtype,
                sz, sy, sx, stz, sty, stx,
                starts, bz, by, bx, out, n_blocks};
    if (n_threads <= 1 || n_blocks <= 1) {
        for (int64_t i = 0; i < n_blocks; ++i) copy_block(job, i);
        return 0;
    }
    std::atomic<int64_t> next(0);
    auto worker = [&]() {
        while (true) {
            int64_t i = next.fetch_add(1);
            if (i >= n_blocks) break;
            copy_block(job, i);
        }
    };
    std::vector<std::thread> threads;
    int nt = std::min<int64_t>(n_threads, n_blocks);
    threads.reserve(nt);
    for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
    return 0;
}

}  // extern "C"
