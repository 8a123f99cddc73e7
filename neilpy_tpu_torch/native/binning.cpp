// Native host-side point binning for neilpy_tpu_torch.
//
// The exact gridding path needs float64 bin indices (UTM coordinates
// do not survive f32), which numpy computes at a few Mpts/s across
// ~10 temporaries.  This kernel does the whole inverse-affine floor
// binning (plus validity masking) in one multithreaded pass with no
// temporaries: x,y (f64) -> flat int32 bin index + valid mask.
//
// Built at first use by neilpy_tpu_torch/_host_build.py (g++).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

// Runtime ISA dispatch (GCC function multiversioning): the binary
// stays portable (baseline x86-64 clone) while AVX2/AVX-512 hosts get
// wide-vector clones resolved once at load time.  This recovers the
// throughput a -march=native build had, without shipping arch-specific
// code.
#if defined(__x86_64__) && defined(__GNUC__)
#define NEILPY_CLONES \
    __attribute__((target_clones("default", "avx2", "avx512f")))
#else
#define NEILPY_CLONES
#endif

NEILPY_CLONES
static long bin_range_f64(const double* x, const double* y,
                          long lo, long hi, double x0, double y0,
                          double inv, double cmax, double rmax,
                          long ny, long nx,
                          int32_t* flat, uint8_t* valid) {
    long cnt = 0;
    for (long i = lo; i < hi; ++i) {
        double c = std::floor((x[i] - x0) * inv);
        double r = std::floor((y0 - y[i]) * inv);
        bool ok = (c >= 0.0) && (c < static_cast<double>(nx)) &&
                  (r >= 0.0) && (r < static_cast<double>(ny));
        double ccl = c < 0.0 ? 0.0 : (c > cmax ? cmax : c);
        double rcl = r < 0.0 ? 0.0 : (r > rmax ? rmax : r);
        flat[i] = static_cast<int32_t>(rcl) * static_cast<int32_t>(nx) +
                  static_cast<int32_t>(ccl);
        valid[i] = ok ? 1 : 0;
        cnt += ok;
    }
    return cnt;
}

NEILPY_CLONES
static void origin_shift_range(const double* x, const double* y,
                               long lo, long hi, double x0, double y0,
                               float* xr, float* yr) {
    for (long i = lo; i < hi; ++i) {
        xr[i] = static_cast<float>(x[i] - x0);
        yr[i] = static_cast<float>(y0 - y[i]);
    }
}

extern "C" {

// Bin n points into an ny x nx grid anchored at (x0, y0) with cell
// size cs (north-up: rows grow as y decreases).  Writes flat[i] and
// valid[i]; out-of-grid points get valid = 0 and — matching the numpy
// path in ops/pointgrid.py (clip before ravel) — a flat index clipped
// into [0, ny*nx), so both backends agree on every output value and
// indexing flat is always in-bounds even without masking.
// Returns the number of valid points.
long bin_points_f64(const double* x, const double* y, long n,
                    double x0, double y0, double cs,
                    long ny, long nx,
                    int32_t* flat, uint8_t* valid) {
    unsigned hw = std::thread::hardware_concurrency();
    unsigned nt = hw ? (hw > 16 ? 16 : hw) : 4;
    if (n < 100000) nt = 1;
    std::atomic<long> total{0};
    const double inv = 1.0 / cs;
    const double cmax = static_cast<double>(nx - 1);
    const double rmax = static_cast<double>(ny - 1);

    auto work = [&](long lo, long hi) {
        total += bin_range_f64(x, y, lo, hi, x0, y0, inv, cmax, rmax,
                               ny, nx, flat, valid);
    };

    if (nt == 1) {
        work(0, n);
    } else {
        std::vector<std::thread> threads;
        long chunk = (n + nt - 1) / nt;
        for (unsigned t = 0; t < nt; ++t) {
            long lo = static_cast<long>(t) * chunk;
            long hi = lo + chunk < n ? lo + chunk : n;
            if (lo >= hi) break;
            threads.emplace_back(work, lo, hi);
        }
        for (auto& th : threads) th.join();
    }
    return total.load();
}

// Origin-shift for the device fast path: xr = (x - x0) and
// yr = (y0 - y) computed in f64 and rounded once to f32, across
// hardware threads.  This is the only host leg of the fused
// on-device binning (ops/pointgrid.py bin_points_device).
void origin_shift_f64(const double* x, const double* y, long n,
                      double x0, double y0,
                      float* xr, float* yr) {
    unsigned hw = std::thread::hardware_concurrency();
    unsigned nt = hw ? (hw > 16 ? 16 : hw) : 4;
    if (n < 100000) nt = 1;
    auto work = [&](long lo, long hi) {
        origin_shift_range(x, y, lo, hi, x0, y0, xr, yr);
    };
    if (nt == 1) {
        work(0, n);
    } else {
        std::vector<std::thread> threads;
        long chunk = (n + nt - 1) / nt;
        for (unsigned t = 0; t < nt; ++t) {
            long lo = static_cast<long>(t) * chunk;
            long hi = lo + chunk < n ? lo + chunk : n;
            if (lo >= hi) break;
            threads.emplace_back(work, lo, hi);
        }
        for (auto& th : threads) th.join();
    }
}

// Fused bin + segment-min/max on host (f64 exact): the full
// create_dem reduction for workflows that never leave the host.
// grid must be pre-filled with +inf (minimize=1) or -inf (0).
void bin_reduce_f64(const double* x, const double* y, const double* z,
                    long n, double x0, double y0, double cs,
                    long ny, long nx, int minimize, double* grid) {
    const double inv = 1.0 / cs;
    // single-threaded: the reduction races otherwise; still one pass
    for (long i = 0; i < n; ++i) {
        double c = std::floor((x[i] - x0) * inv);
        double r = std::floor((y0 - y[i]) * inv);
        if (c < 0.0 || c >= static_cast<double>(nx) || r < 0.0 ||
            r >= static_cast<double>(ny))
            continue;
        long k = static_cast<long>(r) * nx + static_cast<long>(c);
        double v = z[i];
        if (minimize ? (v < grid[k]) : (v > grid[k])) grid[k] = v;
    }
}

}  // extern "C"
