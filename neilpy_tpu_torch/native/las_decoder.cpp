// Native LAS point-record decoder for neilpy_tpu_torch.
//
// The Python reader (neilpy_tpu_torch/io/las.py) is zero-copy for the raw
// record view but still pays pandas/numpy costs for scaling and bit
// unpacking, and cannot filter or decimate without materialising the
// whole cloud.  This decoder mmaps the file, parses the header, and
// decodes point records straight into caller-provided flat arrays
// (x/y/z as float64, intensity/class/returns unpacked), applying an
// optional bounding-box filter and stride decimation on the fly, with
// the record range split across hardware threads.
//
// C ABI only (consumed via ctypes from neilpy_tpu_torch.io.las_native):
//   las_open_header(path, out_header) -> 0 on success
//   las_decode(path, stride, bbox_or_null, out arrays..., n_out) -> 0
//
// Layout knowledge matches the ASPRS LAS 1.0-1.4 spec (PDRF 0-10),
// same compositional layout as io/las.py.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Header {
  double scale[3];
  double offset[3];
  double minmax[6];
  uint64_t num_points;
  uint32_t point_offset;
  uint16_t record_len;
  uint8_t pdrf;
  uint8_t version_minor;
  uint8_t version_major;
};

template <typename T>
T rd(const uint8_t* p) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  return v;
}

int parse_header(const uint8_t* data, size_t size, Header* h) {
  if (size < 227 || std::memcmp(data, "LASF", 4) != 0) return -1;
  h->version_major = data[24];
  h->version_minor = data[25];
  h->point_offset = rd<uint32_t>(data + 96);
  h->pdrf = data[104];
  if (h->pdrf >= 128 && h->pdrf <= 133) return -2;  // LAZ
  if (h->pdrf > 10) return -3;
  h->record_len = rd<uint16_t>(data + 105);
  h->num_points = rd<uint32_t>(data + 107);
  for (int i = 0; i < 3; ++i) h->scale[i] = rd<double>(data + 131 + 8 * i);
  for (int i = 0; i < 3; ++i) h->offset[i] = rd<double>(data + 155 + 8 * i);
  for (int i = 0; i < 6; ++i) h->minmax[i] = rd<double>(data + 179 + 8 * i);
  // LAS 1.4: 64-bit point count at offset 247
  if (h->version_major == 1 && h->version_minor >= 4 &&
      rd<uint16_t>(data + 94) >= 375 && h->num_points == 0) {
    h->num_points = rd<uint64_t>(data + 247);
  }
  return 0;
}

struct Mapped {
  const uint8_t* data = nullptr;
  size_t size = 0;
  int fd = -1;
  bool ok() const { return data != nullptr; }
  ~Mapped() {
    if (data) munmap(const_cast<uint8_t*>(data), size);
    if (fd >= 0) close(fd);
  }
};

bool map_file(const char* path, Mapped* m) {
  m->fd = open(path, O_RDONLY);
  if (m->fd < 0) return false;
  struct stat st;
  if (fstat(m->fd, &st) != 0) return false;
  m->size = static_cast<size_t>(st.st_size);
  void* p = mmap(nullptr, m->size, PROT_READ, MAP_PRIVATE, m->fd, 0);
  if (p == MAP_FAILED) return false;
  m->data = static_cast<const uint8_t*>(p);
  return true;
}

}  // namespace

extern "C" {

// Header export layout (must match io/las_native.py): 13 doubles then
// 3 uint64 (num_points, point_offset, record_len) then 2 uint32
// (pdrf, version*10).
int las_open_header(const char* path, double* out) {
  Mapped m;
  if (!map_file(path, &m)) return -10;
  Header h;
  int rc = parse_header(m.data, m.size, &h);
  if (rc != 0) return rc;
  int k = 0;
  for (int i = 0; i < 3; ++i) out[k++] = h.scale[i];
  for (int i = 0; i < 3; ++i) out[k++] = h.offset[i];
  for (int i = 0; i < 6; ++i) out[k++] = h.minmax[i];
  out[k++] = 0.0;  // reserved
  out[k++] = static_cast<double>(h.num_points);
  out[k++] = static_cast<double>(h.point_offset);
  out[k++] = static_cast<double>(h.record_len);
  out[k++] = static_cast<double>(h.pdrf);
  out[k++] = static_cast<double>(h.version_major * 10 + h.version_minor);
  return 0;
}

// Decode records [first, first + count) with stride into flat arrays
// (count < 0 means "to the end of the file") — the streaming core
// behind both the whole-file entry point below and the fixed-memory
// chunk iterator (io/las_native.py read_las_chunks).  bbox = 4
// doubles (xmin, xmax, ymin, ymax) or null.  Returns number of points
// written, or a negative error code.  ``n_cap`` is the caller's
// allocated length for every output array; the decoder never writes
// beyond it, even when the header's point count disagrees with the
// file size.
long las_decode_range(const char* path, long first, long count,
                      long stride, const double* bbox,
                      double* xs, double* ys, double* zs,
                      uint16_t* intensity, uint8_t* klass,
                      uint8_t* return_number, uint8_t* return_max,
                      long n_cap, int n_threads) {
  Mapped m;
  if (!map_file(path, &m)) return -10;
  Header h;
  int rc = parse_header(m.data, m.size, &h);
  if (rc != 0) return rc;
  if (stride < 1) stride = 1;
  if (first < 0) first = 0;

  const size_t rl = h.record_len;
  uint64_t avail = (m.size - h.point_offset) / rl;
  uint64_t n_total = h.num_points
                         ? std::min<uint64_t>(h.num_points, avail)
                         : avail;
  if (static_cast<uint64_t>(first) >= n_total) return 0;
  const uint8_t* pts = m.data + h.point_offset + first * rl;
  uint64_t n = n_total - static_cast<uint64_t>(first);
  if (count >= 0 && static_cast<uint64_t>(count) < n)
    n = static_cast<uint64_t>(count);
  uint64_t n_out_max = (n + stride - 1) / stride;
  if (n_cap >= 0 && n_out_max > static_cast<uint64_t>(n_cap))
    n_out_max = static_cast<uint64_t>(n_cap);

  const bool extended = h.pdrf >= 6;
  // byte offsets inside a record
  const size_t off_xyz = 0;           // 3 x int32
  const size_t off_intensity = 12;    // uint16
  const size_t off_retbyte = 14;      // uint8
  const size_t off_class = extended ? 16 : 15;
  if (rl < off_class + 1) return -4;  // record too short for its PDRF

  if (n_threads < 1)
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
  if (n_threads < 1) n_threads = 1;
  if (static_cast<uint64_t>(n_threads) > n_out_max / 4096 + 1)
    n_threads = static_cast<int>(n_out_max / 4096 + 1);

  // Two-phase when filtering: each thread writes into its slot range
  // at the decimated index, then we compact.  Validity recorded in
  // return_number's high bit is avoided — use a flag buffer.
  std::vector<uint8_t> keep(n_out_max, 1);
  const bool filter = bbox != nullptr;

  auto worker = [&](uint64_t lo, uint64_t hi) {
    for (uint64_t k = lo; k < hi; ++k) {
      const uint8_t* r = pts + (k * stride) * rl;
      int32_t xi = rd<int32_t>(r + off_xyz);
      int32_t yi = rd<int32_t>(r + off_xyz + 4);
      int32_t zi = rd<int32_t>(r + off_xyz + 8);
      double x = xi * h.scale[0] + h.offset[0];
      double y = yi * h.scale[1] + h.offset[1];
      if (filter &&
          (x < bbox[0] || x > bbox[1] || y < bbox[2] || y > bbox[3])) {
        keep[k] = 0;
        continue;
      }
      xs[k] = x;
      ys[k] = y;
      zs[k] = zi * h.scale[2] + h.offset[2];
      intensity[k] = rd<uint16_t>(r + off_intensity);
      klass[k] = r[off_class];
      uint8_t rb = r[off_retbyte];
      if (extended) {
        return_number[k] = rb & 0x0F;
        return_max[k] = (rb >> 4) & 0x0F;
      } else {
        return_number[k] = rb & 0x07;
        return_max[k] = (rb >> 3) & 0x07;
      }
    }
  };

  std::vector<std::thread> threads;
  uint64_t chunk = (n_out_max + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    uint64_t lo = t * chunk;
    uint64_t hi = std::min<uint64_t>(lo + chunk, n_out_max);
    if (lo >= hi) break;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();

  if (!filter) return static_cast<long>(n_out_max);

  // compact kept points in place (stable, single pass)
  uint64_t w = 0;
  for (uint64_t k = 0; k < n_out_max; ++k) {
    if (!keep[k]) continue;
    if (w != k) {
      xs[w] = xs[k];
      ys[w] = ys[k];
      zs[w] = zs[k];
      intensity[w] = intensity[k];
      klass[w] = klass[k];
      return_number[w] = return_number[k];
      return_max[w] = return_max[k];
    }
    ++w;
  }
  return static_cast<long>(w);
}

// Whole-file entry point (kept for callers that predate the range
// variant): decode every record.
long las_decode(const char* path, long stride, const double* bbox,
                double* xs, double* ys, double* zs, uint16_t* intensity,
                uint8_t* klass, uint8_t* return_number, uint8_t* return_max,
                long n_cap, int n_threads) {
  return las_decode_range(path, 0, -1, stride, bbox, xs, ys, zs,
                          intensity, klass, return_number, return_max,
                          n_cap, n_threads);
}

}  // extern "C"
