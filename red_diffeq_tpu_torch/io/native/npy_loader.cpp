// Native .npy batch reader: mmap + memcpy row ranges + background
// prefetch (madvise/page-touch) so host IO overlaps the card's compute.
//
// The port's copy of red_diffeq_tpu/io/native/npy_loader.cpp. The next
// batch's pages are faulted in by a detached thread while the current
// batch is being inverted on the card.
//
// Header parsing stays in Python (numpy's own np.lib.format); this file
// only handles byte ranges, keeping the C surface minimal and safe.
//
// Built at first use by red_diffeq_tpu_torch/io/native_loader.py:
//   g++ -O3 -shared -fPIC -std=c++17 -o libnpy_loader-<hash>.so \
//       npy_loader.cpp -lpthread

#include <atomic>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>

namespace {

struct NpyFile {
  int fd = -1;
  uint8_t *base = nullptr;   // mmap of the whole file
  size_t file_size = 0;
  size_t data_offset = 0;    // byte offset of the array payload
  size_t row_bytes = 0;      // bytes per leading-axis row
  int64_t nrows = 0;
  std::atomic<int> inflight{0};
};

inline const uint8_t *row_ptr(const NpyFile *f, int64_t row) {
  return f->base + f->data_offset + static_cast<size_t>(row) * f->row_bytes;
}

} // namespace

extern "C" {

void *npy_open(const char *path, uint64_t data_offset, uint64_t row_bytes,
               int64_t nrows) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void *base = ::mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto *f = new NpyFile();
  f->fd = fd;
  f->base = static_cast<uint8_t *>(base);
  f->file_size = st.st_size;
  f->data_offset = data_offset;
  f->row_bytes = row_bytes;
  f->nrows = nrows;
  return f;
}

void npy_close(void *handle) {
  auto *f = static_cast<NpyFile *>(handle);
  if (!f) return;
  // Wait for outstanding prefetch threads before unmapping.
  while (f->inflight.load() > 0) {
    std::this_thread::yield();
  }
  ::munmap(f->base, f->file_size);
  ::close(f->fd);
  delete f;
}

// Synchronous copy of rows [start, start+count) into dst.
int npy_read_rows(void *handle, int64_t start, int64_t count, void *dst) {
  auto *f = static_cast<NpyFile *>(handle);
  if (!f || start < 0 || start + count > f->nrows) return -1;
  std::memcpy(dst, row_ptr(f, start),
              static_cast<size_t>(count) * f->row_bytes);
  return 0;
}

// Background prefetch: advise the kernel and touch one byte per page so
// the range is resident before the next npy_read_rows.
void npy_prefetch_rows(void *handle, int64_t start, int64_t count) {
  auto *f = static_cast<NpyFile *>(handle);
  if (!f || start < 0) return;
  if (start + count > f->nrows) count = f->nrows - start;
  if (count <= 0) return;
  f->inflight.fetch_add(1);
  std::thread([f, start, count] {
    const uint8_t *p = row_ptr(f, start);
    size_t len = static_cast<size_t>(count) * f->row_bytes;
    ::madvise(const_cast<uint8_t *>(p), len, MADV_WILLNEED);
    volatile uint8_t sink = 0;
    const long page = sysconf(_SC_PAGESIZE);
    for (size_t off = 0; off < len; off += page) {
      sink ^= p[off];
    }
    (void)sink;
    f->inflight.fetch_sub(1);
  }).detach();
}

int64_t npy_nrows(void *handle) {
  auto *f = static_cast<NpyFile *>(handle);
  return f ? f->nrows : -1;
}

} // extern "C"
