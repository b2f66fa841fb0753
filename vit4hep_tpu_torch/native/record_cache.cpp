// Native record-cache loader: mmap'd fixed-size records with a multithreaded
// random gather.
//
// The lazy data families (LEMURS, CaloHadronic) read shuffled event batches
// from HDF5 each step; h5py holds the GIL and decompresses per read. This
// loader works on a one-time converted cache file (see
// vit4hep_tpu_torch/data/native_cache.py): a flat array of fixed-size records
// that the OS page cache serves at memory speed. cache_gather() copies an
// arbitrary index set into a contiguous batch buffer with a thread pool —
// called through ctypes, so the GIL is released for the whole gather.
//
// File layout (little endian):
//   [0]  u64 magic            0x56344845503ULL ("V4HEP")
//   [8]  u64 version          2 (v2: fields stored in sorted key order)
//   [16] u64 n_records
//   [24] u64 record_size      bytes per record
//   [32] raw records, n_records * record_size bytes
//
// The port's copy of the JAX package's native/record_cache.cpp, same C API and
// file format. data/native_cache.py builds it at first use with the host's
// C++ compiler into vit4hep_tpu_torch/_build/librecord_cache-<digest>.so:
//   c++ -O3 -shared -fPIC -std=c++17 -o <lib> record_cache.cpp -lpthread

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x56344845503ULL;

struct Cache {
  int fd = -1;
  const char* base = nullptr;  // mmap base
  size_t file_size = 0;
  uint64_t n_records = 0;
  uint64_t record_size = 0;
  const char* data = nullptr;  // first record
};

}  // namespace

extern "C" {

void* cache_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 32) {
    ::close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  const uint64_t* hdr = static_cast<const uint64_t*>(base);
  // version 2: fields canonicalized to sorted key order by the writer
  // (v1 caches used dict insertion order and must be rebuilt)
  if (hdr[0] != kMagic || hdr[1] != 2) {
    munmap(base, st.st_size);
    ::close(fd);
    return nullptr;
  }
  // reject truncated/corrupt files whose header survived: serving records
  // past EOF would return garbage (or SIGBUS) with no error
  if (32 + hdr[2] * hdr[3] > static_cast<uint64_t>(st.st_size)) {
    munmap(base, st.st_size);
    ::close(fd);
    return nullptr;
  }
  auto* c = new Cache;
  c->fd = fd;
  c->base = static_cast<const char*>(base);
  c->file_size = st.st_size;
  c->n_records = hdr[2];
  c->record_size = hdr[3];
  c->data = c->base + 32;
  // advise the kernel we will read randomly; keeps readahead from thrashing
  madvise(const_cast<char*>(c->base), c->file_size, MADV_RANDOM);
  return c;
}

void cache_close(void* handle) {
  auto* c = static_cast<Cache*>(handle);
  if (!c) return;
  munmap(const_cast<char*>(c->base), c->file_size);
  ::close(c->fd);
  delete c;
}

int64_t cache_num_records(void* handle) {
  return static_cast<Cache*>(handle)->n_records;
}

int64_t cache_record_size(void* handle) {
  return static_cast<Cache*>(handle)->record_size;
}

// Gather records idx[0..n) into out (n * record_size bytes), multithreaded.
// Returns 0 on success, -1 on an out-of-range index.
int cache_gather(void* handle, const int64_t* idx, int64_t n, char* out,
                 int n_threads) {
  auto* c = static_cast<Cache*>(handle);
  const uint64_t rs = c->record_size;
  std::atomic<bool> ok(true);

  auto worker = [&](int64_t start, int64_t end) {
    for (int64_t i = start; i < end; ++i) {
      const int64_t r = idx[i];
      if (r < 0 || static_cast<uint64_t>(r) >= c->n_records) {
        ok.store(false, std::memory_order_relaxed);
        return;
      }
      std::memcpy(out + i * rs, c->data + static_cast<uint64_t>(r) * rs, rs);
    }
  };

  if (n_threads <= 1 || n < 2 * n_threads) {
    worker(0, n);
  } else {
    std::vector<std::thread> pool;
    const int64_t chunk = (n + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
      const int64_t start = t * chunk;
      const int64_t end = std::min(n, start + chunk);
      if (start >= end) break;
      pool.emplace_back(worker, start, end);
    }
    for (auto& th : pool) th.join();
  }
  return ok.load() ? 0 : -1;
}

}  // extern "C"
