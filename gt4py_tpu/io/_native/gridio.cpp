// Native grid-record IO: header + raw data, memory-mapped multi-threaded
// reads.  Built at runtime by gt4py_tpu.io (g++ -O3 -shared) and bound via
// ctypes -- the counterpart of the reference's runtime-compiled
// extension modules (reference: src/gt4py/cartesian/backend/pyext_builder.py
// compiles generated C++ with setuptools at first use; here the native code
// is first-party and the build is a single compiler invocation).
//
// File format (little-endian):
//   magic   u64  0x47543450_55474944  ("GT4P UGID")
//   version u32
//   dtype   u32  (numpy type char: 'f'=f32, 'd'=f64, 'i'=i32, 'q'=i64)
//   ndim    u32
//   pad     u32
//   dims    u64[ndim]
//   data    raw bytes, C order

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x4754345055474944ULL;
constexpr uint32_t kVersion = 1;
constexpr int kMaxDims = 8;

struct Header {
  uint64_t magic;
  uint32_t version;
  uint32_t dtype;
  uint32_t ndim;
  uint32_t pad;
  uint64_t dims[kMaxDims];
};

size_t dtype_size(uint32_t code) {
  switch (code) {
    case 'f': return 4;
    case 'd': return 8;
    case 'i': return 4;
    case 'q': return 8;
    default: return 0;
  }
}

// Chunked parallel memcpy: a single memcpy tops out well below memory
// bandwidth on many-core hosts; splitting across threads keeps large grid
// restores (GBs) close to DRAM speed.
void parallel_copy(void* dst, const void* src, size_t n) {
  const size_t kMinChunk = 8u << 20;  // 8 MB per thread minimum
  unsigned hw = std::thread::hardware_concurrency();
  size_t nthreads = hw ? hw : 1;
  if (nthreads > n / kMinChunk) nthreads = n / kMinChunk;
  if (nthreads <= 1) {
    memcpy(dst, src, n);
    return;
  }
  std::vector<std::thread> threads;
  size_t chunk = n / nthreads;
  for (size_t t = 0; t < nthreads; ++t) {
    size_t off = t * chunk;
    size_t len = (t == nthreads - 1) ? n - off : chunk;
    threads.emplace_back([=] {
      memcpy(static_cast<char*>(dst) + off,
             static_cast<const char*>(src) + off, len);
    });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Returns 0 on success.
int gridio_write(const char* path, const void* data, uint32_t dtype,
                 uint32_t ndim, const uint64_t* dims) {
  if (ndim == 0 || ndim > kMaxDims || dtype_size(dtype) == 0) return -1;
  Header h{};
  h.magic = kMagic;
  h.version = kVersion;
  h.dtype = dtype;
  h.ndim = ndim;
  size_t count = 1;
  for (uint32_t i = 0; i < ndim; ++i) {
    h.dims[i] = dims[i];
    count *= dims[i];
  }
  size_t nbytes = count * dtype_size(dtype);

  FILE* f = fopen(path, "wb");
  if (!f) return -2;
  if (fwrite(&h, sizeof(Header), 1, f) != 1) { fclose(f); return -3; }
  if (nbytes && fwrite(data, 1, nbytes, f) != nbytes) { fclose(f); return -3; }
  fclose(f);
  return 0;
}

// Reads the header only; returns 0 and fills dtype/ndim/dims on success.
int gridio_probe(const char* path, uint32_t* dtype, uint32_t* ndim,
                 uint64_t* dims) {
  FILE* f = fopen(path, "rb");
  if (!f) return -2;
  Header h{};
  size_t got = fread(&h, sizeof(Header), 1, f);
  fclose(f);
  if (got != 1 || h.magic != kMagic || h.version != kVersion) return -1;
  if (h.ndim == 0 || h.ndim > kMaxDims) return -1;
  *dtype = h.dtype;
  *ndim = h.ndim;
  for (uint32_t i = 0; i < h.ndim; ++i) dims[i] = h.dims[i];
  return 0;
}

// Reads the data payload into out (caller allocates after gridio_probe).
// Uses mmap + parallel copy.
int gridio_read(const char* path, void* out, uint64_t out_bytes) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -2;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return -2; }
  size_t total = static_cast<size_t>(st.st_size);
  if (total < sizeof(Header) || total - sizeof(Header) != out_bytes) {
    close(fd);
    return -1;
  }
  void* mapped = mmap(nullptr, total, PROT_READ, MAP_PRIVATE, fd, 0);
  if (mapped == MAP_FAILED) { close(fd); return -3; }
  parallel_copy(out, static_cast<char*>(mapped) + sizeof(Header), out_bytes);
  munmap(mapped, total);
  close(fd);
  return 0;
}

}  // extern "C"
