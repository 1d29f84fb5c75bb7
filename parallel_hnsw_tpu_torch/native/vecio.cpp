// Native host-side vector IO: mmap'd readers for the standard ANN-benchmark
// file formats (fvecs/bvecs/ivecs: per-row [int32 dim][dim elements]) and raw
// little-endian matrix dumps.  The compute path of the port runs on the card;
// this library is the host runtime piece that feeds it: zero-copy mmap,
// multi-threaded strided conversion, no Python-loop overhead.  The same
// source as the JAX package's reader, so both packages read a file alike.
//
// The reference crate keeps vectors behind its Comparator trait and streams
// chunks via VectorSelector::vector_chunks (src/pq.rs:133-137); this is the
// equivalent ingestion seam, done natively.
//
// Built at first use by build.py: g++ -O3 -std=c++17 -shared -fPIC vecio.cpp -lpthread

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <thread>
#include <vector>

extern "C" {

struct VecFile {
  int fd;
  uint8_t* base;
  size_t size;
  int64_t count;   // number of rows
  int32_t dim;     // row dimensionality
  int32_t elt_size; // bytes per element (4 = f32/i32, 1 = u8)
  int64_t stride;  // bytes per row including the leading dim field
};

// Open an [dim][payload] formatted file (fvecs / bvecs / ivecs).
// elt_size: 4 for fvecs/ivecs, 1 for bvecs. Returns null on error.
VecFile* vecio_open(const char* path, int32_t elt_size) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 4) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  madvise(base, st.st_size, MADV_SEQUENTIAL);
  int32_t dim;
  memcpy(&dim, base, 4);
  if (dim <= 0) {
    munmap(base, st.st_size);
    close(fd);
    return nullptr;
  }
  int64_t stride = 4 + (int64_t)dim * elt_size;
  if (st.st_size % stride != 0) {
    munmap(base, st.st_size);
    close(fd);
    return nullptr;
  }
  VecFile* vf = new VecFile();
  vf->fd = fd;
  vf->base = (uint8_t*)base;
  vf->size = st.st_size;
  vf->dim = dim;
  vf->elt_size = elt_size;
  vf->stride = stride;
  vf->count = st.st_size / stride;
  return vf;
}

int64_t vecio_count(VecFile* vf) { return vf ? vf->count : -1; }
int32_t vecio_dim(VecFile* vf) { return vf ? vf->dim : -1; }

void vecio_close(VecFile* vf) {
  if (!vf) return;
  munmap(vf->base, vf->size);
  close(vf->fd);
  delete vf;
}

// Copy rows [start, start+n) into out as float32 [n, dim], converting u8
// payloads (bvecs) on the fly.  Multi-threaded strided copy.
int vecio_read_f32(VecFile* vf, int64_t start, int64_t n, float* out,
                   int32_t n_threads) {
  if (!vf || start < 0 || start + n > vf->count) return -1;
  if (n_threads < 1) n_threads = 1;
  const int32_t dim = vf->dim;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* row = vf->base + (start + i) * vf->stride + 4;
      float* dst = out + i * dim;
      if (vf->elt_size == 4) {
        memcpy(dst, row, (size_t)dim * 4);
      } else {
        for (int32_t j = 0; j < dim; ++j) dst[j] = (float)row[j];
      }
    }
  };
  if (n_threads == 1 || n < 4096) {
    work(0, n);
  } else {
    std::vector<std::thread> ts;
    int64_t per = (n + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
      int64_t lo = t * per, hi = std::min<int64_t>(n, lo + per);
      if (lo >= hi) break;
      ts.emplace_back(work, lo, hi);
    }
    for (auto& t : ts) t.join();
  }
  return 0;
}

// Copy rows [start, start+n) into out as int32 [n, dim] (ivecs ground truth).
int vecio_read_i32(VecFile* vf, int64_t start, int64_t n, int32_t* out,
                   int32_t n_threads) {
  if (!vf || vf->elt_size != 4 || start < 0 || start + n > vf->count) return -1;
  (void)n_threads;
  const int32_t dim = vf->dim;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* row = vf->base + (start + i) * vf->stride + 4;
    memcpy(out + i * dim, row, (size_t)dim * 4);
  }
  return 0;
}

// Raw little-endian matrix dump: write [n, dim] float32.
int vecio_write_raw_f32(const char* path, const float* data, int64_t n,
                        int32_t dim) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  size_t total = (size_t)n * dim;
  size_t wrote = fwrite(data, 4, total, f);
  fclose(f);
  return wrote == total ? 0 : -1;
}

}  // extern "C"
