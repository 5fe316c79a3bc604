// Native TEXMEX xvecs reader: mmap + OpenMP parse.
//
// The host runtime tier of the PyTorch port (a copy of the JAX
// package's reader; cf. the reference's native deps built by
// deps/build.jl with g++ -O3 -fopenmp). SIFT1B-
// scale .bvecs files are hundreds of GB; the Python reader's
// read+copy+validate path is single-threaded, while this one maps the
// file and validates/copies rows in parallel, saturating disk/page-
// cache bandwidth. Exposed through ctypes (rayuela_tpu_torch/io/native.py).
//
// Format (reference src/xvecs_read.jl): each row is a little-endian
// int32 dimension header followed by dim values (f32 / i32 / u8).
//
// Returns 0 on success; negative error codes otherwise:
//   -1 open/stat failed     -2 mmap failed
//   -3 size not a multiple of the row size
//   -4 requested range out of bounds
//   -5 inconsistent dimension header

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// Probe the file: fills *dim and *n, returns 0 / error code.
int xvecs_probe(const char* path, int value_size, int64_t* dim,
                int64_t* n) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return -1; }
  if (st.st_size < 4) { close(fd); return -3; }
  int32_t d = 0;
  if (pread(fd, &d, 4, 0) != 4 || d <= 0) { close(fd); return -3; }
  const int64_t row = 4 + (int64_t)d * value_size;
  if (st.st_size % row != 0) { close(fd); return -3; }
  *dim = d;
  *n = st.st_size / row;
  close(fd);
  return 0;
}

// Read rows [start, start+count) into out (count * dim * value_size
// bytes, row-major, headers stripped). Validates every header.
int xvecs_read(const char* path, int value_size, int64_t start,
               int64_t count, void* out) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return -1; }
  int32_t d = 0;
  if (pread(fd, &d, 4, 0) != 4 || d <= 0) { close(fd); return -3; }
  const int64_t row = 4 + (int64_t)d * value_size;
  if (st.st_size % row != 0) { close(fd); return -3; }
  const int64_t n = st.st_size / row;
  if (start < 0 || count < 0 || start + count > n) {
    close(fd);
    return -4;
  }

  const char* base = (const char*)mmap(nullptr, (size_t)st.st_size,
                                       PROT_READ, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return -2;

  const int64_t payload = (int64_t)d * value_size;
  char* dst = (char*)out;
  int bad = 0;

#pragma omp parallel for schedule(static) reduction(| : bad)
  for (int64_t i = 0; i < count; ++i) {
    const char* src = base + (start + i) * row;
    int32_t di;
    std::memcpy(&di, src, 4);
    if (di != d) {
      bad |= 1;
    } else {
      std::memcpy(dst + i * payload, src + 4, (size_t)payload);
    }
  }

  munmap((void*)base, (size_t)st.st_size);
  return bad ? -5 : 0;
}

// Row-major writer (headers inserted), for symmetry with the readers.
int xvecs_write(const char* path, int value_size, int64_t n, int64_t dim,
                const void* data) {
  int fd = open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -1;
  const int64_t payload = dim * value_size;
  const int32_t d32 = (int32_t)dim;
  const char* src = (const char*)data;
  for (int64_t i = 0; i < n; ++i) {
    if (write(fd, &d32, 4) != 4 ||
        write(fd, src + i * payload, (size_t)payload) != payload) {
      close(fd);
      return -1;
    }
  }
  close(fd);
  return 0;
}

}  // extern "C"
