// Multithreaded checkpoint reader of the PyTorch port.
//
// The port's copy of the JAX package's native shard loader (after the
// reference's ndarray-cache loader, llm_chat.cc:826-828): N reader
// threads fill caller-provided host buffers from the checkpoint's leaf
// files, so multi-GB quantized checkpoints stream at disk or page-cache
// rate instead of one Python file read at a time. Besides whole files it
// reads byte ranges, so that the threads share one large leaf and a leaf
// can be staged through a small pinned buffer piece by piece
// (mlc_llm_tpu_torch/utils/checkpoint.py).

#include <fcntl.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// Read `size` bytes of `path` from byte `offset` into dst. Returns the
// bytes read, or -1 when the file cannot be opened or ends early.
int64_t ReadRange(const char* path, int64_t offset, void* dst, int64_t size) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -1;
  int64_t done = 0;
  char* out = static_cast<char*>(dst);
  while (done < size) {
    ssize_t r = ::pread(fd, out + done, static_cast<size_t>(size - done), offset + done);
    if (r <= 0) {
      ::close(fd);
      return -1;
    }
    done += r;
  }
  ::close(fd);
  return done;
}

}  // namespace

extern "C" {

// Load one file fully into dst (must hold `size` bytes). Returns bytes
// read or -1.
int64_t mlc_load_file(const char* path, void* dst, int64_t size) {
  return ReadRange(path, 0, dst, size);
}

// Read `count` byte ranges (paths[i] from offsets[i], sizes[i] bytes, into
// dsts[i]) with up to `num_threads` readers. Returns 0 on success, else
// the (1-based) index of the first range that failed.
int64_t mlc_load_ranges(const char** paths, const int64_t* offsets, void** dsts,
                        const int64_t* sizes, int64_t count, int64_t num_threads) {
  if (num_threads < 1) num_threads = 1;
  std::atomic<int64_t> next(0);
  std::atomic<int64_t> failed(0);
  auto worker = [&]() {
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= count || failed.load() != 0) break;
      if (ReadRange(paths[i], offsets[i], dsts[i], sizes[i]) != sizes[i]) {
        int64_t expected = 0;
        failed.compare_exchange_strong(expected, i + 1);
      }
    }
  };
  std::vector<std::thread> threads;
  int64_t n = std::min<int64_t>(num_threads, count);
  threads.reserve(static_cast<size_t>(n));
  for (int64_t t = 0; t < n; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failed.load();
}

// Load `count` whole files in parallel (the JAX package's entry): each
// file from byte 0. Returns 0 on success, else the 1-based index of the
// first failed file.
int64_t mlc_load_files(const char** paths, void** dsts, const int64_t* sizes, int64_t count,
                       int64_t num_threads) {
  std::vector<int64_t> offsets(static_cast<size_t>(count), 0);
  return mlc_load_ranges(paths, offsets.data(), dsts, sizes, count, num_threads);
}

}  // extern "C"
