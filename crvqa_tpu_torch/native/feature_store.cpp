// Native feature store: mmap'd binary image-feature bank + threaded gather.
//
// The reference loads a multi-GB Python pickle of Faster-RCNN features into
// RAM per process (`dataset_LXM.py:176-179`) and assembles batches with
// per-row Python/numpy copies in a DataLoader worker. This store replaces
// that: features live in one packed little-endian file
//   [int64 n][int64 boxes][int64 feat_dim][int64 pos_dim]
//   [float32 feats n*boxes*feat_dim][float32 pos n*boxes*pos_dim]
// mmap'd read-only (shared across processes, no RAM duplication), and batch
// gather runs as a multithreaded memcpy into the caller's output buffers —
// the host-side feeding path for the device input pipeline.
//
// Exposed via a minimal C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Store {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t mapped = 0;
  int64_t n = 0, boxes = 0, feat_dim = 0, pos_dim = 0;
  const float* feats = nullptr;
  const float* pos = nullptr;
};

}  // namespace

extern "C" {

Store* feature_store_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* s = new Store();
  s->fd = fd;
  s->base = static_cast<const uint8_t*>(base);
  s->mapped = st.st_size;
  const int64_t* hdr = reinterpret_cast<const int64_t*>(s->base);
  s->n = hdr[0];
  s->boxes = hdr[1];
  s->feat_dim = hdr[2];
  s->pos_dim = hdr[3];
  size_t feats_bytes =
      size_t(s->n) * s->boxes * s->feat_dim * sizeof(float);
  size_t pos_bytes = size_t(s->n) * s->boxes * s->pos_dim * sizeof(float);
  if (s->mapped < 4 * sizeof(int64_t) + feats_bytes + pos_bytes) {
    munmap(const_cast<uint8_t*>(s->base), s->mapped);
    ::close(fd);
    delete s;
    return nullptr;
  }
  s->feats =
      reinterpret_cast<const float*>(s->base + 4 * sizeof(int64_t));
  s->pos = reinterpret_cast<const float*>(
      s->base + 4 * sizeof(int64_t) + feats_bytes);
  return s;
}

void feature_store_close(Store* s) {
  if (!s) return;
  munmap(const_cast<uint8_t*>(s->base), s->mapped);
  ::close(s->fd);
  delete s;
}

int64_t feature_store_num_images(const Store* s) { return s ? s->n : 0; }
int64_t feature_store_boxes(const Store* s) { return s ? s->boxes : 0; }
int64_t feature_store_feat_dim(const Store* s) { return s ? s->feat_dim : 0; }
int64_t feature_store_pos_dim(const Store* s) { return s ? s->pos_dim : 0; }

// Gather rows[0..batch) into out_feats [batch, boxes, feat_dim] and
// out_pos [batch, boxes, pos_dim]; parallel memcpy over `threads` workers.
// Returns 0 on success, -1 on an out-of-range index.
int feature_store_gather(const Store* s, const int64_t* rows, int64_t batch,
                         float* out_feats, float* out_pos, int threads) {
  if (!s) return -1;
  for (int64_t i = 0; i < batch; ++i) {
    if (rows[i] < 0 || rows[i] >= s->n) return -1;
  }
  const size_t feat_row = size_t(s->boxes) * s->feat_dim;
  const size_t pos_row = size_t(s->boxes) * s->pos_dim;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      std::memcpy(out_feats + i * feat_row, s->feats + rows[i] * feat_row,
                  feat_row * sizeof(float));
      std::memcpy(out_pos + i * pos_row, s->pos + rows[i] * pos_row,
                  pos_row * sizeof(float));
    }
  };
  if (threads <= 1 || batch < threads * 4) {
    work(0, batch);
    return 0;
  }
  std::vector<std::thread> pool;
  int64_t chunk = (batch + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < batch ? lo + chunk : batch;
    if (lo >= hi) break;
    pool.emplace_back(work, lo, hi);
  }
  for (auto& th : pool) th.join();
  return 0;
}

}  // extern "C"
