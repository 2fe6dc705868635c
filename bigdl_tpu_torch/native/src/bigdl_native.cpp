// bigdl_tpu_torch native runtime: a copy of bigdl_tpu/native/src/
// bigdl_native.cpp (the arithmetic is JAX's, built with the same flags).
// See bigdl_native.h.
#include "bigdl_native.h"

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <functional>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// Run fn(i) for i in [0, n) across up to n_threads transient threads.
// Image batches are short jobs; thread start-up cost is amortised over
// whole batches, and the persistent pool lives in bigdl_loader instead.
void parallel_for(int32_t n, int32_t n_threads,
                  const std::function<void(int32_t)>& fn) {
  if (n_threads <= 1 || n <= 1) {
    for (int32_t i = 0; i < n; ++i) fn(i);
    return;
  }
  int32_t workers = std::min(n, n_threads);
  std::atomic<int32_t> next(0);
  std::vector<std::thread> pool;
  pool.reserve(workers);
  for (int32_t w = 0; w < workers; ++w) {
    pool.emplace_back([&] {
      for (int32_t i = next.fetch_add(1); i < n; i = next.fetch_add(1)) fn(i);
    });
  }
  for (auto& t : pool) t.join();
}

// One image: HWC uint8 crop/flip -> CHW float32 normalize.
void augment_one(const uint8_t* img, int32_t src_h, int32_t src_w, int32_t c,
                 int32_t oy, int32_t ox, bool flip, int32_t crop_h,
                 int32_t crop_w, const float* mean, const float* stdv,
                 float* dst) {
  for (int32_t ch = 0; ch < c; ++ch) {
    const float m = mean[ch];
    const float inv = 1.0f / stdv[ch];
    float* out = dst + (size_t)ch * crop_h * crop_w;
    for (int32_t y = 0; y < crop_h; ++y) {
      const uint8_t* row = img + ((size_t)(oy + y) * src_w + ox) * c + ch;
      float* orow = out + (size_t)y * crop_w;
      if (!flip) {
        for (int32_t x = 0; x < crop_w; ++x)
          orow[x] = ((float)row[(size_t)x * c] - m) * inv;
      } else {
        for (int32_t x = 0; x < crop_w; ++x)
          orow[crop_w - 1 - x] = ((float)row[(size_t)x * c] - m) * inv;
      }
    }
  }
}

void resize_one(const uint8_t* src, int32_t sh, int32_t sw, int32_t c,
                uint8_t* dst, int32_t dh, int32_t dw) {
  const float sy = (float)sh / dh, sx = (float)sw / dw;
  for (int32_t y = 0; y < dh; ++y) {
    float fy = ((float)y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    int32_t y0 = (int32_t)fy;
    int32_t y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    float wy = fy - y0;
    for (int32_t x = 0; x < dw; ++x) {
      float fx = ((float)x + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      int32_t x0 = (int32_t)fx;
      int32_t x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      float wx = fx - x0;
      for (int32_t ch = 0; ch < c; ++ch) {
        float v00 = src[((size_t)y0 * sw + x0) * c + ch];
        float v01 = src[((size_t)y0 * sw + x1) * c + ch];
        float v10 = src[((size_t)y1 * sw + x0) * c + ch];
        float v11 = src[((size_t)y1 * sw + x1) * c + ch];
        float top = v00 + (v01 - v00) * wx;
        float bot = v10 + (v11 - v10) * wx;
        float v = top + (bot - top) * wy;
        dst[((size_t)y * dw + x) * c + ch] = (uint8_t)(v + 0.5f);
      }
    }
  }
}

}  // namespace

extern "C" {

void bigdl_augment_batch(const uint8_t* src, int32_t n, int32_t src_h,
                         int32_t src_w, int32_t c, const int32_t* off_y,
                         const int32_t* off_x, const uint8_t* flip,
                         int32_t crop_h, int32_t crop_w, const float* mean,
                         const float* stdv, float* dst, int32_t n_threads) {
  const size_t in_stride = (size_t)src_h * src_w * c;
  const size_t out_stride = (size_t)c * crop_h * crop_w;
  parallel_for(n, n_threads, [&](int32_t i) {
    augment_one(src + i * in_stride, src_h, src_w, c, off_y[i], off_x[i],
                flip[i] != 0, crop_h, crop_w, mean, stdv, dst + i * out_stride);
  });
}

void bigdl_resize_bilinear(const uint8_t* src, int32_t n, int32_t src_h,
                           int32_t src_w, int32_t c, uint8_t* dst,
                           int32_t dst_h, int32_t dst_w, int32_t n_threads) {
  const size_t in_stride = (size_t)src_h * src_w * c;
  const size_t out_stride = (size_t)dst_h * dst_w * c;
  parallel_for(n, n_threads, [&](int32_t i) {
    resize_one(src + i * in_stride, src_h, src_w, c, dst + i * out_stride,
               dst_h, dst_w);
  });
}

void bigdl_decode_cifar(const uint8_t* records, int32_t n, int32_t record_len,
                        int32_t label_offset, uint8_t* images, int32_t* labels,
                        int32_t label_base, int32_t n_threads) {
  const int32_t img_len = record_len - label_offset - 1;
  parallel_for(n, n_threads, [&](int32_t i) {
    const uint8_t* rec = records + (size_t)i * record_len;
    labels[i] = (int32_t)rec[label_offset] + label_base;
    std::memcpy(images + (size_t)i * img_len, rec + label_offset + 1, img_len);
  });
}

}  // extern "C"

// ---------------- prefetch executor ----------------

struct Job {
  std::vector<uint8_t> images;
  std::vector<int32_t> labels;
  std::vector<int32_t> off_y, off_x;
  std::vector<uint8_t> flip;
  std::vector<float> out;  // filled by a worker
  bool done = false;
};

struct bigdl_loader {
  int32_t batch, src_h, src_w, c, crop_h, crop_w, queue_depth;
  std::vector<float> mean, stdv;

  std::mutex mu;
  std::condition_variable cv_push, cv_pop, cv_work;
  // FIFO of jobs; workers claim the first unclaimed one. Completed jobs are
  // popped strictly in push order so batch<->epoch bookkeeping stays simple.
  std::deque<Job*> jobs;      // owned; front = oldest
  std::deque<Job*> pending;   // subset of jobs not yet claimed by a worker
  bool stopped = false;
  std::vector<std::thread> workers;

  void worker_loop() {
    for (;;) {
      Job* j;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] { return stopped || !pending.empty(); });
        if (stopped && pending.empty()) return;
        j = pending.front();
        pending.pop_front();
      }
      j->out.resize((size_t)batch * c * crop_h * crop_w);
      const size_t in_stride = (size_t)src_h * src_w * c;
      const size_t out_stride = (size_t)c * crop_h * crop_w;
      for (int32_t i = 0; i < batch; ++i)
        augment_one(j->images.data() + i * in_stride, src_h, src_w, c,
                    j->off_y[i], j->off_x[i], j->flip[i] != 0, crop_h, crop_w,
                    mean.data(), stdv.data(), j->out.data() + i * out_stride);
      {
        std::lock_guard<std::mutex> lk(mu);
        j->done = true;
        cv_pop.notify_all();
      }
    }
  }
};

extern "C" {

bigdl_loader* bigdl_loader_create(int32_t batch, int32_t src_h, int32_t src_w,
                                  int32_t c, int32_t crop_h, int32_t crop_w,
                                  const float* mean, const float* stdv,
                                  int32_t queue_depth, int32_t n_workers) {
  auto* L = new bigdl_loader;
  L->batch = batch;
  L->src_h = src_h;
  L->src_w = src_w;
  L->c = c;
  L->crop_h = crop_h;
  L->crop_w = crop_w;
  L->queue_depth = queue_depth > 0 ? queue_depth : 2;
  L->mean.assign(mean, mean + c);
  L->stdv.assign(stdv, stdv + c);
  if (n_workers < 1) n_workers = 1;
  for (int32_t i = 0; i < n_workers; ++i)
    L->workers.emplace_back([L] { L->worker_loop(); });
  return L;
}

int32_t bigdl_loader_push(bigdl_loader* L, const uint8_t* images,
                          const int32_t* labels, const int32_t* off_y,
                          const int32_t* off_x, const uint8_t* flip) {
  auto* j = new Job;
  const size_t img_bytes = (size_t)L->batch * L->src_h * L->src_w * L->c;
  j->images.assign(images, images + img_bytes);
  j->labels.assign(labels, labels + L->batch);
  j->off_y.assign(off_y, off_y + L->batch);
  j->off_x.assign(off_x, off_x + L->batch);
  j->flip.assign(flip, flip + L->batch);
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_push.wait(lk, [&] {
    return L->stopped || (int32_t)L->jobs.size() < L->queue_depth;
  });
  if (L->stopped) {
    delete j;
    return -1;
  }
  L->jobs.push_back(j);
  L->pending.push_back(j);
  L->cv_work.notify_one();
  return 0;
}

int32_t bigdl_loader_pop(bigdl_loader* L, float* out_images,
                         int32_t* out_labels) {
  Job* j;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_pop.wait(lk, [&] {
      return (!L->jobs.empty() && L->jobs.front()->done) ||
             (L->stopped && L->jobs.empty());
    });
    if (L->jobs.empty()) return -1;
    j = L->jobs.front();
    L->jobs.pop_front();
    L->cv_push.notify_one();
  }
  std::memcpy(out_images, j->out.data(), j->out.size() * sizeof(float));
  std::memcpy(out_labels, j->labels.data(), L->batch * sizeof(int32_t));
  delete j;
  return 0;
}

void bigdl_loader_stop(bigdl_loader* L) {
  std::lock_guard<std::mutex> lk(L->mu);
  L->stopped = true;
  L->cv_work.notify_all();
  L->cv_push.notify_all();
  L->cv_pop.notify_all();
}

void bigdl_loader_destroy(bigdl_loader* L) {
  bigdl_loader_stop(L);
  for (auto& t : L->workers) t.join();
  for (auto* j : L->jobs) delete j;
  delete L;
}


int64_t bigdl_recs_index(const uint8_t* buf, int64_t size, int64_t n_max,
                         int64_t* labels, int64_t* offsets, int64_t* lengths) {
  if (size < 4 || std::memcmp(buf, "RECS", 4) != 0) return -1;
  int64_t pos = 4;
  int64_t n = 0;
  auto read_varint = [&](uint64_t* out) -> bool {
    uint64_t result = 0;
    int shift = 0;
    while (pos < size) {
      uint8_t b = buf[pos++];
      result |= (uint64_t)(b & 0x7F) << shift;
      if (!(b & 0x80)) {
        *out = result;
        return true;
      }
      shift += 7;
      if (shift > 63) return false;  // varint overflow
    }
    return false;  // truncated
  };
  while (pos < size) {
    uint64_t label, len;
    if (!read_varint(&label)) return -1;
    if (!read_varint(&len)) return -1;
    if (pos + (int64_t)len > size) return -1;  // truncated payload
    if (n >= n_max) return -2;
    // full varint width: the pure-Python reader yields the whole value,
    // so a >=2^31 label must decode identically on both paths
    labels[n] = (int64_t)label;
    offsets[n] = pos;
    lengths[n] = (int64_t)len;
    pos += (int64_t)len;
    ++n;
  }
  return n;
}

}  // extern "C"
