// bigdl_tpu_torch native runtime: C API (a copy of bigdl_tpu/native/src/
// bigdl_native.h, with the image decoder of image_decode.cpp added).
//
// The reference ships C/C++ JNI backends (MKL, MKL-DNN, OpenCV) under its
// JVM tensor and data layers. The port's math runs on the card; what stays
// native is the host data plane: image augmentation, record indexing,
// image decoding, and the prefetch executor that keeps the card fed (the
// OpenCV-JNI and Engine.ThreadPool roles). Loaded from Python via ctypes.
//
// Threading model: a fixed worker pool (std::thread) inside the library;
// Python enqueues jobs whose randomness (crop offsets, flip flags) was
// already drawn host-side, so C++ is purely deterministic data movement.
#pragma once
#include <cstdint>

extern "C" {

// ---- stateless batch ops (parallelised internally over n_threads) ----

// HWC uint8 -> CHW float32 with per-image crop/flip and per-channel
// (x - mean) / std. src: n*(src_h*src_w*c); dst: n*(c*crop_h*crop_w).
void bigdl_augment_batch(const uint8_t* src, int32_t n, int32_t src_h,
                         int32_t src_w, int32_t c, const int32_t* off_y,
                         const int32_t* off_x, const uint8_t* flip,
                         int32_t crop_h, int32_t crop_w, const float* mean,
                         const float* stdv, float* dst, int32_t n_threads);

// Bilinear resize, HWC uint8 -> HWC uint8 (half-pixel centres, like
// OpenCV INTER_LINEAR / jax.image.resize "linear").
void bigdl_resize_bilinear(const uint8_t* src, int32_t n, int32_t src_h,
                           int32_t src_w, int32_t c, uint8_t* dst,
                           int32_t dst_h, int32_t dst_w, int32_t n_threads);

// CIFAR-10/100 .bin records: [label u8][3072 u8 planar RGB] each.
// Splits into labels (int32, +label_base) and planar CHW uint8 images.
void bigdl_decode_cifar(const uint8_t* records, int32_t n,
                        int32_t record_len, int32_t label_offset,
                        uint8_t* images, int32_t* labels, int32_t label_base,
                        int32_t n_threads);

// ---- record-shard indexing ----

// Index a RECS shard held in memory: buf starts at the 4-byte "RECS" magic;
// records follow as [varint label][varint payload_len][payload]. Fills
// labels[i], offsets[i] (payload byte offset from buf start) and lengths[i]
// for up to n_max records. Returns the record count, -1 on malformed data
// (bad magic / truncated record / varint overflow), or -2 when the shard
// holds more than n_max records (call again with a larger capacity).
// One sequential scan — varint chains can't be split — but ~two orders of
// magnitude faster than a Python byte loop on multi-GB shards.
int64_t bigdl_recs_index(const uint8_t* buf, int64_t size, int64_t n_max,
                         int64_t* labels, int64_t* offsets, int64_t* lengths);

// ---- prefetch executor ----
// A bounded ring of batch slots filled by the worker pool; Python pushes
// raw-record jobs (data is copied in) and pops completed float32 batches.
// This is the native analog of the reference's Engine.default ThreadPool
// feeding MiniBatches to the optimizer.

typedef struct bigdl_loader bigdl_loader;

// Creates a loader producing (batch, c, crop_h, crop_w) float32 batches
// from (src_h, src_w, c) uint8 HWC images. queue_depth = max in-flight
// batches; n_workers = worker threads.
bigdl_loader* bigdl_loader_create(int32_t batch, int32_t src_h, int32_t src_w,
                                  int32_t c, int32_t crop_h, int32_t crop_w,
                                  const float* mean, const float* stdv,
                                  int32_t queue_depth, int32_t n_workers);

// Enqueue one batch job. Copies `batch` images (+ labels + aug params) into
// an internal arena, then returns; blocks only when queue_depth jobs are
// already in flight. Returns 0 on success, -1 if the loader was stopped.
int32_t bigdl_loader_push(bigdl_loader* L, const uint8_t* images,
                          const int32_t* labels, const int32_t* off_y,
                          const int32_t* off_x, const uint8_t* flip);

// Dequeue the oldest completed batch into caller buffers (FIFO order).
// Blocks until one is ready. Returns 0, or -1 if stopped and drained.
int32_t bigdl_loader_pop(bigdl_loader* L, float* out_images,
                         int32_t* out_labels);

// Marks the loader stopped and wakes every blocked push/pop. Safe to call
// while other threads are inside push/pop; they return -1. Call this (and
// join producer threads) BEFORE destroy, which frees the loader.
void bigdl_loader_stop(bigdl_loader* L);

void bigdl_loader_destroy(bigdl_loader* L);

// ---- image decoding (image_decode.cpp) ----

// Baseline JPEG (SOF0/SOF1: Huffman, 8-bit samples, one or three
// components, sampling 4:4:4, 4:2:2, 4:2:0 or 4:4:0, restart markers) as
// libjpeg(-turbo) decodes it by default: the integer "islow" IDCT, "fancy"
// triangle upsampling of the chroma planes and the fixed-point YCbCr->RGB
// tables. bigdl_jpeg_info reads the frame header only and fills *h and *w;
// bigdl_jpeg_decode writes (h, w, 3) RGB bytes to out (a greyscale image as
// three equal channels). Both return 0, or -1 with a message naming the
// fault or the unsupported feature in err (progressive, arithmetic-coded,
// lossless, 12-bit, CMYK/YCCK, other samplings).
int32_t bigdl_jpeg_info(const uint8_t* buf, int64_t size, int32_t* h,
                        int32_t* w, char* err, int32_t err_len);
int32_t bigdl_jpeg_decode(const uint8_t* buf, int64_t size, uint8_t* out,
                          int32_t h, int32_t w, char* err, int32_t err_len);

// PNG row unfiltering: raw holds h rows of [filter byte][row_bytes bytes]
// (the inflated IDAT stream); writes the h * row_bytes reconstructed bytes
// to out. bpp = bytes per complete pixel (the filters' left distance).
// Filters 0-4 (None, Sub, Up, Average, Paeth). Returns 0, or 1 + the first
// row index whose filter byte is not 0-4.
int32_t bigdl_png_unfilter(const uint8_t* raw, int32_t h, int32_t row_bytes,
                           int32_t bpp, uint8_t* out);

}  // extern "C"
