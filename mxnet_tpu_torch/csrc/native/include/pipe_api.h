// C API for the native decode->augment->batch input-pipeline stage
// (the port's copy: decode.cc + augment.cc + pipe.cc; Python side
// mxnet_tpu_torch/io_image.py
// ImageRecordIter(backend='native')). The reference's bottom data-ingest
// layer is iter_image_recordio_2.cc: an OMP pool JPEG-decoding records from
// the InputSplit chunk reader into InstVector batches — this is the same
// design with explicit worker threads over the sharded RecReader ring
// (src/recordio.cc) producing uint8-HWC wire batches.
#ifndef MXTPU_PIPE_API_H_
#define MXTPU_PIPE_API_H_

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct MXTPipeConfig {
  const char* path;  /* .rec file */
  int part_index;
  int num_parts;
  int num_threads;  /* decode workers */
  int batch_size;
  int out_h, out_w, out_c; /* target image shape (HWC; out_c must be 3) */
  int label_width;
  long long seed;
  long long epoch;
  int resize;         /* resize shortest edge to this first (0 = off) */
  int crop;           /* 0 = center crop, 1 = random crop */
  double mirror_prob; /* horizontal flip probability (0 = off) */
  long long max_bad;  /* quarantine budget; -1 = unlimited (legacy skip) */
  int prefetch;       /* output ring depth, in batches */
} MXTPipeConfig;

/* NULL on immediate failure (unreadable file / no JPEG backend compiled). */
void* mxt_pipe_create(const MXTPipeConfig* cfg);

/* Blocking pop of the next assembled batch into caller-owned buffers:
 * data is batch*out_h*out_w*out_c uint8 (HWC, record order), label is
 * batch*label_width float32, *pad is the final-batch pad count.
 * Returns 1 = batch filled, 0 = end of shard, -1 = error (mxt_pipe_error;
 * the quarantine budget overflowing surfaces here, after any batches
 * assembled before the overflow). */
int mxt_pipe_next(void* h, uint8_t* data, float* label, int* pad);

/* Zero-copy variant: on 1, *data and *label point at the pipeline's own
 * batch buffers (same layout as mxt_pipe_next) and stay valid until
 * mxt_pipe_release. The port's ImageRecordIter copies the batch out and
 * releases the buffers at once, so no batch it hands out can change
 * after a later pop reuses them. */
int mxt_pipe_pop(void* h, uint8_t** data, float** label, int* pad);
void mxt_pipe_release(void* h, uint8_t* data, float* label);

const char* mxt_pipe_error(void* h);

/* Monotonic counters since create:
 * out[0] bad records quarantined   out[1] decode seconds (summed)
 * out[2] augment seconds (summed)  out[3] assemble seconds (summed)
 * out[4] records decoded           out[5] batches emitted */
void mxt_pipe_stats(void* h, double* out, int n);

void mxt_pipe_close(void* h);

/* 1 when a JPEG decode backend was compiled in (libjpeg or nvJPEG) and,
 * for nvJPEG, its handle could be made; else 0 — python falls back to the
 * PIL path and counts the fallback. */
int mxt_pipe_decode_available(void);

/* "libjpeg", "nvjpeg" or "none": the backend compiled in. */
const char* mxt_decoder_name(void);

/* --- parity-test surface (tests_tpu/test_native_decode.py) ------------- */

/* Decode a JPEG byte buffer to RGB-HWC uint8 (grayscale sources are
 * expanded to RGB, like PIL's convert("RGB")). *out is mxt_alloc'd
 * (*h * *w * 3 bytes) — free with mxt_rec_free. Returns 0 ok, -1 corrupt/
 * unsupported, -2 no backend compiled in. */
int mxt_decode_jpeg(const uint8_t* buf, size_t len, uint8_t** out,
                    int* h, int* w);

/* Decode straight into dst iff the source is exactly (h, w): 1 decoded,
 * 0 dimensions differ (fall back to mxt_decode_jpeg), -1 corrupt. */
int mxt_decode_jpeg_direct(const uint8_t* buf, size_t len, uint8_t* dst,
                           int h, int w);

/* Pillow-parity two-pass fixed-point bilinear resample (uint8, c channels,
 * interleaved). Bit-identical to PIL.Image.resize(..., BILINEAR). */
void mxt_resize_bilinear(const uint8_t* src, int sh, int sw, int c,
                         uint8_t* dst, int dh, int dw);

#ifdef __cplusplus
}
#endif

#endif  /* MXTPU_PIPE_API_H_ */
