// Native JPEG decode for the port's input-pipeline stage (its copy of the
// JAX package's decode.cc, with a second backend; reference:
// iter_image_recordio_2.cc decodes with cv::imdecode inside the OMP pool).
// The backend is chosen when the library is built (mxnet_tpu_torch/_native.py
// probes the toolchain): libjpeg (MXT_HAS_LIBJPEG) when its header and
// library link, else the CUDA toolkit's nvJPEG (MXT_HAS_NVJPEG), else none
// (mxt_pipe_decode_available() is 0 and mxt_pipe_create refuses).
// mxt_decoder_name() names the one compiled in.
//
// nvJPEG decodes on the card: each worker thread keeps its own decoder
// state, a non-blocking stream and a device buffer, and copies the RGB
// image back to the host, where the augmenters (augment.cc) run as on the
// libjpeg path. Its IDCT and chroma upsampling are not libjpeg's, so its
// pixels differ from PIL's by a few levels; the libjpeg path is bitwise
// the JAX package's.
//
// Output contract matches image.py imdecode_np's PIL branch: RGB, HWC,
// uint8; grayscale sources expand to RGB (PIL's convert("RGB")). Exotic
// color spaces libjpeg cannot convert to RGB (e.g. CMYK from Adobe
// markers) fail with -1 and are quarantined by the caller like any other
// corrupt record.

#include <cstddef>
#include <cstdint>

#include "include/pipe_api.h"

extern "C" {
void* mxt_alloc(size_t nbytes);
void mxt_free(void* p, size_t nbytes);
}

#ifdef MXT_HAS_LIBJPEG

#include <csetjmp>
#include <cstdio>
#include <cstring>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void on_error_exit(j_common_ptr cinfo) {
  // corrupt records are expected input here: recover via longjmp instead of
  // libjpeg's default exit()
  longjmp(reinterpret_cast<ErrorMgr*>(cinfo->err)->setjmp_buffer, 1);
}

void on_output_message(j_common_ptr) {}  // keep warnings off stderr

// Version-independent memory source (jpeg_mem_src is libjpeg8+/turbo-only;
// the 62 ABI needs a hand-rolled source manager).
struct MemSrc {
  jpeg_source_mgr pub;
  const uint8_t* data;
  size_t len;
};

void src_init(j_decompress_ptr) {}

boolean src_fill(j_decompress_ptr cinfo) {
  // past the end of the buffer: feed a fake EOI so truncated files error
  // out through the normal header/marker checks instead of hanging
  static const JOCTET kEoi[2] = {0xFF, JPEG_EOI};
  cinfo->src->next_input_byte = kEoi;
  cinfo->src->bytes_in_buffer = 2;
  return TRUE;
}

void src_skip(j_decompress_ptr cinfo, long n) {
  if (n <= 0) return;
  jpeg_source_mgr* src = cinfo->src;
  while (static_cast<size_t>(n) > src->bytes_in_buffer) {
    n -= static_cast<long>(src->bytes_in_buffer);
    src_fill(cinfo);
  }
  src->next_input_byte += n;
  src->bytes_in_buffer -= n;
}

void src_term(j_decompress_ptr) {}

void set_mem_src(j_decompress_ptr cinfo, MemSrc* src, const uint8_t* buf,
                 size_t len) {
  src->pub.init_source = src_init;
  src->pub.fill_input_buffer = src_fill;
  src->pub.skip_input_data = src_skip;
  src->pub.resync_to_restart = jpeg_resync_to_restart;
  src->pub.term_source = src_term;
  src->pub.next_input_byte = buf;
  src->pub.bytes_in_buffer = len;
  src->data = buf;
  src->len = len;
  cinfo->src = &src->pub;
}

}  // namespace

extern "C" int mxt_decode_jpeg(const uint8_t* buf, size_t len, uint8_t** out,
                               int* h, int* w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  MemSrc src;
  // volatile: both are written after setjmp and read in the longjmp error
  // path — without it the compiler may keep them in registers and the
  // handler would free a stale pointer (or leak) on every corrupt record
  uint8_t* volatile mem = nullptr;
  volatile size_t nbytes = 0;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = on_error_exit;
  jerr.pub.output_message = on_output_message;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    if (mem) mxt_free(mem, nbytes);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  set_mem_src(&cinfo, &src, buf, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  cinfo.out_color_space = JCS_RGB;  // YCbCr + grayscale both convert
  jpeg_start_decompress(&cinfo);
  if (cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  *h = static_cast<int>(cinfo.output_height);
  *w = static_cast<int>(cinfo.output_width);
  nbytes = static_cast<size_t>(*h) * *w * 3;
  mem = static_cast<uint8_t*>(mxt_alloc(nbytes));
  if (!mem) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  size_t stride = static_cast<size_t>(*w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = mem + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out = mem;
  return 0;
}

/* Decode directly into a caller buffer when the source dimensions equal
 * (h, w) exactly — the packed-dataset fast path: no intermediate image,
 * no copy. Returns 1 = decoded into dst, 0 = dimensions differ (caller
 * takes the resize path), -1 = corrupt. */
extern "C" int mxt_decode_jpeg_direct(const uint8_t* buf, size_t len,
                                      uint8_t* dst, int h, int w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  MemSrc src;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = on_error_exit;
  jerr.pub.output_message = on_output_message;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  set_mem_src(&cinfo, &src, buf, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  if (static_cast<int>(cinfo.image_height) != h ||
      static_cast<int>(cinfo.image_width) != w) {
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (cinfo.output_components != 3 ||
      static_cast<int>(cinfo.output_height) != h ||
      static_cast<int>(cinfo.output_width) != w) {
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  size_t stride = static_cast<size_t>(w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = dst + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 1;
}

extern "C" int mxt_pipe_decode_available(void) { return 1; }

extern "C" const char* mxt_decoder_name(void) { return "libjpeg"; }

#elif defined(MXT_HAS_NVJPEG)

#include <cstring>
#include <mutex>

#include <cuda_runtime.h>
#include <nvjpeg.h>

namespace {

nvjpegHandle_t g_handle = nullptr;
std::once_flag g_once;
bool g_handle_ok = false;

bool nvjpeg_handle() {
  std::call_once(g_once, [] {
    g_handle_ok = nvjpegCreateSimple(&g_handle) == NVJPEG_STATUS_SUCCESS;
  });
  return g_handle_ok;
}

// One decoder per worker thread: nvJPEG's handle is shared, its decode
// state is not thread-safe.
struct ThreadDecoder {
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  unsigned char* dbuf = nullptr;
  size_t dcap = 0;
  bool ok = false;

  ThreadDecoder() {
    if (!nvjpeg_handle()) return;
    if (cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking) !=
        cudaSuccess)
      return;
    if (nvjpegJpegStateCreate(g_handle, &state) != NVJPEG_STATUS_SUCCESS)
      return;
    ok = true;
  }

  ~ThreadDecoder() {
    if (dbuf) cudaFree(dbuf);
    if (state) nvjpegJpegStateDestroy(state);
    if (stream) cudaStreamDestroy(stream);
  }

  // the source's (h, w), or false for a stream nvJPEG cannot read
  bool Info(const uint8_t* buf, size_t len, int* h, int* w) {
    int nc = 0;
    nvjpegChromaSubsampling_t ss;
    int ws[NVJPEG_MAX_COMPONENT] = {0};
    int hs[NVJPEG_MAX_COMPONENT] = {0};
    if (nvjpegGetImageInfo(g_handle, buf, len, &nc, &ss, ws, hs) !=
        NVJPEG_STATUS_SUCCESS)
      return false;
    if (ws[0] <= 0 || hs[0] <= 0) return false;
    *w = ws[0];
    *h = hs[0];
    return true;
  }

  // decode to interleaved RGB into host memory `dst` (h * w * 3 bytes)
  bool Decode(const uint8_t* buf, size_t len, uint8_t* dst, int h, int w) {
    size_t need = static_cast<size_t>(h) * w * 3;
    if (dcap < need) {
      if (dbuf) cudaFree(dbuf);
      dbuf = nullptr;
      dcap = 0;
      if (cudaMalloc(reinterpret_cast<void**>(&dbuf), need) != cudaSuccess)
        return false;
      dcap = need;
    }
    nvjpegImage_t img;
    std::memset(&img, 0, sizeof(img));
    img.channel[0] = dbuf;
    img.pitch[0] = static_cast<unsigned int>(w) * 3;
    if (nvjpegDecode(g_handle, state, buf, len, NVJPEG_OUTPUT_RGBI, &img,
                     stream) != NVJPEG_STATUS_SUCCESS)
      return false;
    if (cudaMemcpyAsync(dst, dbuf, need, cudaMemcpyDeviceToHost, stream) !=
        cudaSuccess)
      return false;
    return cudaStreamSynchronize(stream) == cudaSuccess;
  }
};

ThreadDecoder& thread_decoder() {
  thread_local ThreadDecoder dec;
  return dec;
}

}  // namespace

extern "C" int mxt_decode_jpeg(const uint8_t* buf, size_t len, uint8_t** out,
                               int* h, int* w) {
  ThreadDecoder& dec = thread_decoder();
  if (!dec.ok) return -1;
  if (!dec.Info(buf, len, h, w)) return -1;
  size_t nbytes = static_cast<size_t>(*h) * *w * 3;
  uint8_t* mem = static_cast<uint8_t*>(mxt_alloc(nbytes));
  if (!mem) return -1;
  if (!dec.Decode(buf, len, mem, *h, *w)) {
    mxt_free(mem, nbytes);
    return -1;
  }
  *out = mem;
  return 0;
}

extern "C" int mxt_decode_jpeg_direct(const uint8_t* buf, size_t len,
                                      uint8_t* dst, int h, int w) {
  ThreadDecoder& dec = thread_decoder();
  if (!dec.ok) return -1;
  int sh = 0, sw = 0;
  if (!dec.Info(buf, len, &sh, &sw)) return -1;
  if (sh != h || sw != w) return 0;
  return dec.Decode(buf, len, dst, h, w) ? 1 : -1;
}

extern "C" int mxt_pipe_decode_available(void) {
  return nvjpeg_handle() ? 1 : 0;
}

extern "C" const char* mxt_decoder_name(void) { return "nvjpeg"; }

#else  // neither backend

extern "C" int mxt_decode_jpeg(const uint8_t*, size_t, uint8_t**, int*,
                               int*) {
  return -2;
}

extern "C" int mxt_decode_jpeg_direct(const uint8_t*, size_t, uint8_t*, int,
                                      int) {
  return -1;
}

extern "C" int mxt_pipe_decode_available(void) { return 0; }

extern "C" const char* mxt_decoder_name(void) { return "none"; }

#endif  // MXT_HAS_LIBJPEG / MXT_HAS_NVJPEG
