// Native fragment loader of the port: threaded JPEG / PNG decode, ScanNet
// pad and resize, plus single-image decoders and writers. Own copy of the
// JAX package's runtime/fragment_loader.cpp (reference main.py:130-151,
// the DataLoader's worker processes): the loader's decode, pad, bilinear
// and nearest resize, threads and C ABI are that file's, so the same
// frames give the same bytes.
//
// Image codecs come from what the host has, chosen when the library is
// built (data/native_loader.py, reported as its route):
//   FRAG_ROUTE_LIBJPEG   JPEG through libjpeg on the host (the JAX file's
//                        decoder);
//   FRAG_ROUTE_NVJPEG    JPEG through the CUDA toolkit's nvJPEG, decoded and
//                        encoded on the card, one non-blocking stream and
//                        decoder state per thread (no implicit device
//                        synchronisation after the first frame's buffers).
// PNG goes through zlib in both routes: 16-bit (and 8-bit) greyscale, the
// five row filters, no interlacing.
//
// C ABI (ctypes):
//   frag_loader_create(n_threads, out_w, out_h, max_depth_m) -> loader|NULL
//   frag_loader_submit(loader, n_views, img_paths[], depth_paths[]) -> ticket
//   frag_loader_fetch(loader, ticket, imgs_out, depths_out, n_views) -> rc
//   frag_loader_destroy(loader)
//   frag_decode_jpeg(path, out, h, w)                   BGR f32 [h, w, 3]
//   frag_decode_png_depth(path, max_depth_m, out, h, w) f32 m [h, w]
//   frag_write_jpeg(path, bgr_u8, h, w, quality)
//   frag_write_png16(path, u16, h, w)
//   frag_route() -> "libjpeg+zlib" | "nvjpeg+zlib"
// rc: 0 ok, -1 unknown ticket, -2 a frame failed to read or decode, -3 a
// size differs from the caller's.
//
// imgs_out:   float32 [n_views, out_h, out_w, 3], BGR (the reference's BGR
//             pixel means, config/default.py:60)
// depths_out: float32 [n_views, out_h, out_w] meters, > max_depth zeroed
//             (reference datasets/scannet.py depth handling)
//
// Built with -ffp-contract=off: the resize is the JAX file's float
// arithmetic, rounded after each operation, which the port's
// data/transforms.resize_bilinear repeats in PyTorch bit for bit.

#include <zlib.h>

#if defined(FRAG_ROUTE_NVJPEG)
#include <cuda_runtime.h>
#include <nvjpeg.h>
#elif defined(FRAG_ROUTE_LIBJPEG)
#include <csetjmp>
#include <cstdio>
#include <jpeglib.h>
#else
#error "define FRAG_ROUTE_LIBJPEG or FRAG_ROUTE_NVJPEG"
#endif

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int w = 0, h = 0, c = 0;
  std::vector<float> data;  // hwc
};

bool read_file(const char* path, std::vector<unsigned char>* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  bool ok = fseek(f, 0, SEEK_END) == 0;
  long n = ok ? ftell(f) : -1;
  ok = ok && n >= 0 && fseek(f, 0, SEEK_SET) == 0;
  if (ok) {
    out->resize((size_t)n);
    ok = fread(out->data(), 1, (size_t)n, f) == (size_t)n;
  }
  fclose(f);
  return ok;
}

bool write_file(const char* path, const unsigned char* data, size_t n) {
  FILE* f = fopen(path, "wb");
  if (!f) return false;
  bool ok = fwrite(data, 1, n, f) == n;
  return (fclose(f) == 0) && ok;
}

// ---------------------------------------------------------------- PNG (zlib)

uint32_t be32(const unsigned char* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | p[3];
}

void put_be32(std::vector<unsigned char>* out, uint32_t v) {
  for (int s = 24; s >= 0; s -= 8) out->push_back((unsigned char)(v >> s));
}

const unsigned char kPngSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};

int paeth(int a, int b, int c) {
  int p = a + b - c, pa = p > a ? p - a : a - p, pb = p > b ? p - b : b - p,
      pc = p > c ? p - c : c - p;
  return (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
}

// A greyscale, non-interlaced PNG of 8 or 16 bits: its samples, filters
// undone, rows packed (big-endian for 16 bits).
bool decode_png_gray(const std::vector<unsigned char>& buf, int* w, int* h,
                     int* depth, std::vector<unsigned char>* px) {
  if (buf.size() < 8 + 25 || memcmp(buf.data(), kPngSig, 8) != 0) return false;
  std::vector<unsigned char> idat;
  bool have_ihdr = false;
  size_t pos = 8;
  while (pos + 12 <= buf.size()) {
    uint32_t len = be32(&buf[pos]);
    const unsigned char* type = &buf[pos + 4];
    const unsigned char* data = &buf[pos + 8];
    if (len > buf.size() - pos - 12) return false;
    if (!memcmp(type, "IHDR", 4)) {
      if (len != 13) return false;
      *w = (int)be32(data);
      *h = (int)be32(data + 4);
      *depth = data[8];
      // colour type 0 (grey), compression 0, filter 0, no interlace
      if (data[9] != 0 || data[10] != 0 || data[11] != 0 || data[12] != 0)
        return false;
      if ((*depth != 8 && *depth != 16) || *w <= 0 || *h <= 0) return false;
      have_ihdr = true;
    } else if (!memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), data, data + len);
    } else if (!memcmp(type, "IEND", 4)) {
      break;
    }
    pos += 12 + (size_t)len;
  }
  if (!have_ihdr) return false;
  const size_t bpp = (size_t)*depth / 8;
  const size_t stride = (size_t)*w * bpp;
  std::vector<unsigned char> raw((stride + 1) * (size_t)*h);
  uLongf raw_len = (uLongf)raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), (uLong)idat.size()) != Z_OK ||
      raw_len != raw.size())
    return false;
  px->assign(stride * (size_t)*h, 0);
  for (int y = 0; y < *h; ++y) {
    const unsigned char* src = &raw[(stride + 1) * y];
    unsigned char* row = px->data() + stride * y;
    const unsigned char* up = y ? row - stride : nullptr;
    const int filter = src[0];
    ++src;
    for (size_t i = 0; i < stride; ++i) {
      int a = i >= bpp ? row[i - bpp] : 0;
      int b = up ? up[i] : 0;
      int c = (up && i >= bpp) ? up[i - bpp] : 0;
      int p;
      switch (filter) {
        case 0: p = 0; break;
        case 1: p = a; break;
        case 2: p = b; break;
        case 3: p = (a + b) >> 1; break;
        case 4: p = paeth(a, b, c); break;
        default: return false;
      }
      row[i] = (unsigned char)(src[i] + p);
    }
  }
  return true;
}

bool decode_png16_depth(const char* path, float max_depth_m, Image* out) {
  std::vector<unsigned char> buf, px;
  int w, h, depth;
  if (!read_file(path, &buf) || !decode_png_gray(buf, &w, &h, &depth, &px))
    return false;
  out->w = w;
  out->h = h;
  out->c = 1;
  out->data.resize((size_t)w * h);
  for (size_t i = 0; i < out->data.size(); ++i) {
    if (depth == 16) {
      // PNG is big-endian
      uint16_t v = (uint16_t)((px[2 * i] << 8) | px[2 * i + 1]);
      float m = v / 1000.0f;
      out->data[i] = (m > max_depth_m) ? 0.0f : m;
    } else {
      out->data[i] = px[i] / 1000.0f;
    }
  }
  return true;
}

void png_chunk(std::vector<unsigned char>* out, const char* type,
               const unsigned char* data, size_t len) {
  put_be32(out, (uint32_t)len);
  size_t start = out->size();
  out->insert(out->end(), type, type + 4);
  out->insert(out->end(), data, data + len);
  put_be32(out, (uint32_t)crc32(0L, out->data() + start, (uInt)(len + 4)));
}

bool encode_png16(const char* path, const uint16_t* px, int h, int w) {
  const size_t stride = (size_t)w * 2;
  std::vector<unsigned char> raw((stride + 1) * (size_t)h);
  for (int y = 0; y < h; ++y) {
    unsigned char* dst = &raw[(stride + 1) * y];
    dst[0] = 0;  // filter: none
    for (int x = 0; x < w; ++x) {
      uint16_t v = px[(size_t)y * w + x];
      dst[1 + 2 * x] = (unsigned char)(v >> 8);
      dst[2 + 2 * x] = (unsigned char)(v & 0xff);
    }
  }
  std::vector<unsigned char> z(compressBound((uLong)raw.size()));
  uLongf z_len = (uLongf)z.size();
  if (compress2(z.data(), &z_len, raw.data(), (uLong)raw.size(), 1) != Z_OK)
    return false;
  std::vector<unsigned char> out(kPngSig, kPngSig + 8);
  std::vector<unsigned char> ihdr;
  put_be32(&ihdr, (uint32_t)w);
  put_be32(&ihdr, (uint32_t)h);
  const unsigned char rest[5] = {16, 0, 0, 0, 0};  // 16-bit grey
  ihdr.insert(ihdr.end(), rest, rest + 5);
  png_chunk(&out, "IHDR", ihdr.data(), ihdr.size());
  png_chunk(&out, "IDAT", z.data(), z_len);
  png_chunk(&out, "IEND", nullptr, 0);
  return write_file(path, out.data(), out.size());
}

// ---------------------------------------------------------------- JPEG

#if defined(FRAG_ROUTE_NVJPEG)

const char kRoute[] = "nvjpeg+zlib";

nvjpegHandle_t nvjpeg_handle() {
  static std::once_flag once;
  static nvjpegHandle_t handle = nullptr;
  std::call_once(once, [] {
    if (nvjpegCreateSimple(&handle) != NVJPEG_STATUS_SUCCESS) handle = nullptr;
  });
  return handle;
}

// Per-thread decoder / encoder state, its stream and a device buffer that
// grows (and so frees, which synchronises the device) only while the
// first frames arrive.
struct JpegCtx {
  nvjpegJpegState_t state = nullptr;
  nvjpegEncoderState_t enc = nullptr;
  nvjpegEncoderParams_t params = nullptr;
  cudaStream_t stream = nullptr;
  unsigned char* dev = nullptr;
  size_t dev_cap = 0;
  bool ok = false;

  JpegCtx() {
    nvjpegHandle_t h = nvjpeg_handle();
    ok = h && cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking) ==
                  cudaSuccess &&
         nvjpegJpegStateCreate(h, &state) == NVJPEG_STATUS_SUCCESS;
  }
  ~JpegCtx() {
    if (params) nvjpegEncoderParamsDestroy(params);
    if (enc) nvjpegEncoderStateDestroy(enc);
    if (state) nvjpegJpegStateDestroy(state);
    if (dev) cudaFree(dev);
    if (stream) cudaStreamDestroy(stream);
  }
  bool reserve(size_t n) {
    if (n <= dev_cap) return true;
    if (dev) cudaFree(dev);
    dev = nullptr;
    dev_cap = 0;
    if (cudaMalloc(&dev, n) != cudaSuccess) return false;
    dev_cap = n;
    return true;
  }
};

bool decode_jpeg_bgr(const char* path, Image* out, JpegCtx* c) {
  std::vector<unsigned char> buf;
  if (!c->ok || !read_file(path, &buf)) return false;
  nvjpegHandle_t h = nvjpeg_handle();
  int n_comp, widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  nvjpegChromaSubsampling_t subsampling;
  if (nvjpegGetImageInfo(h, buf.data(), buf.size(), &n_comp, &subsampling,
                         widths, heights) != NVJPEG_STATUS_SUCCESS)
    return false;
  const int w = widths[0], ht = heights[0];
  const size_t pitch = (size_t)w * 3;
  if (w <= 0 || ht <= 0 || !c->reserve(pitch * ht)) return false;
  nvjpegImage_t img;
  memset(&img, 0, sizeof(img));
  img.channel[0] = c->dev;
  img.pitch[0] = pitch;
  std::vector<unsigned char> host(pitch * ht);
  if (nvjpegDecode(h, c->state, buf.data(), buf.size(), NVJPEG_OUTPUT_BGRI,
                   &img, c->stream) != NVJPEG_STATUS_SUCCESS ||
      cudaMemcpyAsync(host.data(), c->dev, host.size(), cudaMemcpyDeviceToHost,
                      c->stream) != cudaSuccess ||
      cudaStreamSynchronize(c->stream) != cudaSuccess)
    return false;
  out->w = w;
  out->h = ht;
  out->c = 3;
  out->data.assign(host.begin(), host.end());
  return true;
}

bool encode_jpeg_bgr(const char* path, const unsigned char* bgr, int ht, int w,
                     int quality, JpegCtx* c) {
  nvjpegHandle_t h = nvjpeg_handle();
  if (!c->ok) return false;
  if (!c->enc &&
      (nvjpegEncoderStateCreate(h, &c->enc, c->stream) != NVJPEG_STATUS_SUCCESS ||
       nvjpegEncoderParamsCreate(h, &c->params, c->stream) !=
           NVJPEG_STATUS_SUCCESS))
    return false;
  const size_t pitch = (size_t)w * 3;
  if (!c->reserve(pitch * ht)) return false;
  nvjpegImage_t img;
  memset(&img, 0, sizeof(img));
  img.channel[0] = c->dev;
  img.pitch[0] = pitch;
  size_t len = 0;
  // cv2's defaults: 4:2:0 chroma, standard Huffman tables, baseline
  if (nvjpegEncoderParamsSetQuality(c->params, quality, c->stream) !=
          NVJPEG_STATUS_SUCCESS ||
      nvjpegEncoderParamsSetSamplingFactors(c->params, NVJPEG_CSS_420,
                                            c->stream) != NVJPEG_STATUS_SUCCESS ||
      nvjpegEncoderParamsSetOptimizedHuffman(c->params, 0, c->stream) !=
          NVJPEG_STATUS_SUCCESS ||
      cudaMemcpyAsync(c->dev, bgr, pitch * ht, cudaMemcpyHostToDevice,
                      c->stream) != cudaSuccess ||
      nvjpegEncodeImage(h, c->enc, c->params, &img, NVJPEG_INPUT_BGRI, w, ht,
                        c->stream) != NVJPEG_STATUS_SUCCESS ||
      nvjpegEncodeRetrieveBitstream(h, c->enc, nullptr, &len, c->stream) !=
          NVJPEG_STATUS_SUCCESS ||
      cudaStreamSynchronize(c->stream) != cudaSuccess)
    return false;
  std::vector<unsigned char> jpeg(len);
  if (nvjpegEncodeRetrieveBitstream(h, c->enc, jpeg.data(), &len, c->stream) !=
          NVJPEG_STATUS_SUCCESS ||
      cudaStreamSynchronize(c->stream) != cudaSuccess)
    return false;
  return write_file(path, jpeg.data(), len);
}

#else  // FRAG_ROUTE_LIBJPEG

const char kRoute[] = "libjpeg+zlib";

struct JpegCtx {};  // libjpeg keeps its state per call

// libjpeg's default error handler exits the process; this one returns to
// the caller, which reports a failed frame.
struct JpegError {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegError*>(cinfo->err)->jump, 1);
}

bool decode_jpeg_bgr(const char* path, Image* out, JpegCtx*) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegError err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_error_exit;
  std::vector<unsigned char> row;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->c = 3;
  out->data.resize((size_t)out->w * out->h * 3);
  row.resize((size_t)out->w * cinfo.output_components);
  unsigned char* rp = row.data();
  for (int y = 0; (unsigned)y < cinfo.output_height; ++y) {
    jpeg_read_scanlines(&cinfo, &rp, 1);
    float* dst = out->data.data() + (size_t)y * out->w * 3;
    for (int x = 0; x < out->w; ++x) {
      // RGB → BGR
      dst[x * 3 + 0] = row[x * 3 + 2];
      dst[x * 3 + 1] = row[x * 3 + 1];
      dst[x * 3 + 2] = row[x * 3 + 0];
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

bool encode_jpeg_bgr(const char* path, const unsigned char* bgr, int h, int w,
                     int quality, JpegCtx*) {
  FILE* f = fopen(path, "wb");
  if (!f) return false;
  jpeg_compress_struct cinfo;
  JpegError err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_error_exit;
  std::vector<unsigned char> row((size_t)w * 3);
  if (setjmp(err.jump)) {
    jpeg_destroy_compress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, f);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);  // 4:2:0 chroma, standard tables, as cv2
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  unsigned char* rp = row.data();
  while (cinfo.next_scanline < cinfo.image_height) {
    const unsigned char* src = bgr + (size_t)cinfo.next_scanline * w * 3;
    for (int x = 0; x < w; ++x) {
      row[x * 3 + 0] = src[x * 3 + 2];
      row[x * 3 + 1] = src[x * 3 + 1];
      row[x * 3 + 2] = src[x * 3 + 0];
    }
    jpeg_write_scanlines(&cinfo, &rp, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  return fclose(f) == 0;
}

#endif

// ---------------------------------------------------------------- resize

// ScanNet color frames are 1296x968; the python pipeline pads 2 zero rows
// top+bottom to 972 before resizing (reference datasets/transforms.py:83-92,
// data/transforms.py pad_scannet). Apply the same pad here so
// native-decoded images match the python path.
void pad_scannet_968(Image* img) {
  if (img->w != 1296 || img->h != 968 || img->c != 3) return;
  std::vector<float> padded((size_t)img->w * 972 * 3, 0.0f);
  std::memcpy(padded.data() + (size_t)2 * img->w * 3, img->data.data(),
              img->data.size() * sizeof(float));
  img->data = std::move(padded);
  img->h = 972;
}

void resize_bilinear(const Image& src, int out_w, int out_h, float* dst) {
  const float sx = (float)src.w / out_w;
  const float sy = (float)src.h / out_h;
  for (int y = 0; y < out_h; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = (int)fy;
    if (y0 < 0) y0 = 0;
    int y1 = y0 + 1 < src.h ? y0 + 1 : src.h - 1;
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    for (int x = 0; x < out_w; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = (int)fx;
      if (x0 < 0) x0 = 0;
      int x1 = x0 + 1 < src.w ? x0 + 1 : src.w - 1;
      float wx = fx - x0;
      if (wx < 0) wx = 0;
      for (int ch = 0; ch < src.c; ++ch) {
        float v00 = src.data[((size_t)y0 * src.w + x0) * src.c + ch];
        float v01 = src.data[((size_t)y0 * src.w + x1) * src.c + ch];
        float v10 = src.data[((size_t)y1 * src.w + x0) * src.c + ch];
        float v11 = src.data[((size_t)y1 * src.w + x1) * src.c + ch];
        dst[((size_t)y * out_w + x) * src.c + ch] =
            (1 - wy) * ((1 - wx) * v00 + wx * v01) +
            wy * ((1 - wx) * v10 + wx * v11);
      }
    }
  }
}

void resize_nearest(const Image& src, int out_w, int out_h, float* dst) {
  for (int y = 0; y < out_h; ++y) {
    int sy = (int)((y + 0.5f) * src.h / out_h);
    if (sy >= src.h) sy = src.h - 1;
    for (int x = 0; x < out_w; ++x) {
      int sx = (int)((x + 0.5f) * src.w / out_w);
      if (sx >= src.w) sx = src.w - 1;
      dst[(size_t)y * out_w + x] = src.data[(size_t)sy * src.w + sx];
    }
  }
}

// ---------------------------------------------------------------- loader

struct Fragment {
  std::vector<std::string> img_paths;
  std::vector<std::string> depth_paths;
  std::vector<float> imgs;    // [n, H, W, 3]
  std::vector<float> depths;  // [n, H, W]
  std::atomic<int> pending{0};
  std::atomic<bool> ok{true};
};

struct Loader {
  int out_w, out_h;
  float max_depth_m;
  std::vector<std::thread> threads;
  std::deque<std::function<void(JpegCtx*)>> queue;
  std::mutex mu;
  std::condition_variable cv;
  std::condition_variable done_cv;
  bool stop = false;
  long next_ticket = 1;
  std::map<long, Fragment*> frags;

  void worker() {
    JpegCtx ctx;  // this thread's codec state
    for (;;) {
      std::function<void(JpegCtx*)> job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return stop || !queue.empty(); });
        if (stop && queue.empty()) return;
        job = std::move(queue.front());
        queue.pop_front();
      }
      job(&ctx);
    }
  }
};

// codec state of the single-image entries, which callers may use from
// several threads
std::mutex g_single_mu;

JpegCtx* single_ctx() {
  static JpegCtx* ctx = new JpegCtx;  // lives for the process
  return ctx;
}

}  // namespace

extern "C" {

const char* frag_route() { return kRoute; }

void* frag_loader_create(int n_threads, int out_w, int out_h,
                         float max_depth_m) {
#if defined(FRAG_ROUTE_NVJPEG)
  if (!nvjpeg_handle()) return nullptr;
#endif
  auto* l = new Loader;
  l->out_w = out_w;
  l->out_h = out_h;
  l->max_depth_m = max_depth_m;
  if (n_threads < 1) n_threads = 1;
  for (int i = 0; i < n_threads; ++i)
    l->threads.emplace_back([l] { l->worker(); });
  return l;
}

void frag_loader_destroy(void* handle) {
  auto* l = (Loader*)handle;
  {
    std::lock_guard<std::mutex> lk(l->mu);
    l->stop = true;
  }
  l->cv.notify_all();
  for (auto& t : l->threads) t.join();
  for (auto& kv : l->frags) delete kv.second;
  delete l;
}

long frag_loader_submit(void* handle, int n_views, const char** img_paths,
                        const char** depth_paths) {
  auto* l = (Loader*)handle;
  auto* fr = new Fragment;
  for (int i = 0; i < n_views; ++i) {
    fr->img_paths.emplace_back(img_paths[i]);
    fr->depth_paths.emplace_back(depth_paths ? depth_paths[i] : "");
  }
  const size_t img_sz = (size_t)l->out_h * l->out_w * 3;
  const size_t dep_sz = (size_t)l->out_h * l->out_w;
  fr->imgs.resize(img_sz * n_views);
  fr->depths.resize(dep_sz * n_views);
  fr->pending = n_views;

  long ticket;
  {
    std::lock_guard<std::mutex> lk(l->mu);
    ticket = l->next_ticket++;
    l->frags[ticket] = fr;
    for (int i = 0; i < n_views; ++i) {
      l->queue.push_back([l, fr, i, img_sz, dep_sz](JpegCtx* ctx) {
        Image img;
        if (decode_jpeg_bgr(fr->img_paths[i].c_str(), &img, ctx)) {
          pad_scannet_968(&img);
          resize_bilinear(img, l->out_w, l->out_h, fr->imgs.data() + i * img_sz);
        } else {
          fr->ok = false;
        }
        if (!fr->depth_paths[i].empty()) {
          Image dep;
          if (decode_png16_depth(fr->depth_paths[i].c_str(), l->max_depth_m,
                                 &dep)) {
            resize_nearest(dep, l->out_w, l->out_h,
                           fr->depths.data() + i * dep_sz);
          } else {
            fr->ok = false;
          }
        }
        // notify under the lock: fetch may otherwise test `pending`,
        // miss this wake-up and sleep for good
        std::lock_guard<std::mutex> lk(l->mu);
        if (--fr->pending == 0) l->done_cv.notify_all();
      });
    }
  }
  l->cv.notify_all();
  return ticket;
}

int frag_loader_fetch(void* handle, long ticket, float* imgs_out,
                      float* depths_out, int n_views) {
  auto* l = (Loader*)handle;
  Fragment* fr;
  {
    std::unique_lock<std::mutex> lk(l->mu);
    auto it = l->frags.find(ticket);
    if (it == l->frags.end()) return -1;
    fr = it->second;
    l->done_cv.wait(lk, [&] { return fr->pending.load() == 0; });
    l->frags.erase(it);
  }
  int rc = fr->ok ? 0 : -2;
  if ((size_t)n_views != fr->img_paths.size()) rc = -3;
  if (rc == 0 && imgs_out)
    memcpy(imgs_out, fr->imgs.data(), fr->imgs.size() * 4);
  if (rc == 0 && depths_out)
    memcpy(depths_out, fr->depths.data(), fr->depths.size() * 4);
  delete fr;
  return rc;
}

int frag_decode_jpeg(const char* path, float* out, int h, int w) {
  Image img;
  bool ok;
  {
    std::lock_guard<std::mutex> lk(g_single_mu);
    ok = decode_jpeg_bgr(path, &img, single_ctx());
  }
  if (!ok) return -2;
  if (img.h != h || img.w != w) return -3;
  memcpy(out, img.data.data(), img.data.size() * 4);
  return 0;
}

int frag_decode_png_depth(const char* path, float max_depth_m, float* out,
                          int h, int w) {
  Image img;
  if (!decode_png16_depth(path, max_depth_m, &img)) return -2;
  if (img.h != h || img.w != w) return -3;
  memcpy(out, img.data.data(), img.data.size() * 4);
  return 0;
}

int frag_write_jpeg(const char* path, const unsigned char* bgr, int h, int w,
                    int quality) {
  std::lock_guard<std::mutex> lk(g_single_mu);
  return encode_jpeg_bgr(path, bgr, h, w, quality, single_ctx()) ? 0 : -2;
}

int frag_write_png16(const char* path, const uint16_t* data, int h, int w) {
  return encode_png16(path, data, h, w) ? 0 : -2;
}

}  // extern "C"
