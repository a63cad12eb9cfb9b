// Native JPEG batch decoder: the port's own copy of the JAX package's
// mxnet_tpu/_native/imgdec.cc, the same decoder (less the slice entry
// point, which nothing of the port calls), built with the same -O2
// flags, so both packages' decoded floats are the same bits. It is the
// analogue of the reference's OMP decode pipeline
// (src/io/iter_image_recordio_2.cc:445 TJimdecode / opencv decode inside
// #pragma omp parallel for): a std::thread pool decodes a whole batch of
// JPEG buffers with libjpeg, applies crop/mirror/normalize, and writes
// float32 CHW directly into the caller's batch buffer (a shared-memory
// ring slot in the sharded pipeline's worker processes).
//
// C ABI (ctypes):
//   mxtpu_decode_batch(bufs, lens, n, th, tw,
//                      rand_uv,        // n*2 floats in [0,1); <0 = center
//                      mirror,         // n bytes (0/1)
//                      mean, std,      // 3 floats each (RGB)
//                      out,            // n*3*th*tw float32
//                      nthreads, errbuf, errbuf_len) -> 0 ok / -1 error
#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
  char msg[JMSG_LENGTH_MAX];
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  (*cinfo->err->format_message)(cinfo, err->msg);
  longjmp(err->jb, 1);
}

// Decode one JPEG into RGB HWC uint8; returns empty on failure.
bool decode_rgb(const uint8_t* buf, size_t len, std::vector<uint8_t>* px,
                int* h, int* w, std::string* err) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    *err = jerr.msg;
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *h = cinfo.output_height;
  *w = cinfo.output_width;
  px->resize(size_t(*h) * *w * 3);
  const size_t stride = size_t(*w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = px->data() + size_t(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

}  // namespace

// Decode records [i0, i1) of a batch into `out`, which is indexed
// ABSOLUTELY by record position — several pools (or a retry) can fill
// disjoint slices of one batch buffer concurrently. This is the seam
// the sharded pipeline's worker processes call with the slot view of
// their shared-memory ring as `out`.
static int decode_slice(const uint8_t* const* bufs, const int64_t* lens,
                        int i0, int i1, int th, int tw,
                        const float* rand_uv, const uint8_t* mirror,
                        const float* mean, const float* stdv, float* out,
                        int nthreads, char* errbuf, int errbuf_len) {
  std::atomic<int> next(i0);
  std::atomic<bool> failed(false);
  std::string first_err;
  std::mutex err_mu;

  auto worker = [&]() {
    std::vector<uint8_t> px;
    while (true) {
      int i = next.fetch_add(1);
      if (i >= i1 || failed.load()) return;
      int ih = 0, iw = 0;
      std::string err;
      if (!decode_rgb(bufs[i], size_t(lens[i]), &px, &ih, &iw, &err)) {
        std::lock_guard<std::mutex> g(err_mu);
        if (!failed.exchange(true))
          first_err = "record " + std::to_string(i) + ": " + err;
        return;
      }
      if (ih < th || iw < tw) {
        std::lock_guard<std::mutex> g(err_mu);
        if (!failed.exchange(true))
          first_err = "record " + std::to_string(i) + ": image " +
                      std::to_string(ih) + "x" + std::to_string(iw) +
                      " smaller than data_shape " + std::to_string(th) +
                      "x" + std::to_string(tw);
        return;
      }
      float u = rand_uv[2 * i], v = rand_uv[2 * i + 1];
      int top = u < 0 ? (ih - th) / 2 : int(u * float(ih - th + 1));
      int left = v < 0 ? (iw - tw) / 2 : int(v * float(iw - tw + 1));
      if (top > ih - th) top = ih - th;
      if (left > iw - tw) left = iw - tw;
      const bool mir = mirror[i] != 0;
      float* dst = out + size_t(i) * 3 * th * tw;
      for (int c = 0; c < 3; ++c) {
        const float mu = mean[c], sd = stdv[c];
        float* plane = dst + size_t(c) * th * tw;
        for (int y = 0; y < th; ++y) {
          const uint8_t* src =
              px.data() + (size_t(top + y) * iw + left) * 3 + c;
          float* row = plane + size_t(y) * tw;
          if (!mir) {
            for (int x = 0; x < tw; ++x)
              row[x] = (float(src[size_t(x) * 3]) - mu) / sd;
          } else {
            for (int x = 0; x < tw; ++x)
              row[tw - 1 - x] = (float(src[size_t(x) * 3]) - mu) / sd;
          }
        }
      }
    }
  };

  int nt = nthreads < 1 ? 1 : nthreads;
  if (nt > i1 - i0) nt = i1 - i0;
  std::vector<std::thread> pool;
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();

  if (failed.load()) {
    snprintf(errbuf, errbuf_len, "%s", first_err.c_str());
    return -1;
  }
  return 0;
}

extern "C" int mxtpu_decode_batch(
    const uint8_t* const* bufs, const int64_t* lens, int n,
    int th, int tw, const float* rand_uv, const uint8_t* mirror,
    const float* mean, const float* stdv, float* out, int nthreads,
    char* errbuf, int errbuf_len) {
  return decode_slice(bufs, lens, 0, n, th, tw, rand_uv, mirror, mean,
                      stdv, out, nthreads, errbuf, errbuf_len);
}

// ---------------------------------------------------------------------------
// single-image decode: the seam the PIL/cv2 fallbacks route through
// (gluon.data ImageRecordDataset, mx.image, recordio.unpack_img) —
// two-call protocol so the caller owns the pixel buffer:
//   mxtpu_jpeg_dims(buf, len, &h, &w)          -> 0 ok / -1 not-a-jpeg
//   mxtpu_decode_jpeg(buf, len, out /*h*w*3*/) -> 0 ok / -1 error
// ---------------------------------------------------------------------------

extern "C" int mxtpu_jpeg_dims(const char* buf, int64_t len, int* h,
                               int* w, char* errbuf, int errbuf_len) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    snprintf(errbuf, errbuf_len, "%s", jerr.msg);
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, reinterpret_cast<const uint8_t*>(buf),
               size_t(len));
  jpeg_read_header(&cinfo, TRUE);
  *h = cinfo.image_height;
  *w = cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

extern "C" int mxtpu_decode_jpeg(const char* buf, int64_t len,
                                 uint8_t* out, char* errbuf,
                                 int errbuf_len) {
  std::vector<uint8_t> px;
  int h = 0, w = 0;
  std::string err;
  if (!decode_rgb(reinterpret_cast<const uint8_t*>(buf), size_t(len),
                  &px, &h, &w, &err)) {
    snprintf(errbuf, errbuf_len, "%s", err.c_str());
    return -1;
  }
  std::memcpy(out, px.data(), px.size());
  return 0;
}
