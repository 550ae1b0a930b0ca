// Multithreaded JPEG compressibility scorer.
//
// The compressibility reward is the encoded-JPEG byte size of each sampled
// image (reference: ddpo/training/callbacks.py:143-153, one PIL encode per
// image on the Python heap). At production sampling batch sizes the encode
// is the host-side bottleneck between sampling batches, so this native
// path encodes the whole batch in parallel with libjpeg and never
// materializes Python image objects.
//
// Exposed via a C ABI for ctypes (no pybind11 in this image):
//   jpeg_sizes(images[n*h*w*3] uint8 HWC-RGB, n, h, w, quality, n_threads,
//              out_sizes[n] int64)  -> 0 on success
//
// Build: see ddpo_torch/native/build.py (g++ -O3 -shared -fPIC -ljpeg).
// The same source as ddpo_tpu/native/jpeg_reward.cc.

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

// Encode one HWC-RGB uint8 image, return compressed byte count.
int64_t encode_size(const uint8_t* pixels, int h, int w, int quality) {
  jpeg_compress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&cinfo);

  unsigned char* buffer = nullptr;
  unsigned long buffer_size = 0;
  jpeg_mem_dest(&cinfo, &buffer, &buffer_size);

  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);

  const int row_stride = w * 3;
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row =
        const_cast<uint8_t*>(pixels + cinfo.next_scanline * row_stride);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);

  int64_t size = static_cast<int64_t>(buffer_size);
  free(buffer);
  return size;
}

}  // namespace

extern "C" int jpeg_sizes(const uint8_t* images, int n, int h, int w,
                          int quality, int n_threads, int64_t* out_sizes) {
  if (n <= 0 || h <= 0 || w <= 0) return 1;
  const int64_t stride = static_cast<int64_t>(h) * w * 3;

  if (n_threads <= 1 || n == 1) {
    for (int i = 0; i < n; ++i) {
      out_sizes[i] = encode_size(images + i * stride, h, w, quality);
    }
    return 0;
  }

  std::atomic<int> next(0);
  auto worker = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      out_sizes[i] = encode_size(images + i * stride, h, w, quality);
    }
  };
  const int workers = std::min(n_threads, n);
  std::vector<std::thread> threads;
  threads.reserve(workers);
  for (int t = 0; t < workers; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return 0;
}
