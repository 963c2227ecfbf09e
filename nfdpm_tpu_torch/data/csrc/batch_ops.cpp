// Host-side batch assembly of the port's data pipeline, in one pass.
//
// batch_gather_normalize gathers a batch's images from the dataset,
// maps uint8 to fp32 in [0, 1] (times 1/255 in float, the value the numpy
// path of nfdpm_tpu_torch/data/native.py computes too) and mirrors the
// flipped images along W, writing the contiguous NHWC batch. The images
// are split over `n_threads` threads (0: one a hardware thread), each
// taking whole images. Bound with ctypes by native.py, which builds this
// file with g++ into build/native/ at first use.

#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// images:  [n, h, w, c] uint8, contiguous
// indices: [b] int64, the rows to gather
// flips:   [b] uint8 (1: mirror along w), or null
// out:     [b, h, w, c] float32, contiguous
void batch_gather_normalize(const uint8_t* images, int64_t n, int64_t h, int64_t w,
                            int64_t c, const int64_t* indices, const uint8_t* flips,
                            int64_t b, float* out, int64_t n_threads) {
  (void)n;
  const int64_t img_elems = h * w * c;
  const float inv255 = 1.0f / 255.0f;
  if (n_threads <= 0) {
    n_threads = static_cast<int64_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  if (n_threads > b) n_threads = b;

  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= b) break;
      const uint8_t* src = images + indices[i] * img_elems;
      float* dst = out + i * img_elems;
      if (flips == nullptr || flips[i] == 0) {
        for (int64_t e = 0; e < img_elems; ++e) dst[e] = src[e] * inv255;
        continue;
      }
      for (int64_t y = 0; y < h; ++y) {
        const uint8_t* row = src + y * w * c;
        float* orow = dst + y * w * c;
        for (int64_t x = 0; x < w; ++x) {
          const uint8_t* px = row + (w - 1 - x) * c;
          float* opx = orow + x * c;
          for (int64_t ch = 0; ch < c; ++ch) opx[ch] = px[ch] * inv255;
        }
      }
    }
  };

  if (n_threads <= 1) {
    worker();
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int64_t t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // extern "C"
