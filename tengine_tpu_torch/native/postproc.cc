// Native detection post-processing — the host-side hot path the reference
// also keeps native (demos/utilities/nms.hpp, examples/common yolo/ssd NMS
// loops). The device produces padded candidate sets; final class-wise NMS
// runs here.

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <vector>

extern "C" {

// Hard NMS over [n,4] x1y1x2y2 boxes with scores. Writes kept indices in
// descending-score order into `keep` (capacity max_out); returns the count.
long tt_nms(const float* boxes, const float* scores, long n,
            float iou_threshold, int32_t* keep, long max_out) {
  std::vector<int32_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    return scores[a] > scores[b];
  });
  std::vector<float> area(n);
  for (long i = 0; i < n; ++i) {
    const float* b = boxes + 4 * i;
    area[i] = std::max(b[2] - b[0], 0.0f) * std::max(b[3] - b[1], 0.0f);
  }
  long m = 0;
  std::vector<char> dead(n, 0);
  for (long oi = 0; oi < n && m < max_out; ++oi) {
    int32_t i = order[oi];
    if (dead[i]) continue;
    keep[m++] = i;
    const float* bi = boxes + 4 * i;
    for (long oj = oi + 1; oj < n; ++oj) {
      int32_t j = order[oj];
      if (dead[j]) continue;
      const float* bj = boxes + 4 * j;
      float xx1 = std::max(bi[0], bj[0]);
      float yy1 = std::max(bi[1], bj[1]);
      float xx2 = std::min(bi[2], bj[2]);
      float yy2 = std::min(bi[3], bj[3]);
      float inter = std::max(xx2 - xx1, 0.0f) * std::max(yy2 - yy1, 0.0f);
      float denom = area[i] + area[j] - inter;
      float iou = denom > 1e-9f ? inter / denom : 0.0f;
      if (iou > iou_threshold) dead[j] = 1;
    }
  }
  return m;
}

}  // extern "C"
