// Native CPU NMS for host-side tooling.
//
// The port's own copy of native/nms.cpp (the counterpart of the
// reference's Cython NMS, utils/nms/cpu_nms.pyx:17-163): greedy hard NMS
// and soft-NMS (linear/gaussian/hard) with the +1 pixel-area convention
// kept optional. Exposed with a plain C ABI for ctypes
// (refinedet_tpu_torch/ops/nms_native.py), which builds it with g++ at
// first use into refinedet_tpu_torch/_build/.
//
// The card's NMS is kernel K1 (csrc/nms_sweep.cu); this library serves
// host-only tooling (evaluation on a machine without a card, dataset
// debugging) where the reference used its compiled Cython module.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <numeric>
#include <vector>

namespace {

struct Box {
  float x1, y1, x2, y2;
};

inline float area(const Box& b, float off) {
  return (b.x2 - b.x1 + off) * (b.y2 - b.y1 + off);
}

inline float iou(const Box& a, const Box& b, float off) {
  const float ix1 = std::max(a.x1, b.x1);
  const float iy1 = std::max(a.y1, b.y1);
  const float ix2 = std::min(a.x2, b.x2);
  const float iy2 = std::min(a.y2, b.y2);
  const float w = std::max(0.0f, ix2 - ix1 + off);
  const float h = std::max(0.0f, iy2 - iy1 + off);
  const float inter = w * h;
  return inter / (area(a, off) + area(b, off) - inter);
}

}  // namespace

extern "C" {

// Greedy hard NMS. dets: n rows of (x1, y1, x2, y2, score). Writes kept
// row indices (score-descending) to keep_out (capacity n); returns count.
int nms_hard(const float* dets, int n, float thresh, int plus_one,
             int* keep_out) {
  const float off = plus_one ? 1.0f : 0.0f;
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
    return dets[a * 5 + 4] > dets[b * 5 + 4];
  });
  std::vector<char> suppressed(n, 0);
  int count = 0;
  for (int oi = 0; oi < n; ++oi) {
    const int i = order[oi];
    if (suppressed[i]) continue;
    keep_out[count++] = i;
    const Box bi{dets[i * 5], dets[i * 5 + 1], dets[i * 5 + 2],
                 dets[i * 5 + 3]};
    for (int oj = oi + 1; oj < n; ++oj) {
      const int j = order[oj];
      if (suppressed[j]) continue;
      const Box bj{dets[j * 5], dets[j * 5 + 1], dets[j * 5 + 2],
                   dets[j * 5 + 3]};
      if (iou(bi, bj, off) > thresh) suppressed[j] = 1;
    }
  }
  return count;
}

// Soft-NMS (method: 0 = hard, 1 = linear, 2 = gaussian). Rescores in
// place following the cpu_soft_nms semantics (+1 areas); returns the
// number of boxes whose final score exceeds score_thresh, their indices
// (in processing order) in keep_out.
int nms_soft(float* dets, int n, float iou_thresh, float sigma,
             float score_thresh, int method, int* keep_out) {
  const float off = 1.0f;
  std::vector<int> idx(n);
  std::iota(idx.begin(), idx.end(), 0);
  int count = 0;
  for (int pos = 0; pos < n; ++pos) {
    // move the max-score remaining box to position `pos`
    int max_at = pos;
    for (int j = pos + 1; j < n; ++j) {
      if (dets[idx[j] * 5 + 4] > dets[idx[max_at] * 5 + 4]) max_at = j;
    }
    std::swap(idx[pos], idx[max_at]);
    const int i = idx[pos];
    if (dets[i * 5 + 4] <= score_thresh) break;
    keep_out[count++] = i;
    const Box bi{dets[i * 5], dets[i * 5 + 1], dets[i * 5 + 2],
                 dets[i * 5 + 3]};
    for (int j = pos + 1; j < n; ++j) {
      const int k = idx[j];
      const Box bk{dets[k * 5], dets[k * 5 + 1], dets[k * 5 + 2],
                   dets[k * 5 + 3]};
      const float ov = iou(bi, bk, off);
      float w = 1.0f;
      if (method == 1) {  // linear
        if (ov > iou_thresh) w = 1.0f - ov;
      } else if (method == 2) {  // gaussian
        w = std::exp(-(ov * ov) / sigma);
      } else {  // hard
        if (ov > iou_thresh) w = 0.0f;
      }
      dets[k * 5 + 4] *= w;
    }
  }
  return count;
}

}  // extern "C"
