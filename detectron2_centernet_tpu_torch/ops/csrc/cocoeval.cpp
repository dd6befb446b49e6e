// Fast COCO evaluation: the per-image greedy matching loop, the hot
// O(T x D x G) part of COCO mAP, in C++ (a copy of the JAX package's
// `ops/csrc/cocoeval.cpp`; the port builds its own copy).
//
// Plays the role of the reference's `detectron2/layers/csrc/cocoeval/
// cocoeval.cpp` (`COCOevalEvaluateImages`, driven from fast_eval_api.py).
// The Python side (ops/fast_cocoeval.py) computes IoUs vectorized in numpy,
// batches all images of one (category, area-range) into a single call here,
// and accumulates precision/recall curves in numpy: the reference's
// evaluate/accumulate split.
//
// Built at first use by ops/fast_cocoeval.py::build_library
// (g++ -O2 -shared -fPIC) into the package's _build/ and loaded with ctypes.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Evaluate all images of one (category, area-range).
//
// Layout: image i has D_i dets (score-sorted desc, already truncated to the
// largest maxDet) and G_i gts; `det_off`/`gt_off` are exclusive prefix sums
// (length n_images+1). `ious` is concatenated row-major (D_i x G_i) blocks
// at offsets `iou_off`.
//
// Outputs (caller-allocated):
//   dtm        (T * total_D)  int64: matched gt local index + 1, 0 = none
//   dt_ignore  (T * total_D)  uint8
//   gt_ignore  (total_G)      uint8 (after area-range augmentation)
//   num_gt     (n_images)     int32: non-ignored gt count
// Per image, the T x D_i block for dtm/dt_ignore starts at T * det_off[i]
// and is row-major (t, d).
void cocoeval_evaluate_images(
    int n_images,
    const int64_t* det_off,
    const int64_t* gt_off,
    const int64_t* iou_off,
    const double* ious,
    const double* gt_areas,
    const uint8_t* gt_iscrowd,
    const uint8_t* gt_ignore_in,
    const double* det_areas,
    const double* iou_thrs,
    int n_thr,
    double area_lo,
    double area_hi,
    int64_t* dtm,
    uint8_t* dt_ignore,
    uint8_t* gt_ignore_out,
    int32_t* num_gt) {
  for (int i = 0; i < n_images; ++i) {
    const int64_t d0 = det_off[i];
    const int64_t g0 = gt_off[i];
    const int D = static_cast<int>(det_off[i + 1] - d0);
    const int G = static_cast<int>(gt_off[i + 1] - g0);
    const double* iou = ious + iou_off[i];

    // area-range gt ignore + sort order: non-ignored first (stable)
    std::vector<uint8_t> gig(G);
    std::vector<int> order(G);
    for (int g = 0; g < G; ++g) {
      const double a = gt_areas[g0 + g];
      gig[g] = gt_ignore_in[g0 + g] || a < area_lo || a > area_hi;
      order[g] = g;
    }
    std::stable_sort(order.begin(), order.end(),
                     [&](int a, int b) { return gig[a] < gig[b]; });

    int n_good = 0;
    for (int g = 0; g < G; ++g) {
      gt_ignore_out[g0 + g] = gig[order[g]];
      if (!gig[order[g]]) ++n_good;
    }
    num_gt[i] = n_good;

    for (int t = 0; t < n_thr; ++t) {
      std::vector<uint8_t> gt_matched(G, 0);
      int64_t* dtm_row = dtm + n_thr * d0 + static_cast<int64_t>(t) * D;
      uint8_t* dig_row = dt_ignore + n_thr * d0 + static_cast<int64_t>(t) * D;
      for (int d = 0; d < D; ++d) {
        double best = iou_thrs[t] < (1.0 - 1e-10) ? iou_thrs[t] : (1.0 - 1e-10);
        int m = -1;
        for (int oi = 0; oi < G; ++oi) {
          const int g = order[oi];
          if (gt_matched[oi] && !gt_iscrowd[g0 + g]) continue;
          // gts sorted ignore-last: once matched to a real gt, stop at ignores
          if (m > -1 && !gt_ignore_out[g0 + m] && gt_ignore_out[g0 + oi]) break;
          const double v = iou[static_cast<int64_t>(d) * G + g];
          if (v < best) continue;
          best = v;
          m = oi;  // position in sorted order (matches python impl)
        }
        if (m == -1) {
          dtm_row[d] = 0;
          dig_row[d] = 0;
        } else {
          gt_matched[m] = 1;
          dtm_row[d] = m + 1;
          dig_row[d] = gt_ignore_out[g0 + m];
        }
      }
      // unmatched dets outside the area range are ignored
      for (int d = 0; d < D; ++d) {
        const double a = det_areas[d0 + d];
        if (dtm_row[d] == 0 && (a < area_lo || a > area_hi)) dig_row[d] = 1;
      }
    }
  }
}

int cocoeval_abi_version() { return 1; }

}  // extern "C"
