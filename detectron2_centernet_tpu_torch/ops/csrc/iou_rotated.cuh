// The IoU of two rotated boxes (cx, cy, w, h, angle in degrees,
// counter-clockwise), one thread per pair: shared by the pairwise kernel
// (`iou_rotated.cu`, R1) and the rotated NMS (`nms.cu`, R2).
//
// What it computes is the JAX package's `_pair_iou_rot`
// (detectron2_centernet_tpu/ops/roi_align_rotated.py:57-144), which the port's
// plain version (`ops/roi_align_rotated.py::pairwise_iou_rotated_plain`)
// repeats: the first box's corners are clipped, Sutherland-Hodgman, by the
// half-plane left of each edge of the second box's (a vertex is inside when
// its side value is >= -1e-9; an edge that crosses gives the point at
// t = s_cur / (s_cur - s_nxt), t = 0 when |s_cur - s_nxt| <= 1e-12); the
// intersection's area is the shoelace sum, and the IoU is
// inter / (w1 h1 + w2 h2 - inter) where that union is > 0, else 0.
//
// Each step rounds as the plain version's tensor ops do: the sources that
// include this header are compiled with `-fmad=false` (no multiply-add is
// contracted into an FMA), and the shoelace terms are summed in vertex
// order, as the plain version sums its vertex slots. The JAX package keeps
// 64 vertex slots a polygon; a convex quadrilateral clipped by four
// half-planes has at most 8 vertices, and near-collinear edges can add
// rounding's doubles, so 16 slots are kept here and in the plain version
// (`MAX_VERTICES`), the count cut at 16 as JAX cuts it at 64.
//
// Pairs whose circumscribed circles lie apart, by a margin far above f32
// rounding, are disjoint: the clip would leave no vertex and give 0, which
// is returned at once, without the trigonometry.
#pragma once

#include <cuda_runtime.h>

namespace rotated {

constexpr int kMaxVertices = 16;

struct Box5 {
  float cx, cy, w, h, a;
};

__device__ __forceinline__ Box5 load_box(const float* __restrict__ p) { return Box5{p[0], p[1], p[2], p[3], p[4]}; }

// Corners in JAX's order: (w, h), (-w, h), (-w, -h), (w, -h) halves, rotated.
__device__ __forceinline__ void corners(const Box5& b, float* x, float* y) {
  const float t = b.a * 0.017453292519943295f;  // deg2rad in f32, as torch.deg2rad and jnp.deg2rad round it
  const float c = cosf(t), s = sinf(t);
  const float hw = b.w / 2.f, hh = b.h / 2.f;
  const float dx[4] = {hw, -hw, -hw, hw}, dy[4] = {hh, hh, -hh, -hh};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[i] = b.cx + dx[i] * c - dy[i] * s;
    y[i] = b.cy + dx[i] * s + dy[i] * c;
  }
}

// Whether the pair is certainly disjoint: the centres farther apart than
// the two half-diagonals and a margin for rounding.
__device__ __forceinline__ bool far_apart(const Box5& p, const Box5& q) {
  const float r = 0.5f * (sqrtf(p.w * p.w + p.h * p.h) + sqrtf(q.w * q.w + q.h * q.h));
  const float margin = 1e-3f * r + 1e-4f * (fabsf(p.cx) + fabsf(p.cy) + fabsf(q.cx) + fabsf(q.cy)) + 1e-3f;
  const float dx = p.cx - q.cx, dy = p.cy - q.cy;
  return !(dx * dx + dy * dy <= (r + margin) * (r + margin));
}

// IoU of `p` (the subject, clipped: the NMS's pick, the matcher's gt) with `q`.
__device__ __forceinline__ float iou(const Box5& p, const Box5& q) {
  if (far_apart(p, q)) return 0.f;
  float qx[4], qy[4];
  float px[kMaxVertices], py[kMaxVertices], ox[kMaxVertices], oy[kMaxVertices], side[kMaxVertices];
  corners(p, px, py);
  corners(q, qx, qy);
  int n = 4;
  for (int e = 0; e < 4 && n > 0; ++e) {
    const float ax = qx[e], ay = qy[e];
    const float ex = qx[(e + 1) & 3] - ax, ey = qy[(e + 1) & 3] - ay;
    for (int i = 0; i < n; ++i) side[i] = ex * (py[i] - ay) - ey * (px[i] - ax);
    int m = 0;
    for (int i = 0; i < n; ++i) {
      const int j = i + 1 >= n ? 0 : i + 1;
      const bool in_i = side[i] >= -1e-9f, in_j = side[j] >= -1e-9f;
      if (in_i) {
        if (m < kMaxVertices) {
          ox[m] = px[i];
          oy[m] = py[i];
        }
        ++m;
      }
      if (in_i != in_j) {
        const float denom = side[i] - side[j];
        const float t = fabsf(denom) > 1e-12f ? side[i] / (denom == 0.f ? 1.f : denom) : 0.f;
        if (m < kMaxVertices) {
          ox[m] = px[i] + t * (px[j] - px[i]);
          oy[m] = py[i] + t * (py[j] - py[i]);
        }
        ++m;
      }
    }
    n = m < kMaxVertices ? m : kMaxVertices;
    for (int i = 0; i < n; ++i) {
      px[i] = ox[i];
      py[i] = oy[i];
    }
  }
  float acc = 0.f;
  for (int i = 0; i < n; ++i) {
    const int j = i + 1 >= n ? 0 : i + 1;
    acc = acc + (px[i] * py[j] - px[j] * py[i]);
  }
  const float inter = 0.5f * fabsf(acc);
  const float uni = p.w * p.h + q.w * q.h - inter;
  return uni > 0.f ? inter / uni : 0.f;
}

}  // namespace rotated
