// The IoU of two rotated boxes (cx, cy, w, h, angle in degrees,
// counter-clockwise): shared by the pairwise kernel (`iou_rotated.cu`, R1)
// and the rotated NMS (`nms.cu`, R2).
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
// Each box becomes a `Record` once (`make_record`): its corners (one cosf
// and one sinf), its diagonal (one sqrtf), |cx| + |cy|, its area and its
// class. A pair then costs no trigonometry and no square root: `far_apart`
// first, on the centres and diagonals (pairs whose circumscribed circles lie
// apart by a margin far above f32 rounding are disjoint: the clip would
// leave no vertex and give 0), then `separated`, the same margin along the
// boxes' edge normals (0 for the same reason), and the clip only for the
// others. Every value is the one the per-pair computation gave, operation
// for operation.
//
// The clip runs in registers (`clipped_area_fast`) when, at every edge, the
// polygon's vertices go in and out of the half-plane at most once each way,
// as a convex polygon's do: the output is then the input's run of inside
// vertices and the two crossing points, so each stage is a fixed number of
// selects over compile-time slots (4, 5, 6 and 7 vertices in, at most 8
// out) and no slot is indexed at run time. Rounding near a clip line can,
// rarely, make more crossings; such a pair is clipped by the general loop
// (`clipped_area`) in the warp's two polygons of shared memory, one lane at
// a time. Both give the plain clip's vertices in its order, so the same
// area bit for bit.
#pragma once

#include <cuda_runtime.h>

namespace rotated {

constexpr int kMaxVertices = 16;

struct Box5 {
  float cx, cy, w, h, a;
};

__device__ __forceinline__ Box5 load_box(const float* __restrict__ p) { return Box5{p[0], p[1], p[2], p[3], p[4]}; }

// A box as the IoU reads it, computed once per box; 64 bytes.
struct alignas(16) Record {
  float x[4], y[4];  // corners in JAX's order: (w, h), (-w, h), (-w, -h), (w, -h) halves, rotated
  float cx, cy;
  float diag;   // sqrtf(w w + h h)
  float absum;  // |cx| + |cy|
  float area;   // w h
  int cls;
  float hw, hh;  // w / 2, h / 2
};

__device__ __forceinline__ Record make_record(const Box5& b, int cls) {
  Record r;
  const float t = b.a * 0.017453292519943295f;  // deg2rad in f32, as torch.deg2rad and jnp.deg2rad round it
  const float c = cosf(t), s = sinf(t);
  const float hw = b.w / 2.f, hh = b.h / 2.f;
  const float dx[4] = {hw, -hw, -hw, hw}, dy[4] = {hh, hh, -hh, -hh};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r.x[i] = b.cx + dx[i] * c - dy[i] * s;
    r.y[i] = b.cy + dx[i] * s + dy[i] * c;
  }
  r.cx = b.cx;
  r.cy = b.cy;
  r.diag = sqrtf(b.w * b.w + b.h * b.h);
  r.absum = fabsf(b.cx) + fabsf(b.cy);
  r.area = b.w * b.h;
  r.cls = cls;
  r.hw = hw;
  r.hh = hh;
  return r;
}

// Whether the pair is certainly disjoint: the centres farther apart than
// the two half-diagonals and a margin for rounding (the margin's sum is
// ((|p.cx| + |p.cy|) + |q.cx|) + |q.cy|, p's part kept in its record).
__device__ __forceinline__ bool far_apart(float p_cx, float p_cy, float p_diag, float p_absum, float q_cx, float q_cy,
                                          float q_diag) {
  const float r = 0.5f * (p_diag + q_diag);
  const float margin = 1e-3f * r + 1e-4f * (p_absum + fabsf(q_cx) + fabsf(q_cy)) + 1e-3f;
  const float dx = p_cx - q_cx, dy = p_cy - q_cy;
  return !(dx * dx + dy * dy <= (r + margin) * (r + margin));
}

__device__ __forceinline__ bool far_apart(const Record& p, const Record& q) {
  return far_apart(p.cx, p.cy, p.diag, p.absum, q.cx, q.cy, q.diag);
}

// Whether an edge normal of either box separates the pair by far_apart's
// margin (both boxes' sides at least 2e-2). The clip then leaves no vertex,
// so the IoU is exactly 0: the clip's vertices stay within rounding (about
// 1e-7 of the coordinates a step, far under the margin) of p's corners
// and of the half-planes applied so far. When the axis is q's, every vertex
// lies beyond that edge's line by about the margin when its edge comes;
// when it is p's, the three half-planes before q's last edge keep a
// half-strip whose points outside q lie beyond that last edge's line by
// their distance to q, at least the margin. Either way each side value is
// below -(2e-2 x margin), far under the clip's -1e-9.
__device__ __forceinline__ bool separated(const Record& p, const Record& q) {
  if (!(p.hw >= 1e-2f && p.hh >= 1e-2f && q.hw >= 1e-2f && q.hh >= 1e-2f)) return false;
  const float upx = 0.5f * (p.x[0] - p.x[1]), upy = 0.5f * (p.y[0] - p.y[1]);  // half p's width, rotated
  const float vpx = 0.5f * (p.x[0] - p.x[3]), vpy = 0.5f * (p.y[0] - p.y[3]);  // half its height
  const float uqx = 0.5f * (q.x[0] - q.x[1]), uqy = 0.5f * (q.y[0] - q.y[1]);
  const float vqx = 0.5f * (q.x[0] - q.x[3]), vqy = 0.5f * (q.y[0] - q.y[3]);
  const float tx = q.cx - p.cx, ty = q.cy - p.cy;
  const float margin = 1e-3f * (0.5f * (p.diag + q.diag)) + 1e-4f * (p.absum + fabsf(q.cx) + fabsf(q.cy)) + 1e-3f;
  // along axis (ax, ay) of length len: the centres' distance beyond both boxes' half extents, in len units
  auto apart = [&](float ax, float ay, float len) {
    const float reach = fabsf(ax * upx + ay * upy) + fabsf(ax * vpx + ay * vpy) + fabsf(ax * uqx + ay * uqy)
                        + fabsf(ax * vqx + ay * vqy);
    return fabsf(ax * tx + ay * ty) > reach + margin * len;
  };
  return apart(upx, upy, p.hw) || apart(vpx, vpy, p.hh) || apart(uqx, uqy, q.hw) || apart(vqx, vqy, q.hh);
}

// One edge of the clip in registers: the polygon's n <= N vertices in
// slots 0..N-1 of X, Y, clipped by the half-plane left of the edge from
// (ax, ay) along (ex, ey), into slots 0..N; returns the new count, or -1
// when the in/out sequence crosses more than twice (the general clip's
// case). With one run of inside vertices from b + 1 to a (cyclically) the
// clip's output is, when vertex 0 is inside, 0..a, I_a, I_b, b + 1..n - 1,
// else I_b, b + 1..a, I_a: I_i the crossing on the edge from i to its
// successor, computed as the clip computes it.
template <int N>
__device__ __forceinline__ int clip_edge_fast(float (&X)[8], float (&Y)[8], int n, float ax, float ay, float ex,
                                              float ey) {
  float S[N];
  unsigned in = 0u;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    S[k] = ex * (Y[k] - ay) - ey * (X[k] - ax);
    if (k < n && S[k] >= -1e-9f) in |= 1u << k;
  }
  const unsigned full = (1u << n) - 1u;
  if (in == full) return n;
  if (in == 0u) return 0;
  const unsigned next_in = (in >> 1) | ((in & 1u) << (n - 1));  // bit k: whether k's successor is inside
  const unsigned leaves = in & ~next_in, enters = ~in & next_in & full;
  if (__popc(leaves) != 1) return -1;
  const int a = __ffs(leaves) - 1, b = __ffs(enters) - 1;
  const int ja = a + 1 == n ? 0 : a + 1, jb = b + 1 == n ? 0 : b + 1;
  float xa = 0.f, ya = 0.f, sa = 0.f, xja = 0.f, yja = 0.f, sja = 0.f;
  float xb = 0.f, yb = 0.f, sb = 0.f, xjb = 0.f, yjb = 0.f, sjb = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    xa = k == a ? X[k] : xa;
    ya = k == a ? Y[k] : ya;
    sa = k == a ? S[k] : sa;
    xja = k == ja ? X[k] : xja;
    yja = k == ja ? Y[k] : yja;
    sja = k == ja ? S[k] : sja;
    xb = k == b ? X[k] : xb;
    yb = k == b ? Y[k] : yb;
    sb = k == b ? S[k] : sb;
    xjb = k == jb ? X[k] : xjb;
    yjb = k == jb ? Y[k] : yjb;
    sjb = k == jb ? S[k] : sjb;
  }
  float denom = sa - sja;
  const float ta = fabsf(denom) > 1e-12f ? sa / (denom == 0.f ? 1.f : denom) : 0.f;
  const float iax = xa + ta * (xja - xa), iay = ya + ta * (yja - ya);
  denom = sb - sjb;
  const float tb = fabsf(denom) > 1e-12f ? sb / (denom == 0.f ? 1.f : denom) : 0.f;
  const float ibx = xb + tb * (xjb - xb), iby = yb + tb * (yjb - yb);
  const bool starts_in = in & 1u;
  const int keep = starts_in ? a : -1;  // slots 0..keep stay
  const int at_a = starts_in ? a + 1 : a - b + 1, at_b = starts_in ? a + 2 : 0;
  const int shift = (starts_in ? b - a - 2 : b) + 1;  // the other slots k take slot k - 1 + shift
  float SX[N + 1], SY[N + 1];
#pragma unroll
  for (int k = 0; k <= N; ++k) {
    SX[k] = X[k > 0 ? k - 1 : 0];
    SY[k] = Y[k > 0 ? k - 1 : 0];
  }
#pragma unroll
  for (int bit = 1; bit < N; bit <<= 1) {
    const bool move = shift & bit;
#pragma unroll
    for (int k = 0; k + bit <= N; ++k) {
      SX[k] = move ? SX[k + bit] : SX[k];
      SY[k] = move ? SY[k + bit] : SY[k];
    }
  }
#pragma unroll
  for (int k = 0; k <= N; ++k) {
    const float x = k == at_a ? iax : k == at_b ? ibx : SX[k];
    const float y = k == at_a ? iay : k == at_b ? iby : SY[k];
    X[k] = k <= keep ? X[k] : x;
    Y[k] = k <= keep ? Y[k] : y;
  }
  return starts_in ? n + a - b + 2 : a - b + 2;
}

// The area of p's corners clipped by q's edges in registers, into `area`;
// false when some edge needs the general clip.
__device__ __forceinline__ bool clipped_area_fast(const Record& p, const Record& q, float& area) {
  float X[8], Y[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    X[k] = k < 4 ? p.x[k & 3] : 0.f;
    Y[k] = k < 4 ? p.y[k & 3] : 0.f;
  }
  int n = clip_edge_fast<4>(X, Y, 4, q.x[0], q.y[0], q.x[1] - q.x[0], q.y[1] - q.y[0]);
  if (n > 0) n = clip_edge_fast<5>(X, Y, n, q.x[1], q.y[1], q.x[2] - q.x[1], q.y[2] - q.y[1]);
  if (n > 0) n = clip_edge_fast<6>(X, Y, n, q.x[2], q.y[2], q.x[3] - q.x[2], q.y[3] - q.y[2]);
  if (n > 0) n = clip_edge_fast<7>(X, Y, n, q.x[3], q.y[3], q.x[0] - q.x[3], q.y[0] - q.y[3]);
  if (n < 0) return false;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (k < n) {
      const float xj = k + 1 < 8 && k + 1 < n ? X[k + 1 < 8 ? k + 1 : 0] : X[0];
      const float yj = k + 1 < 8 && k + 1 < n ? Y[k + 1 < 8 ? k + 1 : 0] : Y[0];
      acc = acc + (X[k] * yj - xj * Y[k]);
    }
  }
  area = 0.5f * fabsf(acc);
  return true;
}

// The area of p's corners clipped by the half-planes of q's edges: the
// plain clip's loop, for any number of crossings, its two polygons in
// shared memory (`poly`).
__device__ __forceinline__ float clipped_area(const Record& p, const Record& q, float2 (*poly)[kMaxVertices]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) poly[0][k] = make_float2(p.x[k], p.y[k]);
  int n = 4, cur = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (n == 0) break;
    const float ax = q.x[e], ay = q.y[e];
    const float ex = q.x[(e + 1) & 3] - ax, ey = q.y[(e + 1) & 3] - ay;
    const float2 first = poly[cur][0];
    const float s_first = ex * (first.y - ay) - ey * (first.x - ax);
    float2 pi = first;
    float si = s_first;
    int m = 0;
    for (int i = 0; i < n; ++i) {
      const bool wrap = i + 1 >= n;  // the last vertex's successor is the first
      const float2 pj = wrap ? first : poly[cur][i + 1];
      const float sj = wrap ? s_first : ex * (pj.y - ay) - ey * (pj.x - ax);
      const bool in_i = si >= -1e-9f, in_j = sj >= -1e-9f;
      if (in_i) {
        if (m < kMaxVertices) poly[1 - cur][m] = pi;
        ++m;
      }
      if (in_i != in_j) {
        const float denom = si - sj;
        const float t = fabsf(denom) > 1e-12f ? si / (denom == 0.f ? 1.f : denom) : 0.f;
        if (m < kMaxVertices) poly[1 - cur][m] = make_float2(pi.x + t * (pj.x - pi.x), pi.y + t * (pj.y - pi.y));
        ++m;
      }
      pi = pj;
      si = sj;
    }
    n = m < kMaxVertices ? m : kMaxVertices;
    cur = 1 - cur;
  }
  float acc = 0.f;
  if (n > 0) {
    const float2 first = poly[cur][0];
    float2 pi = first;
    for (int i = 0; i < n; ++i) {
      const float2 pj = i + 1 >= n ? first : poly[cur][i + 1];
      acc = acc + (pi.x * pj.y - pj.x * pi.y);
      pi = pj;
    }
  }
  return 0.5f * fabsf(acc);
}

// IoU of `p` (the subject, clipped: the NMS's pick, the matcher's gt) with
// `q`, for a pair `far_apart` did not reject. Every lane of the warp calls
// it together, those with no pair with `take` false; `scratch` is the
// warp's two polygons in shared memory for the general clip.
__device__ __forceinline__ float near_iou(bool take, const Record& p, const Record& q,
                                          float2 (*scratch)[kMaxVertices]) {
  float inter = 0.f;
  const bool fast = !take || clipped_area_fast(p, q, inter);
  unsigned slow = __ballot_sync(0xffffffffu, !fast);
  while (slow != 0u) {  // a lane at a time
    if (static_cast<int>(threadIdx.x & 31) == __ffs(slow) - 1) inter = clipped_area(p, q, scratch);
    __syncwarp();
    slow &= slow - 1u;
  }
  const float uni = p.area + q.area - inter;
  return uni > 0.f ? inter / uni : 0.f;
}

// Records in shared memory as a structure of arrays, one array per field,
// so that lanes reading different records hit different banks.
template <int N>
struct RecordBlock {
  float v[16][N];  // x0..x3, y0..y3, cx, cy, diag, absum, area, cls (its bits), hw, hh
  __device__ __forceinline__ void put(int i, const Record& r) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k][i] = r.x[k];
      v[4 + k][i] = r.y[k];
    }
    v[8][i] = r.cx;
    v[9][i] = r.cy;
    v[10][i] = r.diag;
    v[11][i] = r.absum;
    v[12][i] = r.area;
    v[13][i] = __int_as_float(r.cls);
    v[14][i] = r.hw;
    v[15][i] = r.hh;
  }
  __device__ __forceinline__ Record get(int i) const {
    Record r;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      r.x[k] = v[k][i];
      r.y[k] = v[4 + k][i];
    }
    r.cx = v[8][i];
    r.cy = v[9][i];
    r.diag = v[10][i];
    r.absum = v[11][i];
    r.area = v[12][i];
    r.cls = __float_as_int(v[13][i]);
    r.hw = v[14][i];
    r.hh = v[15][i];
    return r;
  }
  __device__ __forceinline__ int cls(int i) const { return __float_as_int(v[13][i]); }
  // far_apart(record i of this block as p, record j of `q`)
  template <int M>
  __device__ __forceinline__ bool far_from(int i, const RecordBlock<M>& q, int j) const {
    return far_apart(v[8][i], v[9][i], v[10][i], v[11][i], q.v[8][j], q.v[9][j], q.v[10][j]);
  }
};

// A CTA's queue of the pairs that need the clip, appended a warp at a time:
// the lanes with `take` write `entry` at consecutive slots. Every lane of the
// warp calls it.
__device__ __forceinline__ void enqueue(bool take, unsigned short entry, unsigned short* queue, int* count) {
  const unsigned mask = __ballot_sync(0xffffffffu, take);
  if (mask == 0u) return;
  const int lane = threadIdx.x & 31, leader = __ffs(mask) - 1;
  int at = 0;
  if (lane == leader) at = atomicAdd(count, __popc(mask));
  at = __shfl_sync(0xffffffffu, at, leader);
  if (take) queue[at + __popc(mask & ((1u << lane) - 1u))] = entry;
}

}  // namespace rotated
