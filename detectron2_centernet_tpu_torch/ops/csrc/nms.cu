// Fixed-K greedy non-maximum suppression on Hopper (sm_90a): sorted
// candidates, a suppression bitmask, many CTAs a row. One pipeline for two
// kinds of boxes: axis-aligned XYXY boxes (`nms_sorted`) and rotated
// (cx, cy, w, h, angle) boxes with an optional class per candidate
// (`nms_rotated_sorted`, R2), the kernels templated on the box kind.
//
// Replaces no Pallas kernel. The JAX package's `nms_fixed`
// (detectron2_centernet_tpu/ops/nms.py) is a `lax.fori_loop` of K picks over
// jnp, vmapped over rows, which the TPU compiles into one program. Its eager
// PyTorch counterpart (`ops/nms.py::nms_fixed`, the plain version here)
// launches ~25 small kernels a pick; this pipeline takes a handful of
// launches a call, whatever K.
//
// The rotated kind replaces the JAX package's `nms_rotated_fixed`
// (detectron2_centernet_tpu/ops/roi_align_rotated.py:147-180), the same
// argmax loop with the rotated IoU of `iou_rotated.cuh` (the pick the
// clipped subject) and, with classes, suppression only within the pick's
// class (a same-class mask, not the coordinate-offset trick); its plain
// version is `ops/roi_align_rotated.py::nms_rotated_fixed`.
//
// What it computes, for every row r of `cands` candidates (boxes f32,
// scores f32 with -inf for a dead candidate) and picks p < min(max_out[r], k):
//   keep[r, p]  = the index of the first maximal live score;
//   valid[r, p] = that score > -inf;
// then every live candidate whose IoU with the pick is > thr (and, for
// rotated boxes with classes, whose class is the pick's) dies, and the
// pick itself. Once no candidate lives, the remaining slots are (0, false),
// as `jnp.argmax` over an all -inf row gives index 0; so are the slots at
// or past max_out[r]. NaN scores are outside the contract (the argmax loop
// and this pipeline order them differently).
//
// Why sorting gives the same picks. Order the live candidates by (score
// descending, index ascending), `-0.0` folded into `+0.0` as the loop's
// comparisons treat them. Then a candidate is picked exactly when no earlier
// picked candidate suppresses it: by induction, the loop's next pick is the
// first candidate in this order that no pick so far suppressed, and every
// candidate before it was picked or suppressed by an earlier pick. Each IoU
// is the loop's: pick first, `inter / max((area_pick + area) - inter,
// 1e-12)` where the union is > 0, else 0, every step rounded on its own (the
// `__f*_rn` intrinsics, which the compiler never contracts into an FMA, and
// IEEE division); the rotated IoU likewise (`-fmad=false`). So only the
// sorted prefix up to a row's last pick matters.
//
// The pipeline, per round, over every row still at work (`nms_sorted`):
//   1. select: each live score becomes an order-preserving 32-bit key; the
//      key packed over the index is a 64-bit word whose ascending order is
//      the pick order. Radix-select (11 bits a pass, the row split over CTAs
//      of 8192 candidates, per-CTA histograms merged in global memory) the
//      kChunk-th word after the last chunk's, then compact the chunk's words;
//   2. sort the chunk in one CTA's shared memory (bitonic) and gather its
//      boxes and areas;
//   3. per panel of the sorted chunk (256, 256, 512, ... candidates): the
//      suppression bitmask of the panel in 64 x 64 tiles of its upper
//      triangle, bit (i, j), i < j, = iou(box_i, box_j) > thr, and one word
//      per 64 candidates of the panel for the picks kept so far (earlier
//      panels, earlier chunks) that suppress them, both over many CTAs;
//   4. scan the panel with one warp per row: keep candidate i when its bit
//      is clear in the running "removed" words, OR row i's words in, write
//      keep / valid in pick order, and stop at the row's count.
// A row whose count is reached, or whose chunk held all its live candidates,
// is done; the others take the next chunk. The card decides that, so the
// host never waits for it: the host launches the first round, and when a
// row holds more than kChunk candidates, `nms_next`, one thread that reads
// how many rows go on and, if any, tail-launches the next round and itself
// (CUDA dynamic parallelism: a tail launch runs once the grid before it and
// its launches end, and work queued after the call waits for all of them).
// A panel's kernels return at once for a row whose scan ended before it, so
// the bitmask is built only up to the panel that holds the row's last pick.
//
// What bounds it on this card: reading every score once per selection pass
// (LVIS's 16 x 1.2 M candidates are 77 MB, past the 50 MB L2), ~20 f32
// operations per IoU of the tiles and of (kept pick, later candidate)
// pairs (~400 per rotated IoU of boxes whose circles overlap, ~15 for the
// others), and the scan's dependent steps: one warp per row, one shuffle
// per kept candidate, one load of a 64-candidate block's words at a time.
//
// The rotated kind's bitmask (`nms_mask_rotated`): the sort makes each
// sorted candidate's record once (corners, diagonal, area, class:
// `iou_rotated.cuh`), the scan copies it with each pick, so a pair does no
// trigonometry and no square root. Its work items are kRotRows x 64
// pairs, a quarter of a tile or kRotRows kept picks against 64 candidates,
// which a row's CTAs (kRotThreads each) take in turn: every thread tests
// its share of an item's classes, circles and edge normals (`far_apart`,
// `separated`: exact, see `iou_rotated.cuh`), queues the pairs that need
// the clip, and then every thread clips queued pairs (a warp's lanes clip
// together, not behind the one lane whose pair overlaps), so that even
// one RRPN row of 6000 candidates spreads over the card.

#include <cuda_runtime.h>
#include <cmath>
#include <cstdio>

#include "iou_rotated.cuh"

namespace {

constexpr int kChunk = 8192;        // T: sorted candidates a round takes from a row (64 KB of words in shared memory)
constexpr int kDigit = 11;          // radix-select bits a pass
constexpr int kBins = 1 << kDigit;
constexpr int kSeg = 8192;          // candidates per CTA in the row-wide passes
constexpr int kSegThreads = 256;
constexpr int kNumPanels = 6;       // panels of the sorted chunk: [0, 256), [256, 512), [512, 1024), ... [4096, 8192)
constexpr int kSlice = 256;         // kept picks per CTA when a panel is checked against them
constexpr int kRotThreads = 128;    // threads of a rotated bitmask CTA
constexpr int kRotRows = 16;        // rows of a rotated bitmask work item: a quarter tile, or kept picks
constexpr int kRotCtas = 2048;      // rotated bitmask CTAs a panel, about, over every row
constexpr int kRotCtasPerSm = 5;    // in 88 registers (112 with no minimum: 4 CTAs an SM; 6 spills)
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kAll = ~0ull;

// Panel p's first position in the sorted chunk (p = kNumPanels: the chunk's end).
__host__ __device__ constexpr int panel_start(int p) { return p == 0 ? 0 : 128 << p; }

static_assert(panel_start(kNumPanels) == kChunk, "the panels cover the chunk");

struct RowState {
  unsigned long long bound;   // the last chunk's largest word (when has_bound): this round takes words above it
  unsigned long long prefix;  // selection: the digits fixed so far
  unsigned long long lim;     // this chunk: the words <= lim (kAll: all that remain)
  unsigned long long last;    // this chunk's largest word
  int has_bound, active, selecting, shift, need, n, picks, kept, scanning, pos;
};

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f), fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

// IoU of the pick `a` (area `area_a`) with `b` (area `area_b`), as the plain version rounds it.
__device__ __forceinline__ float iou_with(float4 a, float area_a, float4 b, float area_b) {
  const float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(w, h);
  if (inter == 0.f) return 0.f;  // what the division gives, without it
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.f ? __fdiv_rn(inter, fmaxf(uni, 1e-12f)) : 0.f;
}

// The two kinds of boxes. Each loads a candidate's box from the input and
// gives its area (the scan records it with the pick); the axis kind says
// whether a pick suppresses a candidate (`nms_mask`).
struct AxisBoxes {
  using Box = float4;
  static constexpr bool kRotated = false;
  const float4* boxes;
  __device__ __forceinline__ Box load(size_t i) const { return boxes[i]; }
  __device__ static __forceinline__ float area(const Box& b) { return area_of(b); }
  __device__ static __forceinline__ bool suppresses(const Box& pick, float pick_area, const Box& b, float b_area,
                                                    float thr) {
    return iou_with(pick, pick_area, b, b_area) > thr;
  }
};

// A rotated candidate is its record (`iou_rotated.cuh`), made once by the
// sort; its bitmask is `nms_mask_rotated`'s.
struct RotatedBoxes {
  using Box = rotated::Record;
  static constexpr bool kRotated = true;
  const float* boxes;  // (rows * cands, 5)
  const int* classes;  // (rows * cands,), or null: one class
  __device__ __forceinline__ Box load(size_t i) const {
    return rotated::make_record(rotated::load_box(boxes + i * 5), classes != nullptr ? classes[i] : 0);
  }
  __device__ static __forceinline__ float area(const Box& b) { return b.area; }
};

// The word of a live score `v` at index `i`: ascending words are descending
// scores, ties by ascending index; -0.0 is +0.0.
__device__ __forceinline__ unsigned long long word_of(float v, int i, int idx_bits) {
  unsigned bits = __float_as_uint(v);
  if ((bits << 1) == 0u) bits = 0u;
  const unsigned key = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  return (static_cast<unsigned long long>(~key) << idx_bits) | static_cast<unsigned>(i);
}

__device__ __forceinline__ bool in_round(float v, const RowState& st, int i, int idx_bits,
                                         unsigned long long* word) {
  if (!(v > -INFINITY)) return false;
  *word = word_of(v, i, idx_bits);
  return !st.has_bound || *word > st.bound;
}

__device__ __forceinline__ void start_round(RowState* st, int select, int total_bits) {
  st->selecting = select;
  st->shift = total_bits;
  st->prefix = 0;
  st->need = 0;
  st->lim = kAll;
  st->n = 0;
  st->scanning = 0;
  st->pos = 0;
}

// Per row: the pick count, the outputs zeroed, the histogram zeroed, the
// row's first chunk counted.
__global__ void __launch_bounds__(256) nms_init(const int* __restrict__ max_out, RowState* __restrict__ state,
                                                unsigned* __restrict__ hist, long long* __restrict__ keep,
                                                bool* __restrict__ valid, unsigned long long* __restrict__ chunks,
                                                int k, int select, int total_bits) {
  const int r = blockIdx.x;
  for (int p = threadIdx.x; p < k; p += blockDim.x) {
    keep[static_cast<size_t>(r) * k + p] = 0;
    valid[static_cast<size_t>(r) * k + p] = false;
  }
  for (int b = threadIdx.x; b < kBins; b += blockDim.x) hist[static_cast<size_t>(r) * kBins + b] = 0u;
  if (threadIdx.x == 0) {
    RowState* st = state + r;
    const int picks = max_out != nullptr ? min(max_out[r], k) : k;
    st->picks = picks;
    st->kept = 0;
    st->has_bound = 0;
    st->bound = 0;
    st->last = 0;
    st->active = picks > 0;
    start_round(st, select, total_bits);
    if (picks > 0) atomicAdd(chunks, 1ull);
  }
}

// Stage 1a: the histogram of the next digit of the round's words that share
// the digits fixed so far; grid (segments, rows).
__global__ void __launch_bounds__(kSegThreads) nms_hist(const float* __restrict__ scores,
                                                        const RowState* __restrict__ state,
                                                        unsigned* __restrict__ hist, int cands, int idx_bits) {
  const int r = blockIdx.y;
  const RowState st = state[r];
  if (!st.active || !st.selecting) return;
  __shared__ unsigned h[kBins];
  const int w = min(kDigit, st.shift), bins = 1 << w;
  for (int b = threadIdx.x; b < bins; b += blockDim.x) h[b] = 0u;
  __syncthreads();
  const float* s = scores + static_cast<size_t>(r) * cands;
  const int begin = blockIdx.x * kSeg, end = min(cands, begin + kSeg);
  for (int i = begin + threadIdx.x; i < end; i += blockDim.x) {
    unsigned long long u;
    if (!in_round(s[i], st, i, idx_bits, &u) || (u >> st.shift) != st.prefix) continue;
    atomicAdd(&h[(u >> (st.shift - w)) & static_cast<unsigned long long>(bins - 1)], 1u);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < bins; b += blockDim.x)
    if (h[b]) atomicAdd(&hist[static_cast<size_t>(r) * kBins + b], h[b]);
}

// Stage 1b: one CTA of 256 per row finds the digit bucket that holds the
// chunk's last word, and zeroes the histogram. On a round's first pass
// (`need` 0) the histogram's total is the row's remaining live candidates:
// at most kChunk of them and the chunk takes them all.
__global__ void __launch_bounds__(256) nms_choose(RowState* __restrict__ state, unsigned* __restrict__ hist) {
  const int r = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  RowState* st = state + r;
  const int active = st->active, selecting = st->selecting, shift = st->shift;
  const unsigned long long prefix = st->prefix;
  unsigned need = static_cast<unsigned>(st->need);
  if (!active || !selecting) return;
  const int w = min(kDigit, shift), bins = 1 << w;
  unsigned* h = hist + static_cast<size_t>(r) * kBins;
  unsigned v[kBins / 256], sum = 0;
#pragma unroll
  for (int j = 0; j < kBins / 256; ++j) {
    const int b = tid * (kBins / 256) + j;
    v[j] = b < bins ? h[b] : 0u;
    sum += v[j];
  }
  unsigned incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  __shared__ unsigned warp_sums[8];
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  unsigned total = 0;
  for (int x = 0; x < 8; ++x) {
    if (x < warp) incl += warp_sums[x];
    total += warp_sums[x];
  }
  const unsigned excl = incl - sum;
#pragma unroll
  for (int j = 0; j < kBins / 256; ++j) {
    const int b = tid * (kBins / 256) + j;
    if (b < bins) h[b] = 0u;
  }
  if (need == 0) {  // the round's first pass
    if (total <= static_cast<unsigned>(kChunk)) {
      if (tid == 0) {
        st->lim = kAll;
        st->selecting = 0;
      }
      return;
    }
    need = kChunk;
  }
  if (!(excl < need && need <= incl)) return;  // one thread holds the bucket
  unsigned before = excl;
  for (int j = 0; j < kBins / 256; ++j) {
    if (before + v[j] >= need) {
      const unsigned long long p = (prefix << w) | static_cast<unsigned long long>(tid * (kBins / 256) + j);
      const int rest = shift - w;
      const unsigned rank = need - before;
      if (v[j] == rank || rest == 0) {  // the whole bucket is in the chunk
        st->lim = (p << rest) | ((1ull << rest) - 1ull);
        st->selecting = 0;
      } else {
        st->prefix = p;
        st->shift = rest;
        st->need = static_cast<int>(rank);
      }
      return;
    }
    before += v[j];
  }
}

// Stage 1c: the chunk's words (the round's words <= lim), unordered; grid
// (segments, rows).
__global__ void __launch_bounds__(kSegThreads) nms_compact(const float* __restrict__ scores,
                                                           RowState* __restrict__ state,
                                                           unsigned long long* __restrict__ words, int cands, int m,
                                                           int idx_bits) {
  const int r = blockIdx.y, lane = threadIdx.x & 31;
  const RowState st = state[r];
  if (!st.active) return;
  const float* s = scores + static_cast<size_t>(r) * cands;
  const int begin = blockIdx.x * kSeg, end = min(cands, begin + kSeg);
  for (int base = begin; base < end; base += blockDim.x) {
    const int i = base + threadIdx.x;
    unsigned long long u = 0;
    const bool take = i < end && in_round(s[i], st, i, idx_bits, &u) && u <= st.lim;
    const unsigned mask = __ballot_sync(kFull, take);
    if (mask == 0u) continue;
    const int leader = __ffs(mask) - 1;
    int at = 0;
    if (lane == leader) at = atomicAdd(&state[r].n, __popc(mask));
    at = __shfl_sync(kFull, at, leader);
    if (take) words[static_cast<size_t>(r) * m + at + __popc(mask & ((1u << lane) - 1u))] = u;
  }
}

// Stage 2: one CTA of 1024 per row sorts its chunk's words ascending
// (bitonic, in shared memory) and gathers the boxes and areas in that order.
// Also zeroes the row's "removed" words and the count of rows going on.
template <class B>
__global__ void __launch_bounds__(1024) nms_sort(const B src, RowState* __restrict__ state,
                                                 const unsigned long long* __restrict__ words,
                                                 int* __restrict__ sidx, typename B::Box* __restrict__ sbox,
                                                 float* __restrict__ sarea, unsigned long long* __restrict__ removed,
                                                 int* __restrict__ going_on, int cands, int m, int nbw,
                                                 int idx_bits) {
  extern __shared__ unsigned long long sw[];
  const int r = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  if (r == 0 && tid == 0) *going_on = 0;
  RowState* st = state + r;
  if (!st->active) return;
  const int n = st->n;
  for (int x = tid; x < nbw; x += nt) removed[static_cast<size_t>(r) * nbw + x] = 0ull;
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  for (int t = tid; t < n2; t += nt) sw[t] = t < n ? words[static_cast<size_t>(r) * m + t] : kAll;
  __syncthreads();
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < n2; t += nt) {
        const int o = t ^ stride;
        if (o > t) {
          const unsigned long long a = sw[t], b = sw[o];
          if ((a > b) == ((t & size) == 0)) {
            sw[t] = b;
            sw[o] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  const unsigned long long idx_mask = (1ull << idx_bits) - 1ull;
  for (int p = tid; p < n; p += nt) {
    const int i = static_cast<int>(sw[p] & idx_mask);
    const typename B::Box b = src.load(static_cast<size_t>(r) * cands + i);
    sidx[static_cast<size_t>(r) * m + p] = i;
    sbox[static_cast<size_t>(r) * m + p] = b;
    sarea[static_cast<size_t>(r) * m + p] = B::area(b);
  }
  if (tid == 0) {
    if (n > 0) st->last = sw[n - 1];
    st->scanning = 1;
    st->pos = 0;
  }
}

// Stage 3, for the panel [p0, p1) of the sorted chunk: grid (tiles +
// suppression blocks, rows), 64 threads. The first npb * npb blocks are the
// panel's 64 x 64 tiles (bi, bj), blocks counted from the panel's start,
// those with bj >= bi computed: bit c of mask[i][bj] for candidate i of
// block bi is iou(i, j) > thr, j the c-th of block bj, j > i (a row of the
// bitmask holds the words of its panel only: pw of them, the widest panel
// the chunk reaches). The others check the panel's block bi against a
// slice of kSlice picks kept so far (their boxes and areas as the scan
// recorded them) and OR the bits of the candidates they suppress into
// removed[bi].
template <class B>
__global__ void __launch_bounds__(64) nms_mask(const RowState* __restrict__ state,
                                               const typename B::Box* __restrict__ kbox,
                                               const float* __restrict__ karea,
                                               const typename B::Box* __restrict__ sbox,
                                               const float* __restrict__ sarea, unsigned long long* __restrict__ mask,
                                               unsigned long long* __restrict__ removed, int m, int nbw, int pw, int k,
                                               int p0, int p1, float thr) {
  using Box = typename B::Box;
  __shared__ Box cb[64];
  __shared__ float ca[64];
  __shared__ unsigned halves[2];
  const int r = blockIdx.y, tid = threadIdx.x;
  const RowState st = state[r];
  if (!st.active || !st.scanning || st.pos != p0 || st.n <= p0) return;
  const int n = min(st.n, p1), pb0 = p0 / 64, npb = (p1 - p0) / 64, nb = (n - p0 + 63) / 64;
  const Box* sb = sbox + static_cast<size_t>(r) * m;
  const float* sa = sarea + static_cast<size_t>(r) * m;
  const int x = blockIdx.x;
  if (x < npb * npb) {
    const int bi = x / npb, bj = x % npb;
    if (bj < bi || bj >= nb) return;
    const int j = p0 + bj * 64 + tid, i = p0 + bi * 64 + tid;
    if (j < n) {
      cb[tid] = sb[j];
      ca[tid] = sa[j];
    }
    __syncthreads();
    if (i >= n) return;
    const Box a = sb[i];
    const float aa = sa[i];
    const int cmax = min(64, n - (p0 + bj * 64));
    unsigned long long bits = 0ull;
    for (int c = bi == bj ? tid + 1 : 0; c < cmax; ++c)
      if (B::suppresses(a, aa, cb[c], ca[c], thr)) bits |= 1ull << c;
    mask[(static_cast<size_t>(r) * m + i) * pw + bj] = bits;
    return;
  }
  const int bi = (x - npb * npb) % npb, slice = (x - npb * npb) / npb;
  const int q0 = slice * kSlice, q1 = min(st.kept, q0 + kSlice);
  if (bi >= nb || q0 >= q1) return;
  const int i = p0 + bi * 64 + tid;
  const Box b = i < n ? sb[i] : Box{};
  const float ba = i < n ? sa[i] : 0.f;
  bool gone = false;
  for (int q = q0; q < q1; q += 64) {
    __syncthreads();
    if (q + tid < q1) {
      cb[tid] = kbox[static_cast<size_t>(r) * k + q + tid];
      ca[tid] = karea[static_cast<size_t>(r) * k + q + tid];
    }
    __syncthreads();
    const int qn = min(64, q1 - q);
    for (int c = 0; c < qn && !gone; ++c) gone = i < n && B::suppresses(cb[c], ca[c], b, ba, thr);
  }
  const unsigned half = __ballot_sync(kFull, gone && i < n);
  if ((tid & 31) == 0) halves[tid >> 5] = half;
  __syncthreads();
  if (tid == 0 && (halves[0] | halves[1]))
    atomicOr(&removed[static_cast<size_t>(r) * nbw + pb0 + bi],
             static_cast<unsigned long long>(halves[0]) | (static_cast<unsigned long long>(halves[1]) << 32));
}

// Stage 3 for rotated boxes, for the panel [p0, p1): nms_mask's outputs,
// kRotThreads a CTA, gridDim.x CTAs a row sharing the row's work items in
// turn. An item is kRotRows rows against 64 columns: a quarter of a tile
// (rows of block bi, columns of block bj >= bi), or kRotRows kept picks
// against the panel's block bi; the rows are the subjects. Each thread
// tests its pairs' classes, circles and edge normals, the pairs left go to
// the CTA's queue, and the threads clip the queue's pairs; a set bit goes into the
// row's word in shared memory (for kept picks, the candidate's, whose pairs
// are skipped once some pick suppressed it).
__global__ void __launch_bounds__(kRotThreads, kRotCtasPerSm)
    nms_mask_rotated(const RowState* __restrict__ state, const rotated::Record* __restrict__ kbox,
                     const rotated::Record* __restrict__ sbox, unsigned long long* __restrict__ mask,
                     unsigned long long* __restrict__ removed, int m, int nbw, int pw, int k, int p0, int p1,
                     float thr) {
  constexpr int kParts = 64 / kRotRows;  // items a tile
  __shared__ rotated::RecordBlock<kRotRows> rows;
  __shared__ rotated::RecordBlock<64> cols;
  __shared__ float2 scratch[kRotThreads / 32][2][rotated::kMaxVertices];  // a warp's, for the general clip
  __shared__ unsigned short queue[kRotRows * 64];
  __shared__ unsigned bits[kRotRows][2];
  __shared__ int count;
  const int r = blockIdx.y, tid = threadIdx.x;
  const RowState st = state[r];
  if (!st.active || !st.scanning || st.pos != p0 || st.n <= p0) return;
  const int n = min(st.n, p1), pb0 = p0 / 64, nb = (n - p0 + 63) / 64;
  const int tiles = nb * (nb + 1) / 2 * kParts, items = tiles + nb * ((st.kept + kRotRows - 1) / kRotRows);
  const rotated::Record* sb = sbox + static_cast<size_t>(r) * m;
  volatile unsigned long long* gone = removed + static_cast<size_t>(r) * nbw + pb0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const bool tile = item < tiles;
    int bi, row0, nr, col0;
    bool diagonal = false;  // a tile on the diagonal: only the pairs j > i
    const rotated::Record* row_src;
    if (tile) {
      int t = item / kParts;
      bi = 0;
      while (t >= nb - bi) {  // the upper triangle, row by row: row bi holds nb - bi tiles
        t -= nb - bi;
        ++bi;
      }
      row0 = p0 + bi * 64 + item % kParts * kRotRows;
      row_src = sb + row0;
      nr = min(kRotRows, n - row0);
      col0 = p0 + (bi + t) * 64;
      diagonal = t == 0;
    } else {
      const int x = item - tiles, q0 = x / nb * kRotRows;
      bi = x % nb;
      row0 = q0;
      row_src = kbox + static_cast<size_t>(r) * k + q0;
      nr = min(kRotRows, st.kept - q0);
      col0 = p0 + bi * 64;
    }
    if (nr <= 0) continue;  // a tile's last rows past the chunk's end
    const int nc = min(64, n - col0);
    __syncthreads();  // the last item's shared arrays are read
    if (tid < kRotRows) {
      if (tid < nr) rows.put(tid, row_src[tid]);
      bits[tid][0] = bits[tid][1] = 0u;
    } else if (tid == kRotRows) {
      count = 0;
    }
    if (tid >= 64 && tid - 64 < nc) cols.put(tid - 64, sb[col0 + tid - 64]);
    __syncthreads();
    for (int q = tid; q < kRotRows * 64; q += kRotThreads) {
      const int i = q >> 6, j = q & 63;
      const bool take = i < nr && j < nc && (!diagonal || col0 + j > row0 + i) && rows.cls(i) == cols.cls(j)
                        && !rows.far_from(i, cols, j) && !rotated::separated(rows.get(i), cols.get(j));
      rotated::enqueue(take, static_cast<unsigned short>(q), queue, &count);
    }
    __syncthreads();
    const int queued = count;
    for (int e0 = tid & ~31; e0 < queued; e0 += kRotThreads) {  // a warp's lanes together
      const int e = e0 + (tid & 31), i = e < queued ? queue[e] >> 6 : 0, j = e < queued ? queue[e] & 63 : 0;
      bool take = e < queued;
      if (take && !tile)  // a candidate some kept pick suppressed already needs no more
        take = !((*reinterpret_cast<volatile unsigned*>(&bits[0][j >> 5]) >> (j & 31) & 1u)
                 || (gone[bi] >> j & 1ull));
      if (rotated::near_iou(take, rows.get(i), cols.get(j), scratch[tid >> 5]) > thr && take)
        atomicOr(&bits[tile ? i : 0][j >> 5], 1u << (j & 31));
    }
    __syncthreads();
    if (tile) {
      if (tid < nr)
        mask[(static_cast<size_t>(r) * m + row0 + tid) * pw + (col0 - p0) / 64] =
            static_cast<unsigned long long>(bits[tid][0]) | (static_cast<unsigned long long>(bits[tid][1]) << 32);
    } else if (tid == 0 && (bits[0][0] | bits[0][1])) {
      atomicOr(&removed[static_cast<size_t>(r) * nbw + pb0 + bi],
               static_cast<unsigned long long>(bits[0][0]) | (static_cast<unsigned long long>(bits[0][1]) << 32));
    }
  }
}

// The CTAs a row's `nms_mask_rotated` takes for the panel [p0, p1): its
// most work items (every tile and every slice of the picks that can be
// kept before p0), at most about kRotCtas over the rows.
__host__ __device__ int rotated_mask_ctas(int rows, int k, int p0, int p1) {
  const int npb = (p1 - p0) / 64, kept = k < p0 ? k : p0;
  const int items = npb * (npb + 1) / 2 * (64 / kRotRows) + npb * ((kept + kRotRows - 1) / kRotRows);
  const int cap = (kRotCtas + rows - 1) / rows;
  return items < cap ? items : cap;
}

// Stage 4, for the panel [p0, p1): one warp per row walks the panel's
// blocks of 64 in order. Lane l holds the panel's "removed" words l and
// l + 32; a block's own words (the tile on the diagonal) are loaded while
// the block before is walked. Only the block's candidates whose own word is
// not empty can remove a later one, so the walk visits those that are
// still open, one shuffle each; every other open candidate is kept, and the
// kept ones past the row's count are dropped. The kept rows' words for the
// panel's later blocks are ORed in after the block, and the kept picks'
// boxes and areas recorded for the next panels' and chunks' suppression.
// At the row's count, or at the end of its chunk, the round ends for the
// row: it goes on to the next chunk when it still has picks to make and the
// chunk did not hold all its live candidates.
template <class B>
__global__ void __launch_bounds__(32) nms_scan(RowState* __restrict__ state,
                                               const unsigned long long* __restrict__ mask,
                                               const unsigned long long* __restrict__ removed,
                                               const int* __restrict__ sidx,
                                               const typename B::Box* __restrict__ sbox,
                                               const float* __restrict__ sarea, long long* __restrict__ keep,
                                               bool* __restrict__ valid, typename B::Box* __restrict__ kbox,
                                               float* __restrict__ karea, int* __restrict__ going_on, int m, int nbw,
                                               int pw, int k, int p0, int p1, int total_bits) {
  const int r = blockIdx.x, lane = threadIdx.x;
  RowState* st = state + r;
  const int active = st->active, scanning = st->scanning, pos = st->pos, n_all = st->n, picks = st->picks;
  if (!active || !scanning || pos != p0) return;
  const int n = min(n_all, p1), pb0 = p0 / 64, nb = n > p0 ? (n - p0 + 63) / 64 : 0;
  int kept = st->kept;
  const unsigned long long* rem = removed + static_cast<size_t>(r) * nbw + pb0;
  unsigned long long r0 = lane < nb ? rem[lane] : 0ull, r1 = lane + 32 < nb ? rem[lane + 32] : 0ull;
  const unsigned long long* mrow = mask + static_cast<size_t>(r) * m * pw;
  const int* ids = sidx + static_cast<size_t>(r) * m;
  const size_t sat = static_cast<size_t>(r) * m, kat = static_cast<size_t>(r) * k;
  auto diag = [&](int blk, int at) {  // word `blk` of the block's candidate at + lane
    const int i = p0 + blk * 64 + at + lane;
    return blk < nb && i < n ? mrow[static_cast<size_t>(i) * pw + blk] : 0ull;
  };
  unsigned long long n0 = diag(0, 0), n1 = diag(0, 32);
  for (int blk = 0; blk < nb && kept < picks; ++blk) {
    const int i0 = p0 + blk * 64, cnt = min(64, n - i0);
    const unsigned long long d0 = n0, d1 = n1;
    n0 = diag(blk + 1, 0);
    n1 = diag(blk + 1, 32);
    unsigned long long cur = __shfl_sync(kFull, blk < 32 ? r0 : r1, blk & 31);
    const unsigned long long in_block = cnt == 64 ? kAll : (1ull << cnt) - 1ull;
    const unsigned long long heavy = static_cast<unsigned long long>(__ballot_sync(kFull, d0 != 0ull))
                                     | (static_cast<unsigned long long>(__ballot_sync(kFull, d1 != 0ull)) << 32);
    unsigned long long open = heavy & ~cur & in_block;
    while (open != 0ull) {  // b, the lowest open one, is kept: bits of d are above it
      const int b = __ffsll(static_cast<long long>(open)) - 1;
      cur |= __shfl_sync(kFull, b < 32 ? d0 : d1, b & 31);
      open = open & (open - 1ull) & ~cur;
    }
    unsigned long long taken = ~cur & in_block;
    while (__popcll(taken) > picks - kept) taken &= ~(1ull << (63 - __clzll(static_cast<long long>(taken))));
    const int got = __popcll(taken);
    for (int b = lane; b < 64; b += 32) {
      if ((taken >> b) & 1ull) {
        const int rank = kept + __popcll(taken & ((1ull << b) - 1ull));
        keep[kat + rank] = ids[i0 + b];
        valid[kat + rank] = true;
        kbox[kat + rank] = sbox[sat + i0 + b];
        karea[kat + rank] = sarea[sat + i0 + b];
      }
    }
    kept += got;
    if (taken == 0ull) continue;
    for (int h = 0; h < 2; ++h) {
      const int wd = lane + 32 * h;
      if (wd <= blk || wd >= nb) continue;
      unsigned long long acc = 0ull;
#pragma unroll
      for (int b = 0; b < 64; ++b)
        if ((taken >> b) & 1ull) acc |= mrow[static_cast<size_t>(i0 + b) * pw + wd];
      if (h == 0) r0 |= acc;
      else r1 |= acc;
    }
  }
  if (lane != 0) return;
  st->kept = kept;
  if (kept < picks && n < n_all) {
    st->pos = p1;  // the next panel goes on
    return;
  }
  if (kept < picks && st->lim != kAll) {  // the chunk did not hold every live candidate: the next one
    st->has_bound = 1;
    st->bound = st->last;
    start_round(st, 1, total_bits);
    atomicAdd(going_on, 1);
  } else {
    st->active = 0;
    st->scanning = 0;
  }
}

// What one round's launches take.
template <class B>
struct Round {
  B box;
  const float* score;
  RowState* state;
  unsigned* hist;
  unsigned long long *words, *removed, *mask, *chunks;
  int* sidx;
  typename B::Box *sbox, *kbox;
  float *sarea, *karea;
  int* going_on;
  long long* keep;
  bool* valid;
  int rows, cands, k, m, nbw, pw, segs, slices, passes, idx_bits, total_bits, sort_bytes;
  float thr;
};

// One round's launches into `stream`: the selection passes (none when every
// row's chunk holds all its candidates), the compaction, the sort, and each
// panel's bitmask and scan. From the host for the first round; from
// `nms_next` into its tail-launch stream for the others. Returns the first
// launch's error.
template <class B>
__host__ __device__ int launch_round(const Round<B>& a, cudaStream_t stream) {
#define NMS_CHECK()                                   \
  do {                                                \
    const cudaError_t e = cudaGetLastError();         \
    if (e != cudaSuccess) return static_cast<int>(e); \
  } while (0)
  for (int p = 0; p < a.passes; ++p) {
    nms_hist<<<dim3(a.segs, a.rows), kSegThreads, 0, stream>>>(a.score, a.state, a.hist, a.cands, a.idx_bits);
    NMS_CHECK();
    nms_choose<<<a.rows, 256, 0, stream>>>(a.state, a.hist);
    NMS_CHECK();
  }
  nms_compact<<<dim3(a.segs, a.rows), kSegThreads, 0, stream>>>(a.score, a.state, a.words, a.cands, a.m,
                                                                 a.idx_bits);
  NMS_CHECK();
  nms_sort<B><<<a.rows, 1024, a.sort_bytes, stream>>>(a.box, a.state, a.words, a.sidx, a.sbox, a.sarea, a.removed,
                                                   a.going_on, a.cands, a.m, a.nbw, a.idx_bits);
  NMS_CHECK();
  for (int p = 0; p < kNumPanels && panel_start(p) < a.m; ++p) {
    const int p0 = panel_start(p), p1 = panel_start(p + 1), npb = (p1 - p0) / 64;
    if constexpr (B::kRotated) {
      nms_mask_rotated<<<dim3(rotated_mask_ctas(a.rows, a.k, p0, p1), a.rows), kRotThreads, 0, stream>>>(
          a.state, a.kbox, a.sbox, a.mask, a.removed, a.m, a.nbw, a.pw, a.k, p0, p1, a.thr);
    } else {
      nms_mask<B><<<dim3(npb * npb + npb * a.slices, a.rows), 64, 0, stream>>>(
          a.state, a.kbox, a.karea, a.sbox, a.sarea, a.mask, a.removed, a.m, a.nbw, a.pw, a.k, p0, p1, a.thr);
    }
    NMS_CHECK();
    nms_scan<B><<<a.rows, 32, 0, stream>>>(a.state, a.mask, a.removed, a.sidx, a.sbox, a.sarea, a.keep, a.valid,
                                        a.kbox, a.karea, a.going_on, a.m, a.nbw, a.pw, a.k, p0, p1, a.total_bits);
    NMS_CHECK();
  }
#undef NMS_CHECK
  return 0;
}

// After a round, one thread: when rows go on, count their chunks and
// tail-launch the next round, then itself. A launch the card refuses traps,
// which fails the stream, rather than leave rows short of their picks.
template <class B>
__global__ void nms_next(Round<B> a) {
  const int more = *a.going_on;
  if (more == 0) return;
  atomicAdd(a.chunks, static_cast<unsigned long long>(more));
  int err = launch_round(a, cudaStreamTailLaunch);
  if (err == 0) {
    nms_next<B><<<1, 1, 0, cudaStreamTailLaunch>>>(a);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err != 0) {
    printf("nms_next: a tail launch failed with CUDA error %d\n", err);
    __trap();
  }
}

struct Layout {
  size_t state, hist, words, sidx, sbox, sarea, removed, mask, kbox, karea, going_on, total;
};

size_t align256(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

// The bitmask's words a candidate: those of the widest panel that holds a
// chunk position < m (the panels widen along the chunk).
int panel_words(int m) {
  int p = 0;
  while (p + 1 < kNumPanels && panel_start(p + 1) < m) ++p;
  return (panel_start(p + 1) - panel_start(p)) / 64;
}

Layout layout_of(int rows, int cands, int k, size_t box_bytes) {
  const size_t m = cands < kChunk ? cands : kChunk, nbw = (m + 63) / 64, R = rows, pw = panel_words(static_cast<int>(m));
  Layout L{};
  size_t at = 0;
  auto take = [&at](size_t bytes) {
    const size_t here = at;
    at += align256(bytes);
    return here;
  };
  L.state = take(R * sizeof(RowState));
  L.hist = take(R * kBins * sizeof(unsigned));
  L.words = take(R * m * sizeof(unsigned long long));
  L.sidx = take(R * m * sizeof(int));
  L.sbox = take(R * m * box_bytes);
  L.sarea = take(R * m * sizeof(float));
  L.removed = take(R * nbw * sizeof(unsigned long long));
  L.mask = take(R * m * pw * sizeof(unsigned long long));
  L.kbox = take(R * static_cast<size_t>(k) * box_bytes);
  L.karea = take(R * static_cast<size_t>(k) * sizeof(float));
  L.going_on = take(sizeof(int));
  L.total = at;
  return L;
}

// One call: the scratch laid out, every row's state initialised, the first
// round launched from the host and, when rows hold more than a chunk,
// `nms_next` behind it.
template <class B>
int run_nms(const B src, const void* scores, const void* max_out, void* scratch, void* keep, void* valid, int rows,
            int cands, int k, float thr, void* chunks, cudaStream_t stream) {
  if (rows <= 0 || k <= 0) return 0;
  const Layout L = layout_of(rows, cands, k, sizeof(typename B::Box));
  char* base = static_cast<char*>(scratch);
  int idx_bits = 1;
  while (idx_bits < 31 && (1ll << idx_bits) < cands) ++idx_bits;
  const int select = cands > kChunk, m = cands < kChunk ? cands : kChunk;
  int n2 = 1;
  while (n2 < m) n2 <<= 1;
  Round<B> a{};
  a.box = src;
  a.score = static_cast<const float*>(scores);
  a.state = reinterpret_cast<RowState*>(base + L.state);
  a.hist = reinterpret_cast<unsigned*>(base + L.hist);
  a.words = reinterpret_cast<unsigned long long*>(base + L.words);
  a.removed = reinterpret_cast<unsigned long long*>(base + L.removed);
  a.mask = reinterpret_cast<unsigned long long*>(base + L.mask);
  a.chunks = static_cast<unsigned long long*>(chunks);
  a.sidx = reinterpret_cast<int*>(base + L.sidx);
  a.sbox = reinterpret_cast<typename B::Box*>(base + L.sbox);
  a.kbox = reinterpret_cast<typename B::Box*>(base + L.kbox);
  a.sarea = reinterpret_cast<float*>(base + L.sarea);
  a.karea = reinterpret_cast<float*>(base + L.karea);
  a.going_on = reinterpret_cast<int*>(base + L.going_on);
  a.keep = static_cast<long long*>(keep);
  a.valid = static_cast<bool*>(valid);
  a.rows = rows;
  a.cands = cands;
  a.k = k;
  a.m = m;
  a.nbw = (m + 63) / 64;
  a.pw = panel_words(m);
  a.segs = (cands + kSeg - 1) / kSeg;
  a.slices = (k + kSlice - 1) / kSlice;
  a.idx_bits = idx_bits;
  a.total_bits = 32 + idx_bits;
  a.passes = select ? (a.total_bits + kDigit - 1) / kDigit : 0;
  a.sort_bytes = n2 * static_cast<int>(sizeof(unsigned long long));
  a.thr = thr;
  if (a.sort_bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(nms_sort<B>, cudaFuncAttributeMaxDynamicSharedMemorySize, a.sort_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_init<<<rows, 256, 0, stream>>>(static_cast<const int*>(max_out), a.state, a.hist, a.keep, a.valid, a.chunks, k,
                                     select, a.total_bits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || cands <= 0) return static_cast<int>(err);
  const int first = launch_round(a, stream);
  if (first != 0 || !select) return first;  // without selection every row's chunk held all its live candidates
  nms_next<B><<<1, 1, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The bytes of scratch `nms_sorted` needs for (rows, cands, k), into *out (a long long).
int nms_scratch_bytes(int rows, int cands, int k, void* out) {
  *static_cast<long long*>(out) = static_cast<long long>(layout_of(rows, cands, k, sizeof(float4)).total);
  return 0;
}

// The bytes of scratch `nms_rotated_sorted` needs for (rows, cands, k), into *out (a long long).
int nms_rotated_scratch_bytes(int rows, int cands, int k, void* out) {
  *static_cast<long long*>(out) =
      static_cast<long long>(layout_of(rows, cands, k, sizeof(RotatedBoxes::Box)).total);
  return 0;
}

// boxes (rows, cands, 4) f32 and scores (rows, cands) f32, contiguous, boxes
// 16-byte aligned; max_out (rows,) int32, or null for k picks in every row;
// scratch: nms_scratch_bytes(rows, cands, k) bytes, 256-byte aligned; keep
// (rows, k) int64 and valid (rows, k) bool, written in full; chunks, one
// unsigned long long on the card, gets the chunks the rows take added to it.
// The call never waits for the card: the rounds after the first are the
// card's to launch (`nms_next`).
int nms_sorted(const void* boxes, const void* scores, const void* max_out, void* scratch, void* keep, void* valid,
               int rows, int cands, int k, float thr, void* chunks, cudaStream_t stream) {
  return run_nms(AxisBoxes{static_cast<const float4*>(boxes)}, scores, max_out, scratch, keep, valid, rows, cands, k,
                 thr, chunks, stream);
}

// `nms_sorted` for rotated boxes (rows, cands, 5) f32 (cx, cy, w, h, angle
// in degrees), contiguous, with classes (rows, cands) int32 (suppression
// only within a class), or null; scratch: nms_rotated_scratch_bytes(rows,
// cands, k) bytes.
int nms_rotated_sorted(const void* boxes, const void* classes, const void* scores, const void* max_out,
                       void* scratch, void* keep, void* valid, int rows, int cands, int k, float thr, void* chunks,
                       cudaStream_t stream) {
  return run_nms(RotatedBoxes{static_cast<const float*>(boxes), static_cast<const int*>(classes)}, scores, max_out,
                 scratch, keep, valid, rows, cands, k, thr, chunks, stream);
}

}  // extern "C"
