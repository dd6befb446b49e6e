// Fixed-K greedy non-maximum suppression on Hopper (sm_90a), one CTA per
// row of candidates.
//
// Replaces: the JAX package's `nms_fixed` (detectron2_centernet_tpu/ops/nms.py,
// a `lax.fori_loop` of K picks over jnp, vmapped over rows). That loop is not
// a Pallas kernel; on the TPU it compiles into one on-device program. Its
// eager PyTorch counterpart (`ops/nms.py::nms_fixed`, the plain version
// here) launches ~25 small kernels per pick, so 1000 picks of an RPN level
// cost ~25k launches. This kernel runs the whole K-pick loop in one launch.
//
// What it computes, for every row r of `cands` candidates (boxes XYXY f32,
// scores f32 with -inf for a dead candidate) and picks p < min(max_out[r], k):
//   keep[r, p]  = the index of the first maximal live score;
//   valid[r, p] = that score > -inf;
// then every live candidate whose IoU with the pick is > thr dies, and the
// pick itself. Once no candidate lives, the remaining slots are (0, false),
// as `jnp.argmax` over an all -inf row gives index 0; so are the slots at
// or past max_out[r].
//
// Exact picks: the IoU is computed in the JAX package's (and the plain
// version's) operation order, `inter / max((area1 + areas) - inter, 1e-12)`
// where the union is > 0, else 0, every step rounded on its own: the
// `__f*_rn` intrinsics, which the compiler never contracts into an FMA, and
// IEEE division. Ties go to the lower index, as `argmax` breaks them.
//
// What bounds it: the picks are sequential, and each pick must read every
// live candidate's score and box (20 bytes) and compute its IoU with the
// last pick (~20 f32 operations), then agree on one argmax across the CTA.
// So the CTA first compacts its row's live candidates (score > -inf), in
// index order, into shared memory with their boxes and indices (24 bytes
// each) when they fit (<= kSharedCands: RetinaNet's 4441 per image, the
// RPN's <= 2000 per level, and the box head's live (proposal, class) pairs
// of its 80 000 when the score threshold leaves few); the picks then sweep
// only those. A row with more live candidates than that works in place, in
// global memory and L2 (its scores copied to a scratch row), dead ones
// skipped. Per pick the design does one sweep, in which each thread
// suppresses its own candidates against the last pick and keeps its best
// survivor, then one block reduction (warp shuffles, then one warp over the
// warps' results): two __syncthreads per pick. Compaction keeps index order,
// so ties by position are ties by index. With one CTA per row the grid is as
// wide as the rows (16 to 80 here): a first design that is right; using
// more of the card per row is later work.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace {

constexpr int kSharedCands = 9216;  // 24 bytes each (box, score, index): 221 184 bytes of shared memory
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f), fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

// IoU of the pick `a` (area `area_a`) with `b`, as the plain version rounds it.
__device__ __forceinline__ float iou_with(float4 a, float area_a, float4 b) {
  const float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_of(b)), inter);
  return uni > 0.f ? __fdiv_rn(inter, fmaxf(uni, 1e-12f)) : 0.f;
}

__device__ __forceinline__ void warp_argmax(float& bv, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(kFull, bv, off);
    const int oi = __shfl_down_sync(kFull, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
}

// The CTA's sum of `v` (every thread gets it); `scratch` holds 32 ints.
__device__ __forceinline__ int block_sum(int v, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < warps; ++w) total += scratch[w];
  __syncthreads();
  return total;
}

// Blocks of 256, 512 or 1024 threads (whole warps); dynamic shared memory of
// `shared_cap` boxes, scores and indices.
__global__ void __launch_bounds__(1024) nms_kernel(
    const float4* __restrict__ boxes, const float* __restrict__ scores, const int* __restrict__ max_out,
    float* __restrict__ live_global, long long* __restrict__ keep, bool* __restrict__ valid, int cands,
    int k, float thr, int shared_cap) {
  extern __shared__ float4 smem[];
  __shared__ float warp_v[32];
  __shared__ int warp_i[32];
  __shared__ float pick_v;
  __shared__ int pick_i;

  const int r = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, warps = nt >> 5;
  const float4* box_g = boxes + static_cast<size_t>(r) * cands;
  const float* score_g = scores + static_cast<size_t>(r) * cands;
  long long* keep_r = keep + static_cast<size_t>(r) * k;
  bool* valid_r = valid + static_cast<size_t>(r) * k;
  for (int p = tid; p < k; p += nt) {
    keep_r[p] = 0;
    valid_r[p] = false;
  }
  int alive = 0;
  for (int i = tid; i < cands; i += nt) alive += score_g[i] > -INFINITY;
  alive = block_sum(alive, warp_i);

  const float4* box;  // the candidates the picks sweep: n of them,
  float* live;        // candidate c being index[c] of the row (c itself without `index`)
  const int* index = nullptr;
  int n;
  if (alive <= shared_cap) {  // compact the live ones, in index order
    float4* sbox = smem;
    float* sscore = reinterpret_cast<float*>(smem + shared_cap);
    int* sindex = reinterpret_cast<int*>(sscore + shared_cap);
    int offset = 0;
    for (int base = 0; base < cands; base += nt) {
      const int i = base + tid;
      const float v = i < cands ? score_g[i] : -INFINITY;
      const bool on = v > -INFINITY;
      const unsigned mask = __ballot_sync(kFull, on);
      if (lane == 0) warp_i[warp] = __popc(mask);
      __syncthreads();
      int before = offset + __popc(mask & ((1u << lane) - 1u)), chunk = 0;
      for (int w = 0; w < warps; ++w) {
        before += w < warp ? warp_i[w] : 0;
        chunk += warp_i[w];
      }
      if (on) {
        sbox[before] = box_g[i];
        sscore[before] = v;
        sindex[before] = i;
      }
      offset += chunk;
      __syncthreads();  // warp_i is written again
    }
    box = sbox;
    live = sscore;
    index = sindex;
    n = alive;
  } else {  // in place: the scores copied to the scratch row, dead ones skipped
    live = live_global + static_cast<size_t>(r) * cands;
    for (int i = tid; i < cands; i += nt) live[i] = score_g[i];
    box = box_g;
    n = cands;
  }
  const int picks = max_out != nullptr ? min(max_out[r], k) : k;
  __syncthreads();

  int j = -1;  // the last pick, as a position in the swept candidates
  float4 bj = make_float4(0.f, 0.f, 0.f, 0.f);
  float area_j = 0.f;
  for (int p = 0; p < picks; ++p) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int c = tid; c < n; c += nt) {
      const float v = live[c];
      if (!(v > -INFINITY)) continue;
      if (j >= 0 && (c == j || iou_with(bj, area_j, box[c]) > thr)) {
        live[c] = -INFINITY;
        continue;
      }
      if (better(v, c, bv, bi)) {
        bv = v;
        bi = c;
      }
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      warp_v[warp] = bv;
      warp_i[warp] = bi;
    }
    __syncthreads();
    if (tid < 32) {
      bv = tid < warps ? warp_v[tid] : -INFINITY;
      bi = tid < warps ? warp_i[tid] : INT_MAX;
      warp_argmax(bv, bi);
      if (tid == 0) {
        pick_v = bv;
        pick_i = bi;
      }
    }
    __syncthreads();
    if (!(pick_v > -INFINITY)) break;  // nothing lives: the rest stay (0, false)
    j = pick_i;
    if (tid == 0) {
      keep_r[p] = index != nullptr ? index[j] : j;
      valid_r[p] = true;
    }
    bj = box[j];
    area_j = area_of(bj);
  }
}

}  // namespace

extern "C" {

// The most live candidates a row may have to run from shared memory.
int nms_fixed_shared_cap() { return kSharedCands; }

// boxes (rows, cands, 4) f32 and scores (rows, cands) f32, contiguous, boxes
// 16-byte aligned; max_out (rows,) int32, or null for k picks in every row;
// live: (rows, cands) f32 scratch for rows with more live candidates than
// fit in shared memory (may be null when cands <= nms_fixed_shared_cap());
// keep (rows, k) int64 and valid (rows, k) bool, written in full.
int nms_fixed(const void* boxes, const void* scores, const void* max_out, void* live, void* keep, void* valid,
              int rows, int cands, int k, float thr, cudaStream_t stream) {
  if (rows <= 0 || k <= 0) return 0;
  const int threads = cands <= 2048 ? 256 : cands <= 8192 ? 512 : 1024;
  const int shared_cap = cands < kSharedCands ? cands : kSharedCands;
  const size_t bytes = static_cast<size_t>(shared_cap) * (sizeof(float4) + sizeof(float) + sizeof(int));
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_kernel<<<rows, threads, bytes, stream>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores), static_cast<const int*>(max_out),
      static_cast<float*>(live), static_cast<long long*>(keep), static_cast<bool*>(valid), cands, k, thr,
      shared_cap);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
