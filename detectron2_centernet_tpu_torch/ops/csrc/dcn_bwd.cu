// Deformable 3x3 convolution (DCNv2; DCNv1 without a mask) backward for
// Hopper (sm_90a): two kernel bodies and a reduction behind four entry points.
//
// Replaces the TPU kernels of detectron2_centernet_tpu/ops/pallas_dcn.py:
//   dcn_bwd_dx   <- _bwd_dx_kernel   (dX: col2im of W^T g)
//   dcn_bwd_dq   <- _bwd_dq_kernel   (d offset, d mask)
//   dcn_bwd_dw   <- _bwd_dw_kernel   (dW)
//   dcn_bwd_dqdw <- _bwd_dqdw_kernel (d offset, d mask and dW on one gather)
// Same functions, exact DCNv2 semantics: every sample is bilinear with zero
// padding wherever its offset points (the TPU kernels drop samples beyond
// |dy| > 3), and the corners are the floor corners of the reference im2col,
// so d offset is the right derivative at integer sample positions.
//
// Layout: x (N, Cin, H, W); offset (N, 18, Ho, Wo) f32 with offset[2t] = dy
// and offset[2t+1] = dx for tap t in row-major (ky, kx) order, mask
// (N, 9, Ho, Wo) f32 (already sigmoided), weight (Cout, Cin, 3, 3), g = dL/dout
// (N, Cout, Ho, Wo), Ho = (H - 1) / s + 1 at stride s and dilation d in
// {1, 2} (padding d): output pixel (i, j), tap (ky, kx) samples x at
// (i*s - d + ky*d + dy, j*s - d + kx*d + dx), as the JAX package's exact op
// computes the ResNet trunks' deformable 3x3. A null mask is a mask of ones
// (DCNv1): never read, and no d mask is written. dX is x's size; d offset and
// d mask are at output pixels. x, weight and g share one type T: float or
// __nv_bfloat16.
// Rows of the column matrix are k = c * 9 + tap, the order of a flattened
// OIHW weight. Both bodies take channels in chunks of CK = 16 (BK = 144 rows).
//
// What bounds them. The least time is set by the two contractions
// (2 * 9 * Cin * Cout FLOPs per pixel each) at batch 32 and by the bytes of
// x, g and the outputs at small maps. The first version of these kernels was
// held back instead by global f32 atomics (dX: 4 per sample, 36 per channel
// and pixel; dW: every block added its whole Cout x 144 product per chunk
// into one buffer), grids of a few blocks at small maps (one block per 64
// pixels walked all of Cin alone) and one or two 4-warp blocks per SM. Cutting
// phases out of the kernels on the H100 (the numbers are in PERF.md, Findings)
// showed what held the redesign back in turn, and each point below answers
// one: f32 atomics on shared memory are compare-and-swap loops there
// (ATOMS.CAST.SPIN); scattered 2-byte x loads waited out their latency with
// 16 in flight per thread; a shared load after a shared store or atomic waits
// for it, since the two may alias; 128-byte tile rows put the eight rows of a
// WMMA fragment load in the same banks. What bounds both now, at a few per
// cent of the least time: the latency of the sampling phases between a
// block's barriers at 8 warps per SM, and the global atomics (d offset and d
// mask; dX's flush). tools/dcn_phases.py times the kernels with each
// phase cut out.
//
// dcn_bwd_wq_kernel (K3, K4, K5). A block owns one channel chunk, one Cout
// tile of BM = 64 and a span of consecutive 64-pixel tiles of the output
// (a tile never crosses an image). The grid is chunks x Cout tiles x splits; the wrapper
// picks the span (ops/dcn.py::bwd_plan) so that the grid is about two waves
// of the card at every shape. Per tile: the g tile comes in with cp.async
// while the block builds the sampling table of its 9 x 64 samples and, where
// at least 3/4 of them fall in it, the x window (the chunk's channels over
// the input rows and columns the tile's rigid samples reach, widened by 2
// pixels, read once and coalesced; at stride 2 it is too large for the shapes
// of the R-CNN trunks, whose samples all read x directly);
//   (dq) dcol[144][64] = W_tile^T g_tile on the tensor cores (the W tile is
//        loaded once per block), then one gather of the four corners of every
//        (channel, tap, pixel) sample, from the window or, 32 loads in flight
//        per thread, from x, gives the modulated column tile (dW) and the
//        d(ly), d(lx), d(mask) sums over the chunk's channels (dq);
//   (dw) dW_tile[64][144] += g_tile col^T, kept in registers across the span.
// dW: each block writes its product once into a [splits][Cout][9 Cin] f32
// partial buffer; sum_splits_kernel adds the splits in a fixed order and
// writes dW in T. No atomics: dW is the same bit for bit from run to run.
// d offset, d mask: a block holds the sum over its 16 channels and its Cout
// tile; it adds that once per (tap, pixel) into the zeroed f32 outputs with
// an atomic. Those land on 27 distinct addresses per pixel, from
// Cin/16 x Cout/64 blocks; a partial buffer would cost 27 x 4 bytes per pixel
// and block (226 MB at batch 32, 64 channels, 128^2), so atomics were chosen.
//
// dcn_bwd_dx_kernel (K2). A block owns an 8 x 8 tile of output pixels, one
// channel chunk and one image; chunks need no reduction across blocks (dX of
// channel c depends only on the dcol rows of c), so the grid is tiles x
// chunks x images (at 16^2, batch 1, Cin 512: 4 x 32 blocks). dcol[144][64]
// = W_chunk^T g_tile runs over Cout in slices of 32, both operands
// double-buffered with cp.async. The scatter adds dcol * mask * corner weight
// into a 24 x 24 shared-memory tile of the chunk's 16 channels over the
// input footprint of the output tile (at stride 1 the tile's pixels with a
// halo of R = 8; at stride 2 its 15 x 15 rigid footprint with a halo of
// R / 2 = 4, so an output tile's samples land around its own input tile at
// either stride), in int32 fixed point with a power-of-two scale per
// channel (native shared atomics; see the scatter); a sample whose corners
// leave the haloed tile goes to a global f32 atomic directly, so any offset
// and dilation is exact. Corners of weight exactly 0 (three of four at the zero offsets
// every DCN starts training with) issue nothing. The block then adds the
// nonzero cells of its haloed tile that lie on the map into dX, four at a
// time with one vector atomic.
//
// Tensor cores: bf16 WMMA 16x16x16 with f32 accumulation (mma.sync); f32
// operands take the FMA pipes. wgmma is not used: the two products are about
// a fifth of K5's time on the H100 and under a tenth of K2's, the sampling
// phases over half of each (tools/dcn_phases.py; PERF.md, Findings), and a
// 64 x 144 wgmma tile would want the gathered column tile in its
// core-matrix layout. Both bodies hold two 4-warp
// blocks per SM in bf16 (8 warps; under 113 KB of shared memory each, at most
// 255 registers): dcn_bwd_info reports the shared memory and blocks per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int BN = 64;        // pixels per tile
constexpr int CK = 16;        // input channels per chunk
constexpr int BK = CK * 9;    // rows of the column matrix per chunk
constexpr int BM = 64;        // Cout tile of K3-K5
constexpr int CO = 32;        // Cout slice of K2's contraction
constexpr int THREADS = 128;  // four warps
constexpr int PAIRS = 9 * BN;                            // (tap, pixel) samples of a tile
constexpr int PAIRS_PER_THREAD = (PAIRS + THREADS - 1) / THREADS;
constexpr int TH = 8, TW = 8;                            // K2's 2-D pixel tile
constexpr int R = 8;                                     // K2's halo at stride 1 (R / 2 at stride 2)
constexpr int HH = TH + 2 * R, HWD = TW + 2 * R;         // haloed tile
static_assert(TH * TW == BN, "K2's tile has BN pixels");
// Padded row strides of the shared tiles (elements): rows 16 bytes apart
// modulo 128, so the eight rows a WMMA fragment load reads fall in distinct
// banks (64 bf16 = 128 bytes a row would put all eight in the same banks).
constexpr int LDP = BN + 8;   // T tiles with BN pixel columns: g, col
constexpr int LDW = BK + 8;   // T tiles with BK columns: W
constexpr int LDF = BN + 4;   // f32 dcol [BK][LDF]
constexpr int LDS = BK + 4;   // f32 dW stage [BM][LDS]
constexpr int XR = 3;         // K3-K5's x window: the rigid reach (+- dilation) + XR - 1
constexpr int XCAP = 512;     // cells of the x window per channel (7 x 70 at W >= 64)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

constexpr size_t align128(size_t b) { return (b + 127) / 128 * 128; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// One sample of the table at output pixel (oy, ox) of the Wo-wide, hwo-pixel
// output grid: (ly, lx, mask, code) with code = (y0 + 1) << 16 | (x0 + 1) for
// the floor corner (y0, x0) in x, or -1 where every corner is padding and the
// sample has no gradient. Outside [-1, H) x [-1, W) that is so; at py = -1
// exactly the corner y0 + 1 = 0 carries d offset (the right derivative), so
// -1 stays in. The test also keeps huge offsets away from the float -> int
// conversion. A null mask reads as 1.
__device__ __forceinline__ float4 sample_entry(const float* off_n, const float* msk_n, int hwo,
                                               int wo, int h, int w, int stride, int dilation,
                                               int tap, int oy, int ox) {
  const int p = oy * wo + ox;
  const float py = (float)(oy * stride - dilation + tap / 3 * dilation) + off_n[(size_t)(2 * tap) * hwo + p];
  const float px = (float)(ox * stride - dilation + tap % 3 * dilation) + off_n[(size_t)(2 * tap + 1) * hwo + p];
  float4 f = make_float4(0.f, 0.f, msk_n != nullptr ? msk_n[(size_t)tap * hwo + p] : 1.f, __int_as_float(-1));
  if (py >= -1.f && py < (float)h && px >= -1.f && px < (float)w) {
    const float fy = floorf(py);
    const float fx = floorf(px);
    f.x = py - fy;
    f.y = px - fx;
    f.w = __int_as_float((((int)fy + 1) << 16) | ((int)fx + 1));
  }
  return f;
}

// ---------------------------------------------------------------------------
// K3, K4, K5: d offset / d mask (DQ) and dW (DW) over a span of pixel tiles.

template <typename T, bool DQ, bool DW>
struct WqSmem {
  static constexpr size_t tab = 0;                                         // float4 [PAIRS]
  static constexpr size_t wt = tab + align128(PAIRS * sizeof(float4));     // T [BM][LDW]
  static constexpr size_t gt = wt + (DQ ? align128(BM * LDW * sizeof(T)) : 0);  // T [BM][LDP]
  static constexpr size_t col = gt + align128(BM * LDP * sizeof(T));      // T [BK][LDP]
  static constexpr size_t win = col + (DW ? align128(BK * LDP * sizeof(T)) : 0);  // T [CK][XCAP]
  static constexpr size_t dcol = win + align128(CK * XCAP * sizeof(T));
  // f32 [BK][LDF] dcol (DQ); at the end the [BM][LDS] stage of dW (DW)
  static constexpr size_t count = dcol + align128(BK * LDF * sizeof(float));  // int
  static constexpr size_t bytes = count + 128;
};
static_assert(BM * LDS <= BK * LDF, "the dW stage reuses the dcol region");

template <typename T, bool DQ, bool DW>
__global__ void __launch_bounds__(THREADS, 2)
dcn_bwd_wq_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                  const float* __restrict__ mask, const T* __restrict__ weight,
                  const T* __restrict__ g, float* __restrict__ doffset,
                  float* __restrict__ dmask, float* __restrict__ partial, int cin, int h, int w,
                  int ho, int wo, int stride, int dilation, int cout, int tiles_per_image,
                  int ntiles, int span) {
  using S = WqSmem<T, DQ, DW>;
  extern __shared__ __align__(128) unsigned char smem[];
  float4* tab = reinterpret_cast<float4*>(smem + S::tab);
  T* wt = reinterpret_cast<T*>(smem + S::wt);
  T* gt = reinterpret_cast<T*>(smem + S::gt);
  T* col = reinterpret_cast<T*>(smem + S::col);
  T* win = reinterpret_cast<T*>(smem + S::win);
  float* dcol = reinterpret_cast<float*>(smem + S::dcol);
  int* count = reinterpret_cast<int*>(smem + S::count);

  constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;
  constexpr int VEC = 16 / sizeof(T);
  const int hw = h * w;     // x's plane
  const int hwo = ho * wo;  // the output grid's: g, offset, mask
  const int kdim = cin * 9;
  const int c0 = blockIdx.x * CK;
  const int lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * BM;
  const int t_begin = blockIdx.z * span;
  const int t_end = min(t_begin + span, ntiles);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const bool g_vec = hwo % VEC == 0 && aligned16(g);

  // g[m0 .. m0+BM][tile t's 64 pixels] -> dst, zero outside Cout and the map
  auto load_g = [&](T* dst, int t) {
    const int img = t / tiles_per_image;
    const int p0 = (t - img * tiles_per_image) * BN;
    const T* g_n = g + (size_t)img * cout * hwo;
    for (int e = tid; e < BM * BN / VEC; e += THREADS) {
      const int r = e / (BN / VEC);
      const int pv = (e - r * (BN / VEC)) * VEC;
      const int co = m0 + r;
      const int p = p0 + pv;
      T* d = dst + r * LDP + pv;
      if (g_vec && co < cout && p < hwo) {
        cp_async16(d, g_n + (size_t)co * hwo + p);
      } else {
        for (int i = 0; i < VEC; ++i)
          d[i] = (co < cout && p + i < hwo) ? g_n[(size_t)co * hwo + p + i] : from_f32<T>(0.f);
      }
    }
  };

  if constexpr (DQ) {  // the W tile, once per block
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK;
      const int kk = e - r * BK;
      const int co = m0 + r;
      wt[r * LDW + kk] = (co < cout && c0 + kk / 9 < cin) ? weight[(size_t)co * kdim + c0 * 9 + kk]
                                                          : from_f32<T>(0.f);
    }
  }

  // dW_tile[BM][BK] across the span: warp `warp` owns rows warp*16 .. +16
  // (tensor cores), or thread tid rows (tid/8)*4 .. +4, columns tid%8 + 8j
  using namespace nvcuda;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[DW && kTensorCores ? BK / 16 : 1];
  float facc[DW && !kTensorCores ? 4 : 1][DW && !kTensorCores ? BK / 8 : 1];
  if constexpr (DW) {
    if constexpr (kTensorCores) {
#pragma unroll
      for (int i = 0; i < BK / 16; ++i) wmma::fill_fragment(acc[i], 0.f);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) facc[i][j] = 0.f;
    }
  }

  for (int t = t_begin; t < t_end; ++t) {
    __syncthreads();  // the last tile's readers of gt, col, dcol, tab and win are done
    load_g(gt, t);  // cp.async: lands while the table and the x window are built
    cp_async_commit();

    const int img = t / tiles_per_image;
    const int p0 = (t - img * tiles_per_image) * BN;
    const float* off_n = offset + (size_t)img * 18 * hwo;
    const float* msk_n = mask != nullptr ? mask + (size_t)img * 9 * hwo : nullptr;
    const T* x_n = x + (size_t)img * cin * hw;
    // The x window: the chunk's channels over the input rows and columns the
    // tile's rigid samples reach (its output rows and columns times the
    // stride, +- the dilation), widened by XR - 1 (zero off the map), read
    // once, coalesced, so that the gather below reads shared memory; a sample
    // with a corner outside it reads x directly. At stride 1, dilation 1 and
    // W >= 64 the tile is part of one row: 7 x 70 cells. It is loaded only
    // where at least 3/4 of the tile's samples fall in it (a warp with one
    // sample outside waits for that sample's loads anyway).
    const int reach = dilation + XR - 1;
    const int p1 = min(p0 + BN, hwo) - 1;
    const int ry0 = p0 / wo, ry1 = p1 / wo;
    const int wy0 = ry0 * stride - reach;
    const int wx0 = (ry0 == ry1 ? (p0 - ry0 * wo) * stride : 0) - reach;
    const int wh = (ry1 - ry0) * stride + 1 + 2 * reach;
    const int ww = (ry0 == ry1 ? (p1 - p0) * stride + 1 : w) + 2 * reach;
    int inside = 0;
    for (int e = tid; e < PAIRS; e += THREADS) {
      const int tap = e / BN;
      const int p = p0 + (e - tap * BN);
      const float4 f = p < hwo ? sample_entry(off_n, msk_n, hwo, wo, h, w, stride, dilation, tap, p / wo, p % wo)
                               : make_float4(0.f, 0.f, 0.f, __int_as_float(-1));
      tab[e] = f;
      const int code = __float_as_int(f.w);
      const int wy = (code >> 16) - 1 - wy0, wx = (code & 0xffff) - 1 - wx0;
      inside += code >= 0 && wy >= 0 && wy + 1 < wh && wx >= 0 && wx + 1 < ww;
    }
    if (tid == 0) *count = 0;
    __syncthreads();  // the count is zeroed; the table is in
    if (inside) atomicAdd(count, inside);
    __syncthreads();
    const bool use_win = wh * ww <= XCAP && 4 * *count >= 3 * PAIRS;
    if (use_win) {
      // a warp per window row, 32 lanes along it (ww <= XCAP / 7 < 96), and
      // WROWS rows' loads in flight before their stores
      constexpr int WROWS = 4;
      for (int row0 = warp; row0 < CK * wh; row0 += WROWS * (THREADS / 32)) {
        T v[WROWS][3];
#pragma unroll
        for (int u = 0; u < WROWS; ++u) {
          const int row = row0 + u * (THREADS / 32);
          const int cc = row / wh;
          const int gy = wy0 + row - cc * wh;
          const bool row_in = row < CK * wh && c0 + cc < cin && gy >= 0 && gy < h;
          const T* xr = x_n + (size_t)(c0 + cc) * hw + (size_t)gy * w;
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const int gx = wx0 + lane + 32 * k;
            v[u][k] = (row_in && lane + 32 * k < ww && gx >= 0 && gx < w) ? xr[gx] : from_f32<T>(0.f);
          }
        }
#pragma unroll
        for (int u = 0; u < WROWS; ++u) {
          const int row = row0 + u * (THREADS / 32);
          const int cc = row / wh;
#pragma unroll
          for (int k = 0; k < 3; ++k)
            if (row < CK * wh && lane + 32 * k < ww)
              win[cc * XCAP + (row - cc * wh) * ww + lane + 32 * k] = v[u][k];
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();  // tile t's g, the table and the x window are in

    // dcol[BK][BN] = W_tile^T g_tile
    if constexpr (DQ) {
      if constexpr (kTensorCores) {
        // warp `warp` owns pixel columns warp*16 .. +16 of all 9 row blocks;
        // wt read as column-major (BK x BM) is W^T
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> dacc[BK / 16];
#pragma unroll
        for (int i = 0; i < BK / 16; ++i) wmma::fill_fragment(dacc[i], 0.f);
#pragma unroll
        for (int ks = 0; ks < BM / 16; ++ks) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(b, gt + ks * 16 * LDP + warp * 16, LDP);
#pragma unroll
          for (int i = 0; i < BK / 16; ++i) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a;
            wmma::load_matrix_sync(a, wt + ks * 16 * LDW + i * 16, LDW);
            wmma::mma_sync(dacc[i], a, b, dacc[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < BK / 16; ++i)
          wmma::store_matrix_sync(dcol + i * 16 * LDF + warp * 16, dacc[i], LDF, wmma::mem_row_major);
      } else {
        for (int e = tid; e < BK * BN; e += THREADS) {
          const int kk = e / BN;
          const int pl = e - kk * BN;
          float s = 0.f;
          for (int r = 0; r < BM; ++r) s += to_f32(wt[r * LDW + kk]) * to_f32(gt[r * LDP + pl]);
          dcol[kk * LDF + pl] = s;
        }
      }
      __syncthreads();  // dcol is in
    }

    // One gather of the corners of every (channel, tap, pixel) sample.
    for (int j = 0; j < PAIRS_PER_THREAD; ++j) {
      const int e = tid + j * THREADS;
      if (e >= PAIRS) break;
      const int tap = e / BN;
      const int pl = e - tap * BN;
      const float4 f = tab[e];
      const int code = __float_as_int(f.w);
      int i00 = -1, i01 = -1, i10 = -1, i11 = -1;
      int wbase = -1;  // the corner (y0, x0) in the window, when all four are in it
      if (code >= 0) {
        const int y0 = (code >> 16) - 1;
        const int x0 = (code & 0xffff) - 1;
        const int wy = y0 - wy0, wx = x0 - wx0;
        if (use_win && wy >= 0 && wy + 1 < wh && wx >= 0 && wx + 1 < ww) wbase = wy * ww + wx;
        const bool y0_in = y0 >= 0, y1_in = y0 + 1 < h;
        const bool x0_in = x0 >= 0, x1_in = x0 + 1 < w;
        const int base = y0 * w + x0;
        if (y0_in && x0_in) i00 = base;
        if (y0_in && x1_in) i01 = base + 1;
        if (y1_in && x0_in) i10 = base + w;
        if (y1_in && x1_in) i11 = base + w + 1;
      }
      const float ly = f.x, lx = f.y, m = f.z;
      const float hy = 1.f - ly, hx = 1.f - lx;
      float a_ly = 0.f, a_lx = 0.f, a_m = 0.f;
      // the corners of GC channels at a time: from the window, or from x with
      // all 4 * GC loads in flight before the first is used
      constexpr int GC = CK / 2;
#pragma unroll
      for (int c1 = 0; c1 < CK; c1 += GC) {
        T raw[GC][4];
        if (wbase >= 0) {
#pragma unroll
          for (int u = 0; u < GC; ++u) {
            const T* wc = win + (c1 + u) * XCAP + wbase;
            raw[u][0] = wc[0];
            raw[u][1] = wc[1];
            raw[u][2] = wc[ww];
            raw[u][3] = wc[ww + 1];
          }
        } else {
#pragma unroll
          for (int u = 0; u < GC; ++u) {
            const bool c_in = c0 + c1 + u < cin;
            const T* xc = x_n + (size_t)(c0 + c1 + u) * hw;
            raw[u][0] = c_in && i00 >= 0 ? xc[i00] : from_f32<T>(0.f);
            raw[u][1] = c_in && i01 >= 0 ? xc[i01] : from_f32<T>(0.f);
            raw[u][2] = c_in && i10 >= 0 ? xc[i10] : from_f32<T>(0.f);
            raw[u][3] = c_in && i11 >= 0 ? xc[i11] : from_f32<T>(0.f);
          }
        }
        // dcol before the col stores below, which it may alias
        float dq[GC];
        if constexpr (DQ) {
#pragma unroll
          for (int u = 0; u < GC; ++u) dq[u] = dcol[((c1 + u) * 9 + tap) * LDF + pl];
        }
#pragma unroll
        for (int u = 0; u < GC; ++u) {
          const int cc = c1 + u;
          const int c = c0 + cc;
          const int kk = cc * 9 + tap;
          if (c >= cin) {
            if constexpr (DW) col[kk * LDP + pl] = from_f32<T>(0.f);
            continue;
          }
          const float v00 = to_f32(raw[u][0]), v01 = to_f32(raw[u][1]);
          const float v10 = to_f32(raw[u][2]), v11 = to_f32(raw[u][3]);
          const float s = hy * (hx * v00 + lx * v01) + ly * (hx * v10 + lx * v11);
          if constexpr (DW) col[kk * LDP + pl] = from_f32<T>(m * s);
          if constexpr (DQ) {
            const float d = dq[u];
            a_ly += d * (hx * (v10 - v00) + lx * (v11 - v01));
            a_lx += d * (hy * (v01 - v00) + ly * (v11 - v10));
            a_m += d * s;
          }
        }
      }
      // d offset = mask * d(ly, lx) (py = oy*s - d + ky*d + dy, so d py = d
      // ly); d mask = the sum over channels of dcol * the unmodulated sample,
      // written only where there is a mask
      if constexpr (DQ) {
        const int p = p0 + pl;
        if (p < hwo) {
          float* doff_n = doffset + (size_t)img * 18 * hwo;
          const float oy_ = m * a_ly, ox_ = m * a_lx;
          if (oy_ != 0.f) atomicAdd(doff_n + (size_t)(2 * tap) * hwo + p, oy_);
          if (ox_ != 0.f) atomicAdd(doff_n + (size_t)(2 * tap + 1) * hwo + p, ox_);
          if (dmask != nullptr) {
            if (a_m != 0.f) atomicAdd(dmask + ((size_t)img * 9 + tap) * hwo + p, a_m);
          }
        }
      }
    }

    // dW_tile[BM][BK] += g_tile[BM][BN] col^T
    if constexpr (DW) {
      __syncthreads();  // col is in
      if constexpr (kTensorCores) {
        // col read as column-major (BN x BK) is col^T
#pragma unroll
        for (int ks = 0; ks < BN / 16; ++ks) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::load_matrix_sync(a, gt + warp * 16 * LDP + ks * 16, LDP);
#pragma unroll
          for (int i = 0; i < BK / 16; ++i) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
            wmma::load_matrix_sync(b, col + i * 16 * LDP + ks * 16, LDP);
            wmma::mma_sync(acc[i], a, b, acc[i]);
          }
        }
      } else {
        const int r0 = (tid / 8) * 4;
        const int k0 = tid % 8;
        for (int pl = 0; pl < BN; ++pl) {
          float gv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) gv[i] = to_f32(gt[(r0 + i) * LDP + pl]);
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
            const float cv = to_f32(col[(k0 + 8 * j) * LDP + pl]);
#pragma unroll
            for (int i = 0; i < 4; ++i) facc[i][j] += gv[i] * cv;
          }
        }
      }
    }
  }

  // This block's dW product, written once into its split of the partial buffer.
  if constexpr (DW) {
    float* part = partial + (size_t)blockIdx.z * cout * kdim;
    if constexpr (kTensorCores) {
      float* stage = dcol;  // [BM][LDS]
      __syncthreads();      // the last tile's dcol is read
#pragma unroll
      for (int i = 0; i < BK / 16; ++i)
        wmma::store_matrix_sync(stage + warp * 16 * LDS + i * 16, acc[i], LDS, wmma::mem_row_major);
      __syncthreads();
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int r = e / BK;
        const int kk = e - r * BK;
        const int co = m0 + r;
        if (co < cout && c0 + kk / 9 < cin) part[(size_t)co * kdim + c0 * 9 + kk] = stage[r * LDS + kk];
      }
    } else {
      const int r0 = (tid / 8) * 4;
      const int k0 = tid % 8;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const int co = m0 + r0 + i;
          const int kk = k0 + 8 * j;
          if (co < cout && c0 + kk / 9 < cin) part[(size_t)co * kdim + c0 * 9 + kk] = facc[i][j];
        }
    }
  }
}

// dW = the sum of the splits, in split order; written in T.
template <typename T>
__global__ void sum_splits_kernel(const float* __restrict__ partial, T* __restrict__ out,
                                  int count, int splits) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < count; e += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += partial[(size_t)k * count + e];
    out[e] = from_f32<T>(s);
  }
}

// ---------------------------------------------------------------------------
// K2: dX through a haloed shared-memory tile.

template <typename T>
struct DxSmem {
  static constexpr size_t tab = 0;                                         // float4 [PAIRS]
  static constexpr size_t wsub = tab + align128(PAIRS * sizeof(float4));    // T [2][CO][LDW]
  static constexpr size_t gsub = wsub + align128(2 * CO * LDW * sizeof(T)); // T [2][CO][LDP]
  static constexpr size_t dcol = gsub + align128(2 * CO * LDP * sizeof(T)); // f32 [BK][LDF]
  static constexpr size_t halo = dcol + align128(BK * LDF * sizeof(float)); // int [CK][HH][HWD]
  static constexpr size_t scale = halo + align128(CK * HH * HWD * sizeof(int));  // f32 [CK]
  static constexpr size_t bytes = scale + align128(CK * sizeof(float));
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
dcn_bwd_dx_kernel(const float* __restrict__ offset, const float* __restrict__ mask,
                  const T* __restrict__ weight, const T* __restrict__ g, float* __restrict__ dx,
                  int cin, int h, int w, int ho, int wo, int stride, int dilation, int cout,
                  int tiles_x) {
  using S = DxSmem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  float4* tab = reinterpret_cast<float4*>(smem + S::tab);
  T* wsub = reinterpret_cast<T*>(smem + S::wsub);
  T* gsub = reinterpret_cast<T*>(smem + S::gsub);
  float* dcol = reinterpret_cast<float*>(smem + S::dcol);
  int* halo = reinterpret_cast<int*>(smem + S::halo);
  float* scale = reinterpret_cast<float*>(smem + S::scale);

  constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;
  constexpr int VEC = 16 / sizeof(T);
  static_assert(TW % VEC == 0 && BK % VEC == 0, "vector copies");
  const int hw = h * w;     // x's and dX's plane
  const int hwo = ho * wo;  // the output grid's: g, offset, mask
  const int kdim = cin * 9;
  const int ty0 = (blockIdx.x / tiles_x) * TH;  // the block's output tile
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  // the haloed tile's origin in x: the output tile's rigid footprint, centred
  const int hy_org = ty0 * stride - (stride == 1 ? R : R / 2);
  const int hx_org = tx0 * stride - (stride == 1 ? R : R / 2);
  const int c0 = blockIdx.y * CK;
  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const T* g_n = g + (size_t)n * cout * hwo;
  const bool w_vec = kdim % VEC == 0 && aligned16(weight) && c0 + CK <= cin;
  const bool g_vec = wo % VEC == 0 && aligned16(g);

  // W[co0 .. co0+CO][chunk] and g[co0 .. co0+CO][tile] -> buffer buf
  auto load_slice = [&](int buf, int co0) {
    T* ws = wsub + buf * CO * LDW;
    T* gs = gsub + buf * CO * LDP;
    for (int e = tid; e < CO * BK / VEC; e += THREADS) {
      const int r = e / (BK / VEC);
      const int kv = (e - r * (BK / VEC)) * VEC;
      const int co = co0 + r;
      T* d = ws + r * LDW + kv;
      const T* src = weight + (size_t)co * kdim + c0 * 9 + kv;
      if (w_vec && co < cout) {
        cp_async16(d, src);
      } else {
        for (int i = 0; i < VEC; ++i)
          d[i] = (co < cout && c0 + (kv + i) / 9 < cin) ? src[i] : from_f32<T>(0.f);
      }
    }
    for (int e = tid; e < CO * BN / VEC; e += THREADS) {
      const int r = e / (BN / VEC);
      const int pv = (e - r * (BN / VEC)) * VEC;  // pixel of the tile, row-major 8 x 8
      const int co = co0 + r;
      const int gy = ty0 + pv / TW;
      const int gx = tx0 + pv % TW;
      T* d = gs + r * LDP + pv;
      const T* src = g_n + (size_t)co * hwo + (size_t)gy * wo + gx;
      if (g_vec && co < cout && gy < ho && gx < wo) {
        cp_async16(d, src);
      } else {
        for (int i = 0; i < VEC; ++i)
          d[i] = (co < cout && gy < ho && gx + i < wo) ? src[i] : from_f32<T>(0.f);
      }
    }
  };

  const int nslices = (cout + CO - 1) / CO;
  load_slice(0, 0);
  cp_async_commit();

  const float* off_n = offset + (size_t)n * 18 * hwo;
  const float* msk_n = mask != nullptr ? mask + (size_t)n * 9 * hwo : nullptr;
  for (int e = tid; e < PAIRS; e += THREADS) {
    const int tap = e / BN;
    const int pl = e - tap * BN;
    const int oy = ty0 + pl / TW;
    const int ox = tx0 + pl % TW;
    tab[e] = (oy < ho && ox < wo) ? sample_entry(off_n, msk_n, hwo, wo, h, w, stride, dilation, tap, oy, ox)
                                  : make_float4(0.f, 0.f, 0.f, __int_as_float(-1));
  }
  for (int e = tid; e < CK * HH * HWD; e += THREADS) halo[e] = 0;

  // dcol[BK][BN] = W_chunk^T g_tile over all of Cout
  using namespace nvcuda;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kTensorCores ? BK / 16 : 1];
  float facc[kTensorCores ? 1 : BK * BN / THREADS];
  if constexpr (kTensorCores) {
#pragma unroll
    for (int i = 0; i < BK / 16; ++i) wmma::fill_fragment(acc[i], 0.f);
  } else {
#pragma unroll
    for (int k = 0; k < BK * BN / THREADS; ++k) facc[k] = 0.f;
  }
  for (int s = 0; s < nslices; ++s) {
    if (s + 1 < nslices) load_slice((s + 1) & 1, (s + 1) * CO);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();  // slice s is in (and, the first time, the table and the zeroed halo)
    const T* ws = wsub + (s & 1) * CO * LDW;
    const T* gs = gsub + (s & 1) * CO * LDP;
    if constexpr (kTensorCores) {
      // warp `warp` owns pixel columns warp*16 .. +16 of all 9 row blocks;
      // ws read as column-major (BK x CO) is W^T
#pragma unroll
      for (int ks = 0; ks < CO / 16; ++ks) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, gs + ks * 16 * LDP + warp * 16, LDP);
#pragma unroll
        for (int i = 0; i < BK / 16; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a;
          wmma::load_matrix_sync(a, ws + ks * 16 * LDW + i * 16, LDW);
          wmma::mma_sync(acc[i], a, b, acc[i]);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < BK * BN / THREADS; ++k) {
        const int e = tid + k * THREADS;
        const int kk = e / BN;
        const int pl = e - kk * BN;
        float sum = 0.f;
        for (int r = 0; r < CO; ++r) sum += to_f32(ws[r * LDW + kk]) * to_f32(gs[r * LDP + pl]);
        facc[k] += sum;
      }
    }
    __syncthreads();  // slice s is read before its buffer is refilled
  }
  if constexpr (kTensorCores) {
#pragma unroll
    for (int i = 0; i < BK / 16; ++i)
      wmma::store_matrix_sync(dcol + i * 16 * LDF + warp * 16, acc[i], LDF, wmma::mem_row_major);
  } else {
#pragma unroll
    for (int k = 0; k < BK * BN / THREADS; ++k) {
      const int e = tid + k * THREADS;
      dcol[(e / BN) * LDF + e % BN] = facc[k];
    }
  }
  __syncthreads();

  // The haloed tile holds fixed-point sums: shared-memory atomics on f32 are
  // compare-and-swap loops on this card, on int32 one instruction. Channel
  // cc's contributions are scaled by 2^(29 - e), where 2^e <= A < 2^(e+1)
  // and A is the sum of |dcol * mask| over the channel's samples in this
  // block; the corner weights of a sample add to 1, so no cell's sum of
  // rounded contributions reaches 2^31. The rounding is 2^(e - 30) at most
  // per contribution, 2^-30 of A. A channel with A = 0 adds nothing; one
  // with A below 2^-96 (whose scale would leave the f32 range) takes the
  // global f32 atomics.
  {
    const int cc = tid / 8;  // 8 threads per channel, in one warp
    float a = 0.f;
    for (int e = tid % 8; e < PAIRS; e += 8) {
      const float4 f = tab[e];
      if (__float_as_int(f.w) >= 0) a += fabsf(dcol[(cc * 9 + e / BN) * LDF + e % BN] * f.z);
    }
    a += __shfl_xor_sync(0xffffffffu, a, 1);
    a += __shfl_xor_sync(0xffffffffu, a, 2);
    a += __shfl_xor_sync(0xffffffffu, a, 4);
    if (tid % 8 == 0) scale[cc] = a >= 0x1p-96f ? ldexpf(1.f, 29 - ilogbf(a)) : (a > 0.f ? -1.f : 0.f);
  }
  __syncthreads();

  // Scatter dcol * mask * corner weight: into the haloed tile where all four
  // corners fall inside it, else straight into dX.
  float* dx_n = dx + (size_t)n * cin * hw;
  float sc_reg[CK];
#pragma unroll
  for (int cc = 0; cc < CK; ++cc) sc_reg[cc] = scale[cc];
  for (int j = 0; j < PAIRS_PER_THREAD; ++j) {
    const int e = tid + j * THREADS;
    if (e >= PAIRS) break;
    const int tap = e / BN;
    const int pl = e - tap * BN;
    const float4 f = tab[e];
    const int code = __float_as_int(f.w);
    const float m = f.z;
    if (code < 0 || m == 0.f) continue;
    const int y0 = (code >> 16) - 1;
    const int x0 = (code & 0xffff) - 1;
    const float ly = f.x, lx = f.y;
    const float w00 = (1.f - ly) * (1.f - lx), w01 = (1.f - ly) * lx;
    const float w10 = ly * (1.f - lx), w11 = ly * lx;
    const int hy0 = y0 - hy_org;
    const int hx0 = x0 - hx_org;
    const bool inside = hy0 >= 0 && hy0 + 1 < HH && hx0 >= 0 && hx0 + 1 < HWD;
    const bool y0_in = y0 >= 0, y1_in = y0 + 1 < h;
    const bool x0_in = x0 >= 0, x1_in = x0 + 1 < w;
    // the chunk's dcol values first: a shared load after a shared atomic
    // waits for it (the two may alias), so the atomics go out back to back
    float dv[CK];
#pragma unroll
    for (int cc = 0; cc < CK; ++cc) dv[cc] = dcol[(cc * 9 + tap) * LDF + pl] * m;
#pragma unroll
    for (int cc = 0; cc < CK; ++cc) {
      const float d = dv[cc];
      const float sc = sc_reg[cc];
      if (c0 + cc >= cin || d == 0.f || sc == 0.f) continue;
      if (inside && sc > 0.f) {
        int* sh = halo + (cc * HH + hy0) * HWD + hx0;
        const float v = d * sc;
        const int q00 = __float2int_rn(v * w00), q01 = __float2int_rn(v * w01);
        const int q10 = __float2int_rn(v * w10), q11 = __float2int_rn(v * w11);
        if (q00 != 0) atomicAdd(sh, q00);
        if (q01 != 0) atomicAdd(sh + 1, q01);
        if (q10 != 0) atomicAdd(sh + HWD, q10);
        if (q11 != 0) atomicAdd(sh + HWD + 1, q11);
      } else {
        float* dxc = dx_n + (size_t)(c0 + cc) * hw + (size_t)y0 * w + x0;
        if (w00 != 0.f && y0_in && x0_in) atomicAdd(dxc, d * w00);
        if (w01 != 0.f && y0_in && x1_in) atomicAdd(dxc + 1, d * w01);
        if (w10 != 0.f && y1_in && x0_in) atomicAdd(dxc + w, d * w10);
        if (w11 != 0.f && y1_in && x1_in) atomicAdd(dxc + w + 1, d * w11);
      }
    }
  }
  __syncthreads();

  // The haloed tile into dX: its nonzero cells on the map (the cells off the
  // map are padding corners and drop), four at a time. Where the row of dX
  // is 16-byte aligned the four go out as one vector atomic (sm_90), else
  // one by one.
  static_assert(TW % 4 == 0 && R % 8 == 0, "a group of four starts at a multiple of 4 in dX");
  const bool dx_vec = w % 4 == 0 && aligned16(dx);
  for (int e = tid; e < CK * HH * HWD / 4; e += THREADS) {
    const int4 v = reinterpret_cast<const int4*>(halo)[e];
    if ((v.x | v.y | v.z | v.w) == 0) continue;
    const int cc = e / (HH * HWD / 4);
    const int rem = e - cc * (HH * HWD / 4);
    const int gy = hy_org + rem / (HWD / 4);
    const int gx = hx_org + 4 * (rem % (HWD / 4));
    if (c0 + cc >= cin || gy < 0 || gy >= h) continue;
    const float inv = 1.f / scale[cc];  // a power of two: exact
    float* dst = dx_n + (size_t)(c0 + cc) * hw + (size_t)gy * w + gx;
    if (dx_vec && gx >= 0 && gx + 3 < w) {
      atomicAdd(reinterpret_cast<float4*>(dst),
                make_float4(v.x * inv, v.y * inv, v.z * inv, v.w * inv));
    } else {
      const int q[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (q[i] != 0 && gx + i >= 0 && gx + i < w) atomicAdd(dst + i, q[i] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch.

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename T, bool DQ, bool DW>
cudaError_t launch_wq(const void* x, const void* offset, const void* mask, const void* weight,
                      const void* g, void* doffset, void* dmask, void* dw, void* partial, int n,
                      int cin, int h, int w, int cout, int stride, int dilation, int span,
                      int splits, cudaStream_t stream) {
  if (stride < 1 || stride > 2 || dilation < 1 || dilation > 2) return cudaErrorInvalidValue;
  const int ho = (h - 1) / stride + 1, wo = (w - 1) / stride + 1;
  const int tiles_per_image = (ho * wo + BN - 1) / BN;
  const int ntiles = n * tiles_per_image;
  // every split owns at least one tile, and the splits cover every tile
  if (span < 1 || splits < 1 || (long long)(splits - 1) * span >= ntiles ||
      (long long)splits * span < ntiles)
    return cudaErrorInvalidValue;
  constexpr size_t smem = WqSmem<T, DQ, DW>::bytes;
  auto kernel = dcn_bwd_wq_kernel<T, DQ, DW>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((cin + CK - 1) / CK, (cout + BM - 1) / BM, splits);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(offset),
      static_cast<const float*>(mask), static_cast<const T*>(weight), static_cast<const T*>(g),
      static_cast<float*>(doffset), static_cast<float*>(dmask), static_cast<float*>(partial), cin,
      h, w, ho, wo, stride, dilation, cout, tiles_per_image, ntiles, span);
  err = cudaGetLastError();
  if (err != cudaSuccess || !DW) return err;
  const int count = cout * cin * 9;
  const int blocks = std::min((count + 255) / 256, 8 * 132);  // a few per SM; the loop strides
  sum_splits_kernel<T><<<blocks, 256, 0, stream>>>(static_cast<const float*>(partial),
                                                   static_cast<T*>(dw), count, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dx(const void* offset, const void* mask, const void* weight, const void* g,
                      void* dx, int n, int cin, int h, int w, int cout, int stride, int dilation,
                      cudaStream_t stream) {
  if (stride < 1 || stride > 2 || dilation < 1 || dilation > 2) return cudaErrorInvalidValue;
  constexpr size_t smem = DxSmem<T>::bytes;
  auto kernel = dcn_bwd_dx_kernel<T>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const int ho = (h - 1) / stride + 1, wo = (w - 1) / stride + 1;
  const int tiles_x = (wo + TW - 1) / TW;
  const dim3 grid(tiles_x * ((ho + TH - 1) / TH), (cin + CK - 1) / CK, n);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(offset), static_cast<const float*>(mask),
      static_cast<const T*>(weight), static_cast<const T*>(g), static_cast<float*>(dx), cin, h, w,
      ho, wo, stride, dilation, cout, tiles_x);
  return cudaGetLastError();
}

template <bool DQ, bool DW>
int dispatch_wq(const void* x, const void* offset, const void* mask, const void* weight,
                const void* g, void* doffset, void* dmask, void* dw, void* partial, int n,
                int cin, int h, int w, int cout, int stride, int dilation, int span, int splits,
                int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch_wq<__nv_bfloat16, DQ, DW>(x, offset, mask, weight, g, doffset, dmask, dw,
                                                 partial, n, cin, h, w, cout, stride, dilation,
                                                 span, splits, s);
  return (int)launch_wq<float, DQ, DW>(x, offset, mask, weight, g, doffset, dmask, dw, partial,
                                       n, cin, h, w, cout, stride, dilation, span, splits, s);
}

template <typename K>
int occupancy(K kernel, size_t smem, int* out) {
  cudaError_t err = prepare(kernel, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, smem);
  out[0] = (int)smem;
  out[1] = blocks;
  out[2] = THREADS;
  return (int)err;
}

template <typename T>
int info(int which, int* out) {
  switch (which) {
    case 0: return occupancy(dcn_bwd_dx_kernel<T>, DxSmem<T>::bytes, out);
    case 1: return occupancy(dcn_bwd_wq_kernel<T, true, false>, WqSmem<T, true, false>::bytes, out);
    case 2: return occupancy(dcn_bwd_wq_kernel<T, false, true>, WqSmem<T, false, true>::bytes, out);
    case 3: return occupancy(dcn_bwd_wq_kernel<T, true, true>, WqSmem<T, true, true>::bytes, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns the launch's
// cudaError_t; none allocates or synchronizes. h and w are x's; g, offset,
// mask, d offset and d mask lie on the Ho x Wo output grid of stride (1 or 2)
// and dilation (1 or 2). mask may be null (unmodulated), and then dmask is
// null too. dx, doffset and dmask must be zeroed; partial is a
// [splits][Cout][Cin * 9] f32 scratch buffer whose contents do not matter; dw
// (Cout, Cin, 3, 3) is written in x's type. span and splits cut the
// n * ceil(Ho * Wo / 64) pixel tiles into splits spans of span tiles
// (ops/dcn.py::bwd_plan): every span non-empty, all covered.
extern "C" int dcn_bwd_dx(const void* x, const void* offset, const void* mask, const void* weight,
                          const void* g, void* dx, int n, int cin, int h, int w, int cout,
                          int stride, int dilation, int is_bf16, void* stream) {
  (void)x;  // dX does not read x
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch_dx<__nv_bfloat16>(offset, mask, weight, g, dx, n, cin, h, w, cout, stride,
                                         dilation, s);
  return (int)launch_dx<float>(offset, mask, weight, g, dx, n, cin, h, w, cout, stride, dilation, s);
}

extern "C" int dcn_bwd_dq(const void* x, const void* offset, const void* mask, const void* weight,
                          const void* g, void* doffset, void* dmask, int n, int cin, int h, int w,
                          int cout, int stride, int dilation, int span, int splits, int is_bf16,
                          void* stream) {
  return dispatch_wq<true, false>(x, offset, mask, weight, g, doffset, dmask, nullptr, nullptr, n,
                                  cin, h, w, cout, stride, dilation, span, splits, is_bf16, stream);
}

extern "C" int dcn_bwd_dw(const void* x, const void* offset, const void* mask, const void* g,
                          void* dw, void* partial, int n, int cin, int h, int w, int cout,
                          int stride, int dilation, int span, int splits, int is_bf16,
                          void* stream) {
  return dispatch_wq<false, true>(x, offset, mask, nullptr, g, nullptr, nullptr, dw, partial, n,
                                  cin, h, w, cout, stride, dilation, span, splits, is_bf16, stream);
}

extern "C" int dcn_bwd_dqdw(const void* x, const void* offset, const void* mask,
                            const void* weight, const void* g, void* doffset, void* dmask,
                            void* dw, void* partial, int n, int cin, int h, int w, int cout,
                            int stride, int dilation, int span, int splits, int is_bf16,
                            void* stream) {
  return dispatch_wq<true, true>(x, offset, mask, weight, g, doffset, dmask, dw, partial, n, cin,
                                 h, w, cout, stride, dilation, span, splits, is_bf16, stream);
}

// out[0..3) = dynamic shared memory (bytes), resident blocks per SM, threads
// per block of kernel `which`: 0 dx, 1 dq, 2 dw, 3 dqdw.
extern "C" int dcn_bwd_info(int which, int is_bf16, int* out) {
  return is_bf16 ? info<__nv_bfloat16>(which, out) : info<float>(which, out);
}
