// Deformable 3x3 convolution (DCNv2; DCNv1 without a mask) forward for Hopper
// (sm_90a).
//
// Replaces the TPU kernel detectron2_centernet_tpu/ops/pallas_dcn.py::_kernel
// (the tent-matmul forward with the fused BN + bias + ReLU epilogue). Same
// function, exact DCNv2 semantics: every sample is bilinear with zero padding,
// wherever its offset points (the TPU kernel drops samples beyond |dy| > 3);
// floor corners, coordinate math in f32, f32 accumulation, and the epilogue
// relu?(acc * scale + shift) in f32 before the one rounding to x's type. It
// also runs the deformable 3x3 of the ResNet trunks' DeformBottleneckBlock,
// which the JAX package computes with its exact op (ops/deform_conv.py): at
// stride s and dilation d in {1, 2}, padding d, modulated or not.
//
// Layout: x (N, Cin, H, W); offset (N, 18, Ho, Wo) f32 with offset[2t] = dy
// and offset[2t+1] = dx for tap t in row-major (ky, kx) order, mask
// (N, 9, Ho, Wo) f32 (already sigmoided; a null mask is a mask of ones, never
// read), weight (Cout, Cin, 3, 3), out (N, Cout, Ho, Wo), Ho = (H - 1) / s + 1.
// Output pixel (i, j), tap (ky, kx) samples x at
// (i*s - d + ky*d + dy, j*s - d + kx*d + dx). x, weight and out share one
// type T: float or __nv_bfloat16.
//
// What bounds it. The least time of a launch is set by its bytes (x, offset,
// mask, out) at most DLA-34 shapes and by the tensor-core rate at the widest
// (2 * 9 * Cin FLOPs per output element). The first version of this kernel
// ran 40-800x above that, held back by three things: (1) its grid,
// (H*W / 64) x (Cout / 64) x N blocks, was 16-128 blocks at batch 1 on 132
// SMs, each walking the whole 9 * Cin axis alone; (2) every 64-wide Cout tile
// gathered the same column tile again; (3) every sample cost a 32-byte table
// read and four scalar 2-byte loads into a channel plane, waited out one
// after the other, with the gather, the weight copy and the product in turn
// between two barriers per chunk. Each part of this design answers one:
//
// (1) The grid: 8 x 8 pixel tiles x Cout tiles x N x splits. Where the first
//     three give fewer than two waves of the card, the host plan
//     (ops/dcn.py::fwd_plan) cuts the chunks of the 9 * Cin axis into splits
//     of `span` consecutive chunks, each a block of its own, so that every
//     DLA-34 shape at batch 1 launches at least two waves (or one split per
//     chunk where there are fewer chunks). A split writes its f32 product
//     once into a [splits][N][Cout][H*W] partial buffer, and
//     dcn_fwd_reduce_kernel adds the splits in a fixed order, applies the
//     epilogue and writes out in T: no atomics, so every launch gives the
//     same bits. The plan caps the buffer at 16 MiB (FWD_PARTIAL_CAP; it is
//     4-16 MiB at the DLA-34 shapes that split, under the 50 MB L2). With one
//     split the main kernel applies the epilogue itself and no third kernel
//     runs.
// (2) One gather for all of Cout: a block's M tile is BM = 64, 128 or 256
//     output channels (the smallest that holds Cout), so each (channel, tap,
//     pixel) sample is built once per launch for Cout <= 256, all of
//     DLA-34's widths. Eight warps own 32-row slabs of the BM x 64 tile with
//     the f32 accumulator in registers (bf16 WMMA 16x16x16 on the tensor
//     cores; f32 operands on the FMA pipes, 16 x 4 per thread at BM = 256).
//     Cout > 256 takes Cout tiles of 256 that repeat the gather: res5's
//     deformable 3x3 (Cout 512) builds each sample twice, once per tile
//     (timed in PERF.md). The full-Cout tile fits: 213 KB of shared memory
//     at BM = 256 (one block of 8 warps per SM), 96 KB at BM = 64 (two).
//     Clusters were tried and measured (tools/dcn_phases.py, PERF.md): two
//     blocks sharing each W tile by a multicast bulk copy ran no faster, four
//     slower, since each block still takes the whole tile into its own
//     shared memory, so none is used.
// (3) A cheap sample: dcn_fwd_stage_kernel first writes x channels-last by
//     chunk at x's own size, (N, Cin_pad / CK, H*W, CK) with Cin padded with zeros to the
//     chunk (CK = 32 bytes of channels: 16 bf16 or 8 f32), so that four
//     neighbouring pixels of a chunk share a 128-byte line, and the weight as
//     its W tiles (k = tap * CK + c within a chunk, rows padded as in shared
//     memory, zero rows up to the Cout tiles), both into the scratch buffer
//     (about 2x x's bytes). A thread then owns a (tap, pixel) sample for 16
//     bytes of channels: it reads the corners' offsets once and each corner
//     as one 16-byte load (two lanes cover a 32-byte sector), and writes the
//     blended channels with one 16-byte store into the column tile. That is
//     8x fewer load instructions (bf16) and 16x fewer table reads than one
//     sample per channel, and no channel masks. The 8 x 8 tile keeps a
//     chunk's corners for a block within a few KB of L1 at small offsets.
// (4) Overlap: the W and column tiles are double-buffered. While the block
//     multiplies chunk k, the W tile of chunk k+1 comes in as one bulk copy
//     (cp.async.bulk, counted by an mbarrier) and every thread has all of
//     chunk k+1's corner loads (20 x 16 bytes) in flight; it blends and
//     stores them after the product, and one barrier per chunk closes the
//     step. Tile rows are padded to 304 bytes so the rows a WMMA fragment
//     load reads fall in distinct banks. The product stays WMMA (mma.sync):
//     wgmma would want the column tile in its core-matrix layout, and at 64
//     output channels the product is a quarter of the time
//     (tools/dcn_phases.py). Prefetching chunk k+2's corners into L1 was
//     measured slower and is not done.
// (5) Host cost: cudaFuncSetAttribute runs once per kernel instantiation and
//     device, not per launch; the entry point takes one scratch buffer that
//     the wrapper allocates with torch.empty, and launches two kernels (three
//     with splits).
//
// What bounds it now (PERF.md): at batch 1 the host's time per call; at
// batch 16 and 32 the latency each block waits out (the table, one gather
// per chunk, the W copy) at 8-16 warps per SM, and the W tiles' traffic into
// shared memory at BM = 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <algorithm>
#include <atomic>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int TH = 8, TW = 8;  // a block's 8 x 8 tile of output pixels (one image)
constexpr int BN = TH * TW;    // output pixels per block
constexpr int THREADS = 256;  // eight warps
constexpr int PAIRS = 9 * BN;  // (tap, pixel) samples of a tile
constexpr int LDO = BN + 4;    // row stride of the f32 output stage

// Per element type: CK channels per chunk (32 bytes), BK = 9 * CK rows of
// the column tile, rows padded to LDK elements (304 bytes: 16 bytes past a
// multiple of 32, so eight rows of a fragment load fall in distinct banks),
// VEC channels per 16-byte load, UNITS (tap, pixel, VEC channels) samples per
// chunk and UPT of them per thread.
template <typename T>
struct Cfg {
  static constexpr int CK = 32 / (int)sizeof(T);
  static constexpr int BK = 9 * CK;
  static constexpr int LDK = BK + 16 / (int)sizeof(T);
  static constexpr int VEC = 16 / (int)sizeof(T);
  static constexpr int CV = CK / VEC;  // 16-byte vectors per chunk and sample
  static constexpr int UNITS = PAIRS * CV;
  static constexpr int UPT = (UNITS + THREADS - 1) / THREADS;
};

template <typename T, int BM>
struct FwdSmem {
  using C = Cfg<T>;
  static constexpr size_t tab_off = 0;                                  // int4 [PAIRS]
  static constexpr size_t tab_w = tab_off + PAIRS * sizeof(int4);       // float4 [PAIRS]
  static constexpr size_t w = tab_w + PAIRS * sizeof(float4);           // T [2][BM][LDK]
  static constexpr size_t col = w + 2 * (size_t)BM * C::LDK * sizeof(T);  // T [2][BN][LDK]
  static constexpr size_t bar = col + 2 * (size_t)BN * C::LDK * sizeof(T);  // uint64 [2] mbarriers
  static constexpr size_t bytes = bar + 2 * sizeof(unsigned long long);
  static constexpr unsigned w_bytes = BM * C::LDK * sizeof(T);  // one W tile
  static_assert(BM * LDO * sizeof(float) <= 2 * (size_t)BM * C::LDK * sizeof(T),
                "the f32 output stage reuses the W buffers");
};

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Hopper's bulk copy and the transaction barrier it signals.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
// Waits for phase `parity` of the barrier; a copy that never lands traps
// (a kernel error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  for (long long spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1ll << 24)) __trap();
  }
}
// `bytes` (a multiple of 16) from global to shared memory in one copy; the
// barrier counts them as they land.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// The blend of one sample's four corners, 16 bytes of channels each, with
// the corner weights (mask folded in): computed in f32, rounded once to T.
template <typename T>
__device__ __forceinline__ uint4 blend(const uint4 (&r)[4], float4 wt);

template <>
__device__ __forceinline__ uint4 blend<float>(const uint4 (&r)[4], float4 wt) {
  unsigned o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a = __uint_as_float((&r[0].x)[i]), b = __uint_as_float((&r[1].x)[i]);
    const float c = __uint_as_float((&r[2].x)[i]), d = __uint_as_float((&r[3].x)[i]);
    o[i] = __float_as_uint(wt.x * a + wt.y * b + wt.z * c + wt.w * d);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

template <>
__device__ __forceinline__ uint4 blend<__nv_bfloat16>(const uint4 (&r)[4], float4 wt) {
  unsigned o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned a = (&r[0].x)[i], b = (&r[1].x)[i], c = (&r[2].x)[i], d = (&r[3].x)[i];
    // a bf16 is the high half of an f32
    const float lo = wt.x * __uint_as_float(a << 16) + wt.y * __uint_as_float(b << 16) +
                     wt.z * __uint_as_float(c << 16) + wt.w * __uint_as_float(d << 16);
    const float hi = wt.x * __uint_as_float(a & 0xffff0000u) + wt.y * __uint_as_float(b & 0xffff0000u) +
                     wt.z * __uint_as_float(c & 0xffff0000u) + wt.w * __uint_as_float(d & 0xffff0000u);
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    o[i] = *reinterpret_cast<unsigned*>(&v);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

__device__ __forceinline__ float epilogue(float v, const float* scale, const float* shift, int co,
                                          int relu) {
  if (scale != nullptr) v *= scale[co];
  if (shift != nullptr) v += shift[co];
  return relu ? fmaxf(v, 0.f) : v;
}

// ---------------------------------------------------------------------------
// Staging: x channels-last by chunk and the weight in chunk order, one launch.
//   xt[n][kc][p][cc] = x[n][kc * CK + cc][p] for channels < Cin, 0 up to Cin_pad;
//   wp[m][kc][r][tap * CK + cc] = weight[m * BM + r][kc * CK + cc][tap], 0
//   outside Cout x Cin and in the rows' padding up to LDK: the W tile of
//   (Cout tile m, chunk kc) is BM * LDK contiguous elements, as in shared memory.
// Blocks [0, wblocks) copy the weight (first, so that their scattered reads
// overlap the transpose); the rest transpose tiles of SC channels x SP
// pixels of x through shared memory, 16 bytes a load where x's rows allow
// (`vec`) and 16 bytes a store.

constexpr int SP = 64, SC = 32;  // a transpose tile: pixels x channels

template <typename T>
__global__ void __launch_bounds__(THREADS)
dcn_fwd_stage_kernel(const T* __restrict__ x, const T* __restrict__ weight, T* __restrict__ xt,
                     T* __restrict__ wp, int cin, int cin_pad, int hw, int cout, int bm,
                     int cout_tiles, int ptiles, int ctiles, int wblocks, int vec) {
  using C = Cfg<T>;
  const int tid = threadIdx.x;
  if ((int)blockIdx.x >= wblocks) {
    // tile[c][p] of T, rows padded by one word so that a column read is
    // conflict-free; read and written as 32-bit words
    constexpr int LDT = SP + 4 / (int)sizeof(T);
    __shared__ __align__(16) unsigned words[SC * LDT * sizeof(T) / 4];
    T* tile = reinterpret_cast<T*>(words);
    const int ct = (blockIdx.x - wblocks) % ctiles;
    const int rest = (blockIdx.x - wblocks) / ctiles;
    const int p0 = (rest % ptiles) * SP;
    const int img = rest / ptiles;
    const int c0 = ct * SC;
    const T* x_n = x + (size_t)img * cin * hw;
    for (int e = tid; e < SC * SP / C::VEC; e += THREADS) {
      const int c = e / (SP / C::VEC);
      const int pv = (e - c * (SP / C::VEC)) * C::VEC;
      const T* src = x_n + (size_t)(c0 + c) * hw + p0 + pv;
      const bool in = c0 + c < cin;
      if (vec && in && p0 + pv + C::VEC <= hw) {
        const uint4 v = ld16(src);
        unsigned* dst = words + (c * LDT + pv) * (int)sizeof(T) / 4;
        dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
      } else {
#pragma unroll
        for (int i = 0; i < C::VEC; ++i)
          tile[c * LDT + pv + i] = in && p0 + pv + i < hw ? src[i] : from_f32<T>(0.f);
      }
    }
    __syncthreads();
    // the 16-byte vectors of xt[kc][p][cc]: two lanes a 32-byte chunk row
    T* xt_n = xt + (size_t)img * hw * cin_pad;
    for (int e = tid; e < SC * SP / C::VEC; e += THREADS) {
      const int v = e % C::CV;
      const int p = e / C::CV % SP;
      const int c = e / (C::CV * SP) * C::CK + v * C::VEC;  // within the tile
      if (c0 + c >= cin_pad || p0 + p >= hw) continue;
      unsigned o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (sizeof(T) == 2) {
          const unsigned short* h = reinterpret_cast<const unsigned short*>(words);
          o[i] = h[(c + 2 * i) * LDT + p] | (unsigned)h[(c + 2 * i + 1) * LDT + p] << 16;
        } else {
          o[i] = words[(c + i) * LDT + p];
        }
      }
      *reinterpret_cast<uint4*>(xt_n + ((size_t)((c0 + c) / C::CK) * hw + p0 + p) * C::CK + v * C::VEC) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
    return;
  }
  const int chunks = cin_pad / C::CK;
  const long long total = (long long)cout_tiles * chunks * bm * C::LDK;
  for (long long e = (long long)blockIdx.x * THREADS + tid; e < total; e += (long long)wblocks * THREADS) {
    const long long row = e / C::LDK;  // (m, kc, r)
    const int k = (int)(e - row * C::LDK);
    const int r = (int)(row % bm);
    const int kc = (int)(row / bm % chunks);
    const int co = (int)(row / bm / chunks) * bm + r;
    const int tap = k / C::CK;
    const int c = kc * C::CK + (k - tap * C::CK);
    wp[e] = (k < C::BK && co < cout && c < cin) ? weight[((size_t)co * cin + c) * 9 + tap] : from_f32<T>(0.f);
  }
}

// ---------------------------------------------------------------------------
// The implicit GEMM: out[co][p] = sum_k W[co][k] col[k][p] over the chunks
// [z * span, min((z + 1) * span, chunks)) of split z.

template <typename T, int BM>
__global__ void __launch_bounds__(THREADS, BM <= 64 ? 2 : 1)
dcn_fwd_kernel(const T* __restrict__ xt, const float* __restrict__ offset,
               const float* __restrict__ mask, const T* __restrict__ wp,
               const float* __restrict__ scale, const float* __restrict__ shift,
               T* __restrict__ out, float* __restrict__ partial, int h, int w, int ho, int wo,
               int stride, int dilation, int cout, int tiles_x, int tiles, int span, int chunks,
               int relu) {
  using C = Cfg<T>;
  using S = FwdSmem<T, BM>;
  extern __shared__ __align__(128) unsigned char smem[];
  int4* tab_off = reinterpret_cast<int4*>(smem + S::tab_off);
  float4* tab_w = reinterpret_cast<float4*>(smem + S::tab_w);
  T* wbuf = reinterpret_cast<T*>(smem + S::w);
  T* cbuf = reinterpret_cast<T*>(smem + S::col);
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem + S::bar);

  constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;
  const int hw = h * w;     // x's plane
  const int hwo = ho * wo;  // the output's, offset's and mask's plane
  const int img = blockIdx.x / tiles;
  const int nimg = gridDim.x / tiles;
  const int tile = blockIdx.x - img * tiles;
  const int ty0 = (tile / tiles_x) * TH, tx0 = (tile % tiles_x) * TW;
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * span;
  const int k_end = min(k_begin + span, chunks);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  // The W tile of chunk kc -> W buffer b: one bulk copy, counted by barrier b.
  auto load_w = [&](int b, int kc) {
    if (tid == 0) {
      mbar_expect_tx(bars + b, S::w_bytes);
      bulk_copy(wbuf + b * BM * C::LDK, wp + ((size_t)blockIdx.y * chunks + kc) * BM * C::LDK,
                S::w_bytes, bars + b);
    }
  };

  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 1, 1);
    // the initialised barriers, visible to the copy engine
    asm volatile("fence.mbarrier_init.release.cluster;\nfence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  load_w(0, k_begin);

  // The sampling table: per (tap, pixel) the element offsets of the four
  // corners in a chunk's plane of the staged image and their weights (mask
  // folded in); a corner off the map has offset 0 and weight 0.
  const float* off_n = offset + (size_t)img * 18 * hwo;
  const float* msk_n = mask != nullptr ? mask + (size_t)img * 9 * hwo : nullptr;
  for (int e = tid; e < PAIRS; e += THREADS) {
    const int tap = e / BN;
    const int pl = e - tap * BN;
    const int oy = ty0 + pl / TW;
    const int ox = tx0 + pl % TW;
    int4 o = make_int4(0, 0, 0, 0);
    float4 wt = make_float4(0.f, 0.f, 0.f, 0.f);
    if (oy < ho && ox < wo) {
      const int p = oy * wo + ox;
      const float py = (float)(oy * stride - dilation + tap / 3 * dilation) + off_n[(size_t)(2 * tap) * hwo + p];
      const float px = (float)(ox * stride - dilation + tap % 3 * dilation) + off_n[(size_t)(2 * tap + 1) * hwo + p];
      const float m = msk_n != nullptr ? msk_n[(size_t)tap * hwo + p] : 1.f;
      // outside (-1, H) x (-1, W) every corner is padding; the test also keeps
      // huge offsets away from the float -> int conversion
      if (py > -1.f && py < (float)h && px > -1.f && px < (float)w) {
        const float fy = floorf(py);
        const float fx = floorf(px);
        const int y0 = (int)fy;
        const int x0 = (int)fx;
        const float ly = py - fy, lx = px - fx;
        const float hy = 1.f - ly, hx = 1.f - lx;
        const bool y0_in = y0 >= 0, y1_in = y0 + 1 < h;
        const bool x0_in = x0 >= 0, x1_in = x0 + 1 < w;
        if (y0_in && x0_in) { o.x = (y0 * w + x0) * C::CK;           wt.x = hy * hx * m; }
        if (y0_in && x1_in) { o.y = (y0 * w + x0 + 1) * C::CK;       wt.y = hy * lx * m; }
        if (y1_in && x0_in) { o.z = ((y0 + 1) * w + x0) * C::CK;     wt.z = ly * hx * m; }
        if (y1_in && x1_in) { o.w = ((y0 + 1) * w + x0 + 1) * C::CK; wt.w = ly * lx * m; }
      }
    }
    tab_off[e] = o;
    tab_w[e] = wt;
  }

  // Unit u of a chunk: vector v = u % CV of the chunk's channels at the
  // (tap, pixel) pair u / CV; neighbouring lanes read the two halves of one
  // 32-byte sector, then the next pixel (four to a 128-byte line).
  const T* x_n = xt + (size_t)img * chunks * hw * C::CK;
  auto load_units = [&](int kc, uint4 (&r)[C::UPT][4]) {
#pragma unroll
    for (int j = 0; j < C::UPT; ++j) {
      const int u = tid + j * THREADS;
      if ((j + 1) * THREADS <= C::UNITS || u < C::UNITS) {
        const int pair = u / C::CV;
        const int4 o = tab_off[pair];
        const T* xc = x_n + (size_t)kc * hw * C::CK + (u - pair * C::CV) * C::VEC;
        r[j][0] = ld16(xc + o.x); r[j][1] = ld16(xc + o.y); r[j][2] = ld16(xc + o.z); r[j][3] = ld16(xc + o.w);
      }
    }
  };
  // blend and store into column buffer b: col[pixel][tap * CK + c]
  auto store_units = [&](int b, const uint4 (&r)[C::UPT][4]) {
    T* colb = cbuf + b * BN * C::LDK;
#pragma unroll
    for (int j = 0; j < C::UPT; ++j) {
      const int u = tid + j * THREADS;
      if ((j + 1) * THREADS <= C::UNITS || u < C::UNITS) {
        const int pair = u / C::CV;
        const int tap = pair / BN;
        const int pl = pair - tap * BN;
        const uint4 v = blend<T>(r[j], tab_w[pair]);
        *reinterpret_cast<uint4*>(colb + pl * C::LDK + tap * C::CK + (u - pair * C::CV) * C::VEC) = v;
      }
    }
  };

  // The product's share of the BM x BN tile. Tensor cores: warp (wm, wn)
  // owns rows wm*32 .. +32 and pixel columns wn*FN*16 .. +FN*16. FMA pipes:
  // thread (ty, tx) owns rows ty*ROWS .. +ROWS and pixels tx + 16 j.
  constexpr int WM = BM / 32, WN = 8 / WM, FN = BN / 16 / WN;
  static_assert(WM * WN == THREADS / 32 && FN >= 1, "eight warps tile BM x BN");
  constexpr int ROWS = BM / 16;
  const int wm = warp / WN, wn = warp % WN;
  const int ty = tid / 16, tx = tid % 16;
  using namespace nvcuda;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kTensorCores ? 2 : 1][kTensorCores ? FN : 1];
  float accf[kTensorCores ? 1 : ROWS][4];
  if constexpr (kTensorCores) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) accf[i][j] = 0.f;
  }
  auto product = [&](int b) {
    const T* wb = wbuf + b * BM * C::LDK;
    const T* cb = cbuf + b * BN * C::LDK;
    if constexpr (kTensorCores) {
      // col[pixel][k] read as column-major (BK x BN) is the B operand
#pragma unroll
      for (int ks = 0; ks < C::BK / 16; ++ks) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf[FN];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], wb + (wm * 32 + i * 16) * C::LDK + ks * 16, C::LDK);
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::load_matrix_sync(bf[j], cb + ((wn * FN + j) * 16) * C::LDK + ks * 16, C::LDK);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
      }
    } else {
#pragma unroll 4
      for (int kk = 0; kk < C::BK; ++kk) {
        float bv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = cb[(tx + 16 * j) * C::LDK + kk];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const float av = wb[(ty * ROWS + i) * C::LDK + kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) accf[i][j] += av * bv[j];
        }
      }
    }
  };

  uint4 r[C::UPT][4];
  __syncthreads();  // the table is in
  load_units(k_begin, r);
  store_units(0, r);
  __syncthreads();  // chunk k_begin's column tile is in
  for (int kc = k_begin; kc < k_end; ++kc) {
    const int i = kc - k_begin;
    const int b = i & 1;
    const bool more = kc + 1 < k_end;
    if (more) {
      load_w(b ^ 1, kc + 1);  // lands during this chunk's product
      load_units(kc + 1, r);  // in flight during this chunk's product
    }
    mbar_wait(bars + b, (i >> 1) & 1);  // chunk kc's W tile is in
    product(b);
    if (more) store_units(b ^ 1, r);
    __syncthreads();  // chunk kc + 1's column tile is in; chunk kc's buffers are free
  }

  // The block's product: through an f32 stage (over the W buffers) into the
  // output with the epilogue, or into its split's partial.
  float* stage = reinterpret_cast<float*>(smem + S::w);  // [BM][LDO]
  if constexpr (kTensorCores) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::store_matrix_sync(stage + (wm * 32 + i * 16) * LDO + (wn * FN + j) * 16, acc[i][j], LDO,
                                wmma::mem_row_major);
  } else {
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) stage[(ty * ROWS + i) * LDO + tx + 16 * j] = accf[i][j];
  }
  __syncthreads();
  const bool split = gridDim.z > 1;
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int rr = e / BN;
    const int pl = e - rr * BN;
    const int co = m0 + rr;
    const int oy = ty0 + pl / TW, ox = tx0 + pl % TW;
    if (co < cout && oy < ho && ox < wo) {
      const int p = oy * wo + ox;
      const float v = stage[rr * LDO + pl];
      if (split) {
        partial[(((size_t)blockIdx.z * nimg + img) * cout + co) * hwo + p] = v;
      } else {
        out[((size_t)img * cout + co) * hwo + p] = from_f32<T>(epilogue(v, scale, shift, co, relu));
      }
    }
  }
}

// out = the epilogue of the sum of the splits, in split order; written in T.
template <typename T>
__global__ void __launch_bounds__(THREADS)
dcn_fwd_reduce_kernel(const float* __restrict__ partial, const float* __restrict__ scale,
                      const float* __restrict__ shift, T* __restrict__ out, long long count,
                      int cout, int hw, int splits, int relu) {
  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < count;
       e += (long long)gridDim.x * THREADS) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += partial[(size_t)k * count + e];
    out[e] = from_f32<T>(epilogue(s, scale, shift, (int)((e / hw) % cout), relu));
  }
}

// ---------------------------------------------------------------------------
// Launch.

constexpr size_t align256(size_t b) { return (b + 255) / 256 * 256; }

// Dynamic shared memory of the main kernel, set once per instantiation and
// device. The carveout is left to CUDA's default: what the resident blocks
// do not take stays L1, which holds the gather's corners.
template <typename T, int BM>
cudaError_t prepare() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  auto kernel = dcn_fwd_kernel<T, BM>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)FwdSmem<T, BM>::bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <typename T, int BM>
cudaError_t launch(const void* x, const void* offset, const void* mask, const void* weight,
                   const void* scale, const void* shift, void* out, void* scratch, int n, int cin,
                   int h, int w, int cout, int stride, int dilation, int relu, int span, int splits,
                   long long scratch_bytes, cudaStream_t stream) {
  using C = Cfg<T>;
  if (stride < 1 || stride > 2 || dilation < 1 || dilation > 2) return cudaErrorInvalidValue;
  const int hw = h * w;
  const int ho = (h - 1) / stride + 1, wo = (w - 1) / stride + 1;
  const int hwo = ho * wo;
  const int chunks = (cin + C::CK - 1) / C::CK;
  const int cin_pad = chunks * C::CK;
  const int cout_tiles = (cout + BM - 1) / BM;
  const int tiles_x = (wo + TW - 1) / TW;
  const int tiles = tiles_x * ((ho + TH - 1) / TH);
  // every split owns at least one chunk, and the splits cover every chunk;
  // the table's offsets are int32
  if (n < 1 || cin < 1 || cout < 1 || hw < 1 || span < 1 || splits < 1 ||
      (long long)(splits - 1) * span >= chunks || (long long)splits * span < chunks ||
      (long long)hw * C::CK >= (1ll << 31))
    return cudaErrorInvalidValue;
  // scratch: xt | wp | partial (splits > 1), each 256-byte aligned
  const size_t xt_bytes = align256((size_t)n * hw * cin_pad * sizeof(T));
  const size_t wp_bytes = align256((size_t)cout_tiles * chunks * BM * C::LDK * sizeof(T));
  const size_t part_bytes = splits > 1 ? (size_t)splits * n * cout * hwo * sizeof(float) : 0;
  if (scratch_bytes < 0 || (size_t)scratch_bytes < xt_bytes + wp_bytes + part_bytes)
    return cudaErrorInvalidValue;
  unsigned char* base = static_cast<unsigned char*>(scratch);
  T* xt = reinterpret_cast<T*>(base);
  T* wp = reinterpret_cast<T*>(base + xt_bytes);
  float* partial = splits > 1 ? reinterpret_cast<float*>(base + xt_bytes + wp_bytes) : nullptr;
  cudaError_t err = prepare<T, BM>();
  if (err != cudaSuccess) return err;

  const int ptiles = (hw + SP - 1) / SP, ctiles = (cin_pad + SC - 1) / SC;
  const int xblocks = n * ptiles * ctiles;
  const long long wtotal = (long long)cout_tiles * chunks * BM * C::LDK;
  const int wblocks = (int)std::min<long long>((wtotal + THREADS - 1) / THREADS, 1024);
  dcn_fwd_stage_kernel<T><<<xblocks + wblocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(weight), xt, wp, cin, cin_pad, hw, cout, BM,
      cout_tiles, ptiles, ctiles, wblocks,
      (int)(hw % C::VEC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid(tiles * n, cout_tiles, splits);
  constexpr size_t smem = FwdSmem<T, BM>::bytes;
  auto kernel = dcn_fwd_kernel<T, BM>;
  kernel<<<grid, THREADS, smem, stream>>>(
      xt, static_cast<const float*>(offset), static_cast<const float*>(mask), wp,
      static_cast<const float*>(scale), static_cast<const float*>(shift), static_cast<T*>(out),
      partial, h, w, ho, wo, stride, dilation, cout, tiles_x, tiles, span, chunks, relu);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;

  const long long count = (long long)n * cout * hwo;
  const int rblocks = (int)std::min<long long>((count + THREADS - 1) / THREADS, 8 * 132);
  dcn_fwd_reduce_kernel<T><<<rblocks, THREADS, 0, stream>>>(
      partial, static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<T*>(out), count, cout, hwo, splits, relu);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* offset, const void* mask, const void* weight,
             const void* scale, const void* shift, void* out, void* scratch, int n, int cin, int h,
             int w, int cout, int stride, int dilation, int relu, int bm, int span, int splits,
             long long scratch_bytes, cudaStream_t s) {
  switch (bm) {
    case 64:
      return (int)launch<T, 64>(x, offset, mask, weight, scale, shift, out, scratch, n, cin, h, w,
                                cout, stride, dilation, relu, span, splits, scratch_bytes, s);
    case 128:
      return (int)launch<T, 128>(x, offset, mask, weight, scale, shift, out, scratch, n, cin, h, w,
                                 cout, stride, dilation, relu, span, splits, scratch_bytes, s);
    case 256:
      return (int)launch<T, 256>(x, offset, mask, weight, scale, shift, out, scratch, n, cin, h, w,
                                 cout, stride, dilation, relu, span, splits, scratch_bytes, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int BM>
int occupancy(int* out) {
  cudaError_t err = prepare<T, BM>();
  int blocks = 0;
  auto kernel = dcn_fwd_kernel<T, BM>;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, FwdSmem<T, BM>::bytes);
  out[0] = (int)FwdSmem<T, BM>::bytes;
  out[1] = blocks;
  out[2] = THREADS;
  return (int)err;
}

template <typename T>
int info(int bm, int* out) {
  switch (bm) {
    case 64: return occupancy<T, 64>(out);
    case 128: return occupancy<T, 128>(out);
    case 256: return occupancy<T, 256>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). h and w are x's; the output is
// Ho x Wo at stride (1 or 2) and dilation (1 or 2), padding = dilation. mask
// may be null (unmodulated: weight 1), scale and shift too (no scale, no
// shift). bm (64, 128 or 256: the Cout tile), span and splits come
// from the host plan (ops/dcn.py::fwd_plan): the ceil(Cin / CK) chunks go in
// splits spans of span chunks, every span non-empty, all covered. scratch
// holds scratch_bytes of device memory whose contents do not matter: x
// channels-last, the weight in chunk order and, with splits > 1, the
// [splits][N][Cout][Ho*Wo] f32 partials. Returns the launches' cudaError_t; it
// allocates nothing and does not synchronize.
extern "C" int dcn_fwd(const void* x, const void* offset, const void* mask, const void* weight,
                       const void* scale, const void* shift, void* out, void* scratch, int n,
                       int cin, int h, int w, int cout, int stride, int dilation, int relu,
                       int is_bf16, int bm, int span, int splits, long long scratch_bytes,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(x, offset, mask, weight, scale, shift, out, scratch, n, cin, h,
                                   w, cout, stride, dilation, relu, bm, span, splits, scratch_bytes, s);
  return dispatch<float>(x, offset, mask, weight, scale, shift, out, scratch, n, cin, h, w, cout,
                         stride, dilation, relu, bm, span, splits, scratch_bytes, s);
}

// out[0..3) = dynamic shared memory (bytes), resident blocks per SM and
// threads per block of the main kernel with Cout tile bm.
extern "C" int dcn_fwd_info(int bm, int is_bf16, int* out) {
  return is_bf16 ? info<__nv_bfloat16>(bm, out) : info<float>(bm, out);
}
