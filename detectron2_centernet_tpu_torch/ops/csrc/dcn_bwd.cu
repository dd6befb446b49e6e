// Modulated deformable 3x3 convolution (DCNv2) backward for Hopper (sm_90a):
// four kernels, one templated body.
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
// Layout: x (N, Cin, H, W), offset (N, 18, H, W) f32 with offset[2t] = dy and
// offset[2t+1] = dx for tap t in row-major (ky, kx) order, mask (N, 9, H, W)
// f32 (already sigmoided), weight (Cout, Cin, 3, 3), g = dL/dout
// (N, Cout, H, W). x, weight and g share one type T: float or __nv_bfloat16.
// Outputs are f32: dx (N, Cin, H, W) and dw (Cout, Cin * 9) accumulate with
// atomics into buffers the caller zeroed; doffset (N, 18, H, W) and dmask
// (N, 9, H, W) are written once.
//
// Design: a block owns BN = 64 output pixels of one image and walks the
// input channels in chunks of CK = 16 (BK = 144 rows of the column matrix,
// row k = c * 9 + tap, the order of a flattened OIHW weight). It first builds
// the four floor corners (index, or -1 where the corner is padding) and the
// fractions (ly, lx) and mask of its 9 x 64 samples. Per chunk:
//   1. (dx, dq) dcol[BK][BN] = W^T g, the contraction over Cout inside the
//      block: bf16 operands on the tensor cores (WMMA 16x16x16, f32
//      accumulation), f32 operands on the FMA pipes;
//   2. one gather of the four corners of every (channel, tap, pixel) sample:
//      dx scatters dcol * mask * corner weight into the 4 corners with f32
//      atomics; dq accumulates, per (tap, pixel) in registers across all
//      chunks, dcol * d(sample)/d(ly, lx) and dcol * sample; dw stores the
//      modulated sample col[BK][BN], rounded to T as the forward rounds it;
//   3. (dw) dW[Cout][BK] += g[Cout][BN] col^T, again inside the block on the
//      tensor cores (bf16) or the FMA pipes (f32), added into dw with f32
//      atomics, one 64-row Cout tile at a time.
//
// What bounds it: the least time for the work is set by the two contractions
// (2 * 9 * Cin * Cout FLOPs per output pixel each for dx/dq and dw) at large
// batch, by the bytes of x, g and the outputs at small maps. This first
// version is held back instead by its scattered corner loads, the f32
// atomics of dx (4 per sample) and dw (one per block and weight element), and
// low occupancy (one 128-thread block of up to 124 KB of shared memory per
// SM in f32). A transposed gather for dx, split-K partial buffers for dw,
// wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <type_traits>

namespace {

constexpr int BN = 64;        // output pixels per block
constexpr int CK = 16;        // input channels per chunk
constexpr int BK = CK * 9;    // rows of the column matrix per chunk
constexpr int CO = 32;        // Cout slice of the W^T g contraction
constexpr int BM = 64;        // Cout tile of the dW product
constexpr int THREADS = 128;  // four warps
constexpr int PAIRS = 9 * BN;                            // (tap, pixel) samples
constexpr int PAIRS_PER_THREAD = (PAIRS + THREADS - 1) / THREADS;

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

// Shared memory layout (bytes), every region 128-byte aligned.
template <typename T>
struct Smem {
  static constexpr size_t tab_idx = 0;                                       // int4 [9][BN]
  static constexpr size_t tab_f = tab_idx + align128(PAIRS * sizeof(int4));  // float4 [9][BN]
  static constexpr size_t dcol = tab_f + align128(PAIRS * sizeof(float4));   // f32 [BK][BN] / [BM][BK]
  static constexpr size_t wsub = dcol + align128(BK * BN * sizeof(float));   // T [CO][BK]
  static constexpr size_t gsub = wsub + align128(CO * BK * sizeof(T));       // T [BM][BN]
  static constexpr size_t col = gsub + align128(BM * BN * sizeof(T));        // T [BK][BN]
  static constexpr size_t bytes = col + align128(BK * BN * sizeof(T));
};
static_assert(BM * BK == BK * BN, "the dW stage reuses the dcol region");

template <typename T, bool DX, bool DQ, bool DW>
__global__ void __launch_bounds__(THREADS)
dcn_bwd_kernel(const T* __restrict__ x, const float* __restrict__ offset,
               const float* __restrict__ mask, const T* __restrict__ weight,
               const T* __restrict__ g, float* __restrict__ dx, float* __restrict__ doffset,
               float* __restrict__ dmask, float* __restrict__ dw, int cin, int h, int w,
               int cout) {
  using S = Smem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  int4* tab_idx = reinterpret_cast<int4*>(smem + S::tab_idx);
  float4* tab_f = reinterpret_cast<float4*>(smem + S::tab_f);
  float* dcol = reinterpret_cast<float*>(smem + S::dcol);
  T* wsub = reinterpret_cast<T*>(smem + S::wsub);
  T* gsub = reinterpret_cast<T*>(smem + S::gsub);
  T* col = reinterpret_cast<T*>(smem + S::col);

  constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;
  const int hw = h * w;
  const int n = blockIdx.y;
  const int p0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int kdim = cin * 9;

  // Sampling table: floor corners (-1 = padding), fractions and mask.
  const float* off_n = offset + (size_t)n * 18 * hw;
  const float* msk_n = mask + (size_t)n * 9 * hw;
  for (int e = tid; e < PAIRS; e += THREADS) {
    const int tap = e / BN;
    const int p = p0 + (e - tap * BN);
    int4 idx = make_int4(-1, -1, -1, -1);
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p < hw) {
      const int oy = p / w;
      const int ox = p - oy * w;
      const float py = (float)(oy - 1 + tap / 3) + off_n[(size_t)(2 * tap) * hw + p];
      const float px = (float)(ox - 1 + tap % 3) + off_n[(size_t)(2 * tap + 1) * hw + p];
      f.z = msk_n[(size_t)tap * hw + p];
      // beyond (-1, H) x (-1, W) every corner is padding; the test also keeps
      // huge offsets away from the float -> int conversion
      if (py > -1.f && py < (float)h && px > -1.f && px < (float)w) {
        const float fy = floorf(py);
        const float fx = floorf(px);
        const int y0 = (int)fy;
        const int x0 = (int)fx;
        f.x = py - fy;
        f.y = px - fx;
        const bool y0_in = y0 >= 0, y1_in = y0 + 1 < h;
        const bool x0_in = x0 >= 0, x1_in = x0 + 1 < w;
        if (y0_in && x0_in) idx.x = y0 * w + x0;
        if (y0_in && x1_in) idx.y = y0 * w + x0 + 1;
        if (y1_in && x0_in) idx.z = (y0 + 1) * w + x0;
        if (y1_in && x1_in) idx.w = (y0 + 1) * w + x0 + 1;
      }
    }
    tab_idx[e] = idx;
    tab_f[e] = f;
  }

  // d(ly), d(lx), d(mask) sums over all channels, per (tap, pixel) pair.
  float q_ly[PAIRS_PER_THREAD], q_lx[PAIRS_PER_THREAD], q_m[PAIRS_PER_THREAD];
  for (int j = 0; j < PAIRS_PER_THREAD; ++j) q_ly[j] = q_lx[j] = q_m[j] = 0.f;

  const T* x_n = x + (size_t)n * cin * hw;
  const T* g_n = g + (size_t)n * cout * hw;
  float* dx_n = DX ? dx + (size_t)n * cin * hw : nullptr;

  for (int c0 = 0; c0 < cin; c0 += CK) {
    // 1. dcol[BK][BN] = W[:, c0*9 .. c0*9+BK]^T g[:, p0 .. p0+BN]
    if constexpr (DX || DQ) {
      using namespace nvcuda;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
      if constexpr (kTensorCores) {
        for (int i = 0; i < BK / 16; ++i) wmma::fill_fragment(acc[i], 0.f);
      } else {
        __syncthreads();  // the last chunk's dcol is read
        for (int e = tid; e < BK * BN; e += THREADS) dcol[e] = 0.f;
      }
      for (int co0 = 0; co0 < cout; co0 += CO) {
        __syncthreads();  // the table is written / the last slices are read
        for (int e = tid; e < CO * BK; e += THREADS) {
          const int r = e / BK;
          const int kk = e - r * BK;
          const int co = co0 + r;
          T v = from_f32<T>(0.f);
          if (co < cout && c0 + kk / 9 < cin) v = weight[(size_t)co * kdim + c0 * 9 + kk];
          wsub[e] = v;
        }
        for (int e = tid; e < CO * BN; e += THREADS) {
          const int r = e / BN;
          const int p = p0 + (e - r * BN);
          const int co = co0 + r;
          gsub[e] = (co < cout && p < hw) ? g_n[(size_t)co * hw + p] : from_f32<T>(0.f);
        }
        __syncthreads();
        if constexpr (kTensorCores) {
          // warp `warp` owns pixel columns warp*16 .. +16 of all 9 row blocks;
          // wsub read as column-major (BK x CO) is W^T
          for (int ks = 0; ks < CO / 16; ++ks) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
            wmma::load_matrix_sync(b, gsub + ks * 16 * BN + warp * 16, BN);
            for (int i = 0; i < BK / 16; ++i) {
              wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a;
              wmma::load_matrix_sync(a, wsub + ks * 16 * BK + i * 16, BK);
              wmma::mma_sync(acc[i], a, b, acc[i]);
            }
          }
        } else {
          for (int e = tid; e < BK * BN; e += THREADS) {
            const int kk = e / BN;
            const int pl = e - kk * BN;
            float s = 0.f;
            for (int r = 0; r < CO; ++r) s += to_f32(wsub[r * BK + kk]) * to_f32(gsub[r * BN + pl]);
            dcol[e] += s;
          }
        }
      }
      if constexpr (kTensorCores) {
        __syncthreads();  // the last chunk's dcol is read
        for (int i = 0; i < BK / 16; ++i)
          wmma::store_matrix_sync(dcol + i * 16 * BN + warp * 16, acc[i], BN, wmma::mem_row_major);
      }
    }
    __syncthreads();

    // 2. One gather of the corners of every (channel, tap, pixel) sample.
    for (int j = 0; j < PAIRS_PER_THREAD; ++j) {
      const int e = tid + j * THREADS;
      if (e >= PAIRS) break;
      const int tap = e / BN;
      const int pl = e - tap * BN;
      const int4 id = tab_idx[e];
      const float4 f = tab_f[e];
      const float ly = f.x, lx = f.y, m = f.z;
      const float hy = 1.f - ly, hx = 1.f - lx;
      float a_ly = 0.f, a_lx = 0.f, a_m = 0.f;
      for (int cc = 0; cc < CK; ++cc) {
        const int c = c0 + cc;
        const int kk = cc * 9 + tap;
        if (c >= cin) {
          if constexpr (DW) col[kk * BN + pl] = from_f32<T>(0.f);
          continue;
        }
        const T* xc = x_n + (size_t)c * hw;
        const float v00 = id.x >= 0 ? to_f32(xc[id.x]) : 0.f;
        const float v01 = id.y >= 0 ? to_f32(xc[id.y]) : 0.f;
        const float v10 = id.z >= 0 ? to_f32(xc[id.z]) : 0.f;
        const float v11 = id.w >= 0 ? to_f32(xc[id.w]) : 0.f;
        const float s = hy * (hx * v00 + lx * v01) + ly * (hx * v10 + lx * v11);
        if constexpr (DW) col[kk * BN + pl] = from_f32<T>(m * s);
        if constexpr (DX || DQ) {
          const float d = dcol[kk * BN + pl];
          if constexpr (DQ) {
            a_ly += d * (hx * (v10 - v00) + lx * (v11 - v01));
            a_lx += d * (hy * (v01 - v00) + ly * (v11 - v10));
            a_m += d * s;
          }
          if constexpr (DX) {
            const float dm = d * m;
            float* dxc = dx_n + (size_t)c * hw;
            if (id.x >= 0) atomicAdd(dxc + id.x, dm * hy * hx);
            if (id.y >= 0) atomicAdd(dxc + id.y, dm * hy * lx);
            if (id.z >= 0) atomicAdd(dxc + id.z, dm * ly * hx);
            if (id.w >= 0) atomicAdd(dxc + id.w, dm * ly * lx);
          }
        }
      }
      q_ly[j] += a_ly;
      q_lx[j] += a_lx;
      q_m[j] += a_m;
    }

    // 3. dW[co][c0*9 + kk] += sum_p g[co][p] col[kk][p]
    if constexpr (DW) {
      using namespace nvcuda;
      float* stage = dcol;  // [BM][BK] f32
      for (int m0 = 0; m0 < cout; m0 += BM) {
        __syncthreads();  // col is written / dcol and the last stage are read
        for (int e = tid; e < BM * BN; e += THREADS) {
          const int r = e / BN;
          const int p = p0 + (e - r * BN);
          const int co = m0 + r;
          gsub[e] = (co < cout && p < hw) ? g_n[(size_t)co * hw + p] : from_f32<T>(0.f);
        }
        __syncthreads();
        if constexpr (kTensorCores) {
          // warp `warp` owns Cout rows warp*16 .. +16 of all 9 column blocks;
          // col read as column-major (BN x BK) is col^T
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
          for (int i = 0; i < BK / 16; ++i) wmma::fill_fragment(acc[i], 0.f);
          for (int ks = 0; ks < BN / 16; ++ks) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
            wmma::load_matrix_sync(a, gsub + warp * 16 * BN + ks * 16, BN);
            for (int i = 0; i < BK / 16; ++i) {
              wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
              wmma::load_matrix_sync(b, col + i * 16 * BN + ks * 16, BN);
              wmma::mma_sync(acc[i], a, b, acc[i]);
            }
          }
          for (int i = 0; i < BK / 16; ++i)
            wmma::store_matrix_sync(stage + warp * 16 * BK + i * 16, acc[i], BK,
                                    wmma::mem_row_major);
        } else {
          for (int e = tid; e < BM * BK; e += THREADS) {
            const int r = e / BK;
            const int kk = e - r * BK;
            float s = 0.f;
            for (int pl = 0; pl < BN; ++pl) s += to_f32(gsub[r * BN + pl]) * to_f32(col[kk * BN + pl]);
            stage[e] = s;
          }
        }
        __syncthreads();
        for (int e = tid; e < BM * BK; e += THREADS) {
          const int r = e / BK;
          const int kk = e - r * BK;
          const int co = m0 + r;
          if (co < cout && c0 + kk / 9 < cin) atomicAdd(dw + (size_t)co * kdim + c0 * 9 + kk, stage[e]);
        }
      }
    }
  }

  // d offset = mask * d(ly, lx) (py = oy - 1 + ky + dy, so d py = d ly);
  // d mask = sum over channels of dcol * the unmodulated sample.
  if constexpr (DQ) {
    for (int j = 0; j < PAIRS_PER_THREAD; ++j) {
      const int e = tid + j * THREADS;
      if (e >= PAIRS) break;
      const int tap = e / BN;
      const int p = p0 + (e - tap * BN);
      if (p >= hw) continue;
      const float m = tab_f[e].z;
      float* doff_n = doffset + (size_t)n * 18 * hw;
      doff_n[(size_t)(2 * tap) * hw + p] = m * q_ly[j];
      doff_n[(size_t)(2 * tap + 1) * hw + p] = m * q_lx[j];
      dmask[((size_t)n * 9 + tap) * hw + p] = q_m[j];
    }
  }
}

template <typename T, bool DX, bool DQ, bool DW>
cudaError_t launch(const void* x, const void* offset, const void* mask, const void* weight,
                   const void* g, void* dx, void* doffset, void* dmask, void* dw, int n, int cin,
                   int h, int w, int cout, cudaStream_t stream) {
  constexpr size_t smem = Smem<T>::bytes;
  auto kernel = dcn_bwd_kernel<T, DX, DQ, DW>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((h * w + BN - 1) / BN, n);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(offset),
      static_cast<const float*>(mask), static_cast<const T*>(weight), static_cast<const T*>(g),
      static_cast<float*>(dx), static_cast<float*>(doffset), static_cast<float*>(dmask),
      static_cast<float*>(dw), cin, h, w, cout);
  return cudaGetLastError();
}

template <bool DX, bool DQ, bool DW>
int dispatch(const void* x, const void* offset, const void* mask, const void* weight,
             const void* g, void* dx, void* doffset, void* dmask, void* dw, int n, int cin, int h,
             int w, int cout, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16, DX, DQ, DW>(x, offset, mask, weight, g, dx, doffset, dmask,
                                                  dw, n, cin, h, w, cout, s);
  return (int)launch<float, DX, DQ, DW>(x, offset, mask, weight, g, dx, doffset, dmask, dw, n,
                                        cin, h, w, cout, s);
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns the launch's
// cudaError_t; none allocates or synchronizes. dx and dw must be zeroed.
extern "C" int dcn_bwd_dx(const void* x, const void* offset, const void* mask, const void* weight,
                          const void* g, void* dx, int n, int cin, int h, int w, int cout,
                          int is_bf16, void* stream) {
  return dispatch<true, false, false>(x, offset, mask, weight, g, dx, nullptr, nullptr, nullptr,
                                      n, cin, h, w, cout, is_bf16, stream);
}

extern "C" int dcn_bwd_dq(const void* x, const void* offset, const void* mask, const void* weight,
                          const void* g, void* doffset, void* dmask, int n, int cin, int h, int w,
                          int cout, int is_bf16, void* stream) {
  return dispatch<false, true, false>(x, offset, mask, weight, g, nullptr, doffset, dmask,
                                      nullptr, n, cin, h, w, cout, is_bf16, stream);
}

extern "C" int dcn_bwd_dw(const void* x, const void* offset, const void* mask, const void* g,
                          void* dw, int n, int cin, int h, int w, int cout, int is_bf16,
                          void* stream) {
  return dispatch<false, false, true>(x, offset, mask, nullptr, g, nullptr, nullptr, nullptr, dw,
                                      n, cin, h, w, cout, is_bf16, stream);
}

extern "C" int dcn_bwd_dqdw(const void* x, const void* offset, const void* mask,
                            const void* weight, const void* g, void* doffset, void* dmask,
                            void* dw, int n, int cin, int h, int w, int cout, int is_bf16,
                            void* stream) {
  return dispatch<false, true, true>(x, offset, mask, weight, g, nullptr, doffset, dmask, dw, n,
                                     cin, h, w, cout, is_bf16, stream);
}
