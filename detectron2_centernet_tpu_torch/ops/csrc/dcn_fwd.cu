// Modulated deformable 3x3 convolution (DCNv2) forward for Hopper (sm_90a).
//
// Replaces the TPU kernel detectron2_centernet_tpu/ops/pallas_dcn.py::_kernel
// (the tent-matmul forward with the fused BN + bias + ReLU epilogue). Same
// function, exact DCNv2 semantics: every sample is bilinear with zero padding,
// wherever its offset points (the TPU kernel drops samples beyond |dy| > 3).
//
// Layout: x (N, Cin, H, W), offset (N, 18, H, W) f32 with offset[2k] = dy and
// offset[2k+1] = dx for tap k in row-major (ky, kx) order, mask (N, 9, H, W)
// f32 (already sigmoided), weight (Cout, Cin, 3, 3), out (N, Cout, H, W).
// x, weight and out share one type: float or __nv_bfloat16.
//
// Design: an implicit GEMM out[co, p] = sum_k W[co, k] * col[k, p] with
// k = c * 9 + tap, the order of a flattened OIHW weight. A block owns BM
// output channels x BN output pixels of one image. It first builds, in shared
// memory, the bilinear corner indices and weights of its BN pixels for all 9
// taps (coordinate math in f32, mask folded into the weights). Then, one
// K-chunk of CK input channels (9 * CK rows) at a time, it gathers the
// modulated samples col[k, p] into shared memory, loads the matching weight
// tile, and accumulates in f32: with bf16 operands on the tensor cores
// (WMMA 16x16x16), with f32 operands on the FMA pipes. The epilogue
// (out * scale + shift, then ReLU) runs on the f32 accumulator before the one
// store.
//
// What bounds it: the least time for the work is set by the bytes it moves at
// most DLA-34 shapes at batch 1 and by the tensor-core rate at batch 16 (the
// GEMM does 2 * 9 * Cin FLOPs per output element). This first kernel is held
// back instead by its grid and its gather: a launch has (H*W/BN) * (Cout/BM)
// blocks, as few as 16 at the 16x16 and 32x32 maps of batch 1 (the card has
// 132 SMs), each walking the whole 9 * Cin axis alone; every column element
// costs four scattered loads and is rebuilt once per output-channel tile.
// Splitting the K axis across blocks, wgmma, TMA and a gather shared across
// output-channel tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <type_traits>

namespace {

constexpr int BM = 64;        // output channels per block
constexpr int BN = 64;        // output pixels per block
constexpr int CK = 16;        // input channels per K-chunk
constexpr int BK = CK * 9;    // rows of the gathered column tile per chunk
constexpr int THREADS = 128;  // four warps

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

template <typename T>
constexpr size_t smem_bytes() {
  return (size_t)(BM * BK + BK * BN) * sizeof(T) + (size_t)9 * BN * (sizeof(int4) + sizeof(float4));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dcn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ offset,
               const float* __restrict__ mask, const T* __restrict__ weight,
               const float* __restrict__ scale, const float* __restrict__ shift,
               T* __restrict__ out, int cin, int h, int w, int cout, int relu) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* ws = reinterpret_cast<T*>(smem);                                // [BM][BK]
  T* cs = ws + BM * BK;                                              // [BK][BN]
  int4* tab_idx = reinterpret_cast<int4*>(cs + BK * BN);             // [9][BN]
  float4* tab_w = reinterpret_cast<float4*>(tab_idx + 9 * BN);       // [9][BN]

  const int hw = h * w;
  const int n = blockIdx.z;
  const int p0 = blockIdx.x * BN;
  const int co0 = blockIdx.y * BM;
  const int tid = threadIdx.x;

  // 1. Sampling table: the four corners of every (tap, pixel) sample.
  const float* off_n = offset + (size_t)n * 18 * hw;
  const float* msk_n = mask + (size_t)n * 9 * hw;
  for (int e = tid; e < 9 * BN; e += THREADS) {
    const int tap = e / BN;
    const int p = p0 + (e - tap * BN);
    int4 idx = make_int4(0, 0, 0, 0);
    float4 wt = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p < hw) {
      const int oy = p / w;
      const int ox = p - oy * w;
      const float py = (float)(oy - 1 + tap / 3) + off_n[(size_t)(2 * tap) * hw + p];
      const float px = (float)(ox - 1 + tap % 3) + off_n[(size_t)(2 * tap + 1) * hw + p];
      const float m = msk_n[(size_t)tap * hw + p];
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
        if (y0_in && x0_in) { idx.x = y0 * w + x0;           wt.x = hy * hx * m; }
        if (y0_in && x1_in) { idx.y = y0 * w + x0 + 1;       wt.y = hy * lx * m; }
        if (y1_in && x0_in) { idx.z = (y0 + 1) * w + x0;     wt.z = ly * hx * m; }
        if (y1_in && x1_in) { idx.w = (y0 + 1) * w + x0 + 1; wt.w = ly * lx * m; }
      }
    }
    tab_idx[e] = idx;
    tab_w[e] = wt;
  }

  constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;
  const int warp = tid / 32;
  const int wm = warp / 2;  // tensor-core path: 2 x 2 warps of 32 x 32
  const int wn = warp % 2;
  const int ty = tid / 16;  // FMA path: 8 x 16 threads of 8 channels x 4 pixels
  const int tx = tid % 16;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc[2][2];
  float accf[8][4];
  if constexpr (kTensorCores) {
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.f);
  } else {
    for (int i = 0; i < 8; ++i)
      for (int j = 0; j < 4; ++j) accf[i][j] = 0.f;
  }

  const T* x_n = x + (size_t)n * cin * hw;
  for (int c0 = 0; c0 < cin; c0 += CK) {
    __syncthreads();  // the table is written / the last chunk's tiles are read
    // 2. Weight tile: rows co0.., columns c0 * 9 .. c0 * 9 + BK (contiguous).
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK;
      const int kk = e - r * BK;
      const int co = co0 + r;
      T v = from_f32<T>(0.f);
      if (co < cout && c0 + kk / 9 < cin) v = weight[((size_t)co * cin + c0) * 9 + kk];
      ws[e] = v;
    }
    // 3. Column tile: modulated bilinear samples, neighbouring threads on
    //    neighbouring pixels of one channel plane.
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int kk = e / BN;
      const int pl = e - kk * BN;
      const int c = c0 + kk / 9;
      const int tap = kk - (kk / 9) * 9;
      float v = 0.f;
      if (c < cin) {
        const T* xc = x_n + (size_t)c * hw;
        const int4 id = tab_idx[tap * BN + pl];
        const float4 wt = tab_w[tap * BN + pl];
        v = wt.x * to_f32(xc[id.x]) + wt.y * to_f32(xc[id.y]) +
            wt.z * to_f32(xc[id.z]) + wt.w * to_f32(xc[id.w]);
      }
      cs[e] = from_f32<T>(v);
    }
    __syncthreads();
    // 4. Accumulate the chunk's product in f32.
    if constexpr (kTensorCores) {
      using namespace nvcuda;
      for (int ks = 0; ks < BK / 16; ++ks) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], ws + (wm * 32 + i * 16) * BK + ks * 16, BK);
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], cs + (ks * 16) * BN + wn * 32 + j * 16, BN);
        for (int i = 0; i < 2; ++i)
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
    } else {
      for (int kk = 0; kk < BK; ++kk) {
        const float4 bv = *reinterpret_cast<const float4*>(&cs[kk * BN + tx * 4]);
        for (int i = 0; i < 8; ++i) {
          const float av = to_f32(ws[(ty * 8 + i) * BK + kk]);
          accf[i][0] += av * bv.x;
          accf[i][1] += av * bv.y;
          accf[i][2] += av * bv.z;
          accf[i][3] += av * bv.w;
        }
      }
    }
  }

  // 5. Epilogue: scale, shift, ReLU on the f32 accumulator; one store.
  T* out_n = out + (size_t)n * cout * hw;
  if constexpr (kTensorCores) {
    __syncthreads();  // reuse the operand tiles as an f32 [BM][BN] stage
    float* stage = reinterpret_cast<float*>(smem);
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j)
        nvcuda::wmma::store_matrix_sync(stage + (wm * 32 + i * 16) * BN + wn * 32 + j * 16,
                                        acc[i][j], BN, nvcuda::wmma::mem_row_major);
    __syncthreads();
    for (int e = tid; e < BM * BN; e += THREADS) {
      const int r = e / BN;
      const int co = co0 + r;
      const int p = p0 + (e - r * BN);
      if (co < cout && p < hw) {
        float v = stage[e];
        if (scale != nullptr) v *= scale[co];
        if (shift != nullptr) v += shift[co];
        if (relu) v = fmaxf(v, 0.f);
        out_n[(size_t)co * hw + p] = from_f32<T>(v);
      }
    }
  } else {
    for (int i = 0; i < 8; ++i) {
      const int co = co0 + ty * 8 + i;
      if (co >= cout) continue;
      const float sc = scale != nullptr ? scale[co] : 1.f;
      const float sh = shift != nullptr ? shift[co] : 0.f;
      for (int j = 0; j < 4; ++j) {
        const int p = p0 + tx * 4 + j;
        if (p >= hw) continue;
        float v = accf[i][j] * sc + sh;
        if (relu) v = fmaxf(v, 0.f);
        out_n[(size_t)co * hw + p] = from_f32<T>(v);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* offset, const void* mask, const void* weight,
                   const void* scale, const void* shift, void* out, int n, int cin, int h,
                   int w, int cout, int relu, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(dcn_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((h * w + BN - 1) / BN, (cout + BM - 1) / BM, n);
  dcn_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(offset),
      static_cast<const float*>(mask), static_cast<const T*>(weight),
      static_cast<const float*>(scale), static_cast<const float*>(shift), static_cast<T*>(out),
      cin, h, w, cout, relu);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). scale and shift may be null
// (no scale, no shift). Returns the launch's cudaError_t; it allocates nothing
// and does not synchronize.
extern "C" int dcn_fwd(const void* x, const void* offset, const void* mask, const void* weight,
                       const void* scale, const void* shift, void* out, int n, int cin, int h,
                       int w, int cout, int relu, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(x, offset, mask, weight, scale, shift, out, n, cin, h, w,
                                      cout, relu, s);
  return (int)launch<float>(x, offset, mask, weight, scale, shift, out, n, cin, h, w, cout,
                            relu, s);
}
