// Pairwise rotated IoU on Hopper (sm_90a), one thread per pair: R1.
//
// Replaces no Pallas kernel. The JAX package's `pairwise_iou_rotated_jnp`
// (detectron2_centernet_tpu/ops/roi_align_rotated.py:57-144) vmaps a
// Sutherland-Hodgman clip with 64-vertex buffers over every pair, which XLA
// fuses on the TPU. In eager PyTorch the same clip (the plain version,
// `ops/roi_align_rotated.py::pairwise_iou_rotated_plain`) is ~200 launches
// over (pairs, 16) buffers: at the RRPN's matching, 20 gt x 112 500 anchors a
// 800² image, that is GBs of temporaries per image. Here each thread clips
// its pair in registers and local memory (`iou_rotated.cuh`, shared with
// the rotated NMS) and writes one float.
//
// What it computes: out[b, i, j] = iou(a[b, i], c[b, j]) for boxes
// (cx, cy, w, h, angle in degrees) f32, the first box the clipped subject
// (`rotated::iou`); a batch stride of 0 broadcasts one set over the batch
// (the anchors). Built with `-fmad=false`, so each step rounds as the plain
// version's tensor ops do.
//
// What bounds it on this card: the operations of the clip, ~400 f32
// operations and two sincos per pair that overlaps; pairs whose circles lie
// apart cost a dozen. The grid puts the second set (the many anchors or
// proposals) along x, so a warp's outputs are one coalesced row and its
// first box is one broadcast load.

#include <cuda_runtime.h>

#include "iou_rotated.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) iou_rotated_kernel(const float* __restrict__ a, long long a_batch,
                                                              const float* __restrict__ c, long long c_batch,
                                                              float* __restrict__ out, int n, int m) {
  const int b = blockIdx.z;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= m) return;
  const rotated::Box5 q = rotated::load_box(c + b * c_batch + static_cast<long long>(j) * 5);
  for (int i = blockIdx.y; i < n; i += gridDim.y) {
    const rotated::Box5 p = rotated::load_box(a + b * a_batch + static_cast<long long>(i) * 5);
    out[(static_cast<long long>(b) * n + i) * m + j] = rotated::iou(p, q);
  }
}

}  // namespace

extern "C" {

// a (batch, n, 5) and c (batch, m, 5) f32, each box's 5 floats contiguous,
// a batch stride (in floats) of 0 to broadcast; out (batch, n, m) f32.
int iou_rotated(const void* a, long long a_batch, const void* c, long long c_batch, void* out, int batch, int n,
                int m, cudaStream_t stream) {
  if (batch <= 0 || n <= 0 || m <= 0) return 0;
  const dim3 grid((m + kThreads - 1) / kThreads, n < 65535 ? n : 65535, batch);
  iou_rotated_kernel<<<grid, kThreads, 0, stream>>>(static_cast<const float*>(a), a_batch,
                                                    static_cast<const float*>(c), c_batch, static_cast<float*>(out),
                                                    n, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
