// Pairwise rotated IoU on Hopper (sm_90a): R1.
//
// Replaces no Pallas kernel. The JAX package's `pairwise_iou_rotated_jnp`
// (detectron2_centernet_tpu/ops/roi_align_rotated.py:57-144) vmaps a
// Sutherland-Hodgman clip with 64-vertex buffers over every pair, which XLA
// fuses on the TPU. In eager PyTorch the same clip (the plain version,
// `ops/roi_align_rotated.py::pairwise_iou_rotated_plain`) is ~200 launches
// over (pairs, 16) buffers: at the RRPN's matching, 128 gt slots x 112 500
// anchors a 800² image, that is GBs of temporaries per image.
//
// What it computes: out[b, i, j] = iou(a[b, i], c[b, j]) for boxes
// (cx, cy, w, h, angle in degrees) f32, the first box the clipped subject
// (`iou_rotated.cuh`); a batch stride of 0 broadcasts one set over the batch
// (the anchors). Built with `-fmad=false`, so each step rounds as the plain
// version's tensor ops do.
//
// What bounds it on this card: writing the output (the RRPN's matching
// writes 115 MB, 34 µs at 3.35 TB/s), then the clips of the pairs whose
// circles overlap (~400 f32 operations each; a few percent of the
// matching's pairs). The design: a first kernel makes each box's record
// once (`iou_rotated_records`: its corners, diagonal, area; the
// trigonometry and square roots of a box, not of a pair) into the
// caller's scratch. Then a CTA takes kThreads boxes of the second set
// (along x, so a warp's outputs are one coalesced row) and kFirst of the
// first, writes the 0 of every pair `far_apart` rejects at once, and
// queues the others; then every thread clips queued pairs, so a warp's
// lanes all clip together rather than wait on the one lane whose pair
// overlaps. The clip runs in registers (`iou_rotated.cuh`): no local
// memory. (`separated`, which spares R2's bitmask many clips, costs R1 more
// than it saves: few of its queued pairs are apart.)

#include <cuda_runtime.h>

#include "iou_rotated.cuh"

namespace {

constexpr int kThreads = 128;  // boxes of the second set per CTA
constexpr int kFirst = 16;     // boxes of the first set per CTA
// CTAs an SM: ptxas then keeps the kernel in 80 registers without a spill (with no minimum it took 72 and
// spilled 12 bytes)
constexpr int kCtasPerSm = 6;

// One thread a box: the records of a's boxes (a batch stride of 0: one
// set), then c's, into rec.
__global__ void __launch_bounds__(256) iou_rotated_records(const float* __restrict__ a, long long a_batch,
                                                           const float* __restrict__ c, long long c_batch,
                                                           rotated::Record* __restrict__ rec, int na, int nc, int n,
                                                           int m) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x < na)
    rec[x] = rotated::make_record(rotated::load_box(a + (x / n) * a_batch + static_cast<long long>(x % n) * 5), 0);
  else if (x < na + nc)
    rec[x] = rotated::make_record(
        rotated::load_box(c + ((x - na) / m) * c_batch + static_cast<long long>((x - na) % m) * 5), 0);
}

// The pairs of image b (blockIdx.z): first-set records ra (n a image),
// second-set records rc (m a image), a set's image stride 0 when broadcast.
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    iou_rotated_kernel(const rotated::Record* __restrict__ ra, long long ra_batch,
                       const rotated::Record* __restrict__ rc, long long rc_batch, float* __restrict__ out, int n,
                       int m) {
  __shared__ rotated::RecordBlock<kThreads> cols;
  __shared__ rotated::RecordBlock<kFirst> rows;
  __shared__ float2 scratch[kThreads / 32][2][rotated::kMaxVertices];  // a warp's, for the general clip
  __shared__ unsigned short queue[kFirst * kThreads];
  __shared__ int count;
  const int b = blockIdx.z, tid = threadIdx.x, j0 = blockIdx.x * kThreads, j = j0 + tid;
  if (j < m) cols.put(tid, rc[b * rc_batch + j]);
  for (int i0 = blockIdx.y * kFirst; i0 < n; i0 += gridDim.y * kFirst) {
    const int rows_here = min(kFirst, n - i0);
    __syncthreads();  // the last pass's queue and rows are read
    if (tid == 0) count = 0;
    if (tid < rows_here) rows.put(tid, ra[b * ra_batch + i0 + tid]);
    __syncthreads();
    float* row_out = out + (static_cast<long long>(b) * n + i0) * m + j;
    for (int g = 0; g < rows_here; ++g) {
      const bool near = j < m && !rows.far_from(g, cols, tid);
      if (j < m && !near) row_out[static_cast<long long>(g) * m] = 0.f;
      rotated::enqueue(near, static_cast<unsigned short>(g << 7 | tid), queue, &count);
    }
    __syncthreads();
    const int queued = count;
    for (int e0 = tid & ~31; e0 < queued; e0 += kThreads) {  // a warp's lanes together
      const int e = e0 + (tid & 31), g = e < queued ? queue[e] >> 7 : 0;
      const int col = e < queued ? queue[e] & (kThreads - 1) : 0;
      const float v = rotated::near_iou(e < queued, rows.get(g), cols.get(col), scratch[tid >> 5]);
      if (e < queued) out[(static_cast<long long>(b) * n + i0 + g) * m + j0 + col] = v;
    }
  }
}

static_assert(kThreads == 128 && kFirst <= 512, "a queue entry is the first box's 9 bits over the second's 7");

}  // namespace

extern "C" {

// The bytes of scratch `iou_rotated` needs: a record for each box of a and
// of c (one set when its batch stride is 0).
int iou_rotated_scratch_bytes(long long a_batch, long long c_batch, int batch, int n, int m, void* out) {
  const long long boxes =
      static_cast<long long>(a_batch ? batch : 1) * n + static_cast<long long>(c_batch ? batch : 1) * m;
  *static_cast<long long*>(out) = boxes * static_cast<long long>(sizeof(rotated::Record));
  return 0;
}

// a (batch, n, 5) and c (batch, m, 5) f32, each box's 5 floats contiguous,
// a batch stride (in floats) of 0 to broadcast; out (batch, n, m) f32;
// scratch: iou_rotated_scratch_bytes(...) bytes, 16-byte aligned.
int iou_rotated(const void* a, long long a_batch, const void* c, long long c_batch, void* out, int batch, int n,
                int m, void* scratch, cudaStream_t stream) {
  if (batch <= 0 || n <= 0 || m <= 0) return 0;
  const int na = (a_batch ? batch : 1) * n, nc = (c_batch ? batch : 1) * m;
  rotated::Record* rec = static_cast<rotated::Record*>(scratch);
  iou_rotated_records<<<(na + nc + 255) / 256, 256, 0, stream>>>(static_cast<const float*>(a), a_batch,
                                                                 static_cast<const float*>(c), c_batch, rec, na, nc,
                                                                 n, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int first_blocks = (n + kFirst - 1) / kFirst;
  const dim3 grid((m + kThreads - 1) / kThreads, first_blocks < 65535 ? first_blocks : 65535, batch);
  iou_rotated_kernel<<<grid, kThreads, 0, stream>>>(rec, a_batch ? n : 0, rec + na, c_batch ? m : 0,
                                                    static_cast<float*>(out), n, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
