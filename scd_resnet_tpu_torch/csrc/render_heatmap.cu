// Gaussian heatmap labels: the sum of K truncated-center Gaussians per
// clip, clamped to 1.
//
// Replaces the TPU kernel render_heatmap_pallas
// (scd_resnet_tpu/ops/pallas_kernels.py:77, body _render_kernel l.41),
// which accumulates the K objects of one clip into a VMEM tile. Inputs:
// locs (B, K, 8) float32 records [ctX, ctY, offX, offY, majX, majY, minL,
// halo] in heatmap coordinates and valid (B, K) uint8; output (B, S, S)
// float32. Per object (ops/gaussian.render_heatmap_plain is the same
// function in PyTorch):
//
//   cx, cy = trunc(ctX + offX'), trunc(ctY + offY'); ok = valid &&
//   0 <= cx, cy < S
//   r = radius(2 |maj|, 2 minL, iou), or 1 where !ok or r <= 0;
//   roi = ceil(2r); sigma = r / 3
//   heat += exp(-(dx^2 + dy^2) / (2 sigma^2)) where |dx|, |dy| <= roi
//
// and heat = min(heat, 1), so every center is exactly 1.0. Two variants:
// the center heatmap (radius = center_threshold_radius, no offset) and
// the corner heatmaps (radius = corner_threshold_radius, the corner at
// the center plus a (B, K, 2) float32 offset (offX', offY'), as the
// JAX non-legacy corner branch renders its tl and br maps: a corner in
// (-1, 0) truncates to 0 and is stamped there).
//
// What bounds it: at the training shape (32, 30, 8) -> 128^2 it writes
// 2.1 MB and does 15.7 M pixel-object terms (an expf and ~10 flops each,
// most skipped by the box test), a few microseconds of the card; in
// practice launch latency. The design never stores anything of size
// K x S x S (the plain version's (B, S, S) per-object temporaries):
//
//   * grid (B, ceil(S^2 / 256)), one thread per output pixel, so each
//     store is coalesced and the clip's records are read once per block;
//   * threads 0..K-1 each derive one object's center, mask, box and
//     2 sigma^2 once into shared memory;
//   * each thread then adds the objects in order k = 0..K-1, as the plain
//     version and the Pallas kernel do, skipping pixels outside the box
//     (adding +0.0 changes nothing).
//
// Exactness: the float32 operations run in the JAX function's order with
// round-to-nearest intrinsics (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn, __fsqrt_rn), so no multiply-add is contracted into an FMA
// and sqrt and division are IEEE; expf is CUDA's (2 ulp). The constants
// derived from the IoU threshold are computed in double and rounded to
// float, as Python computes them before JAX and PyTorch see them.
//
// Plain C interface for ctypes: the entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

struct Consts {
  float one_minus_t;   // 1 - t
  float one_plus_t;    // 1 + t
  float minus_two_t;   // -2 t
  float t_minus_one;   // t - 1
  float sixteen_t;     // 4 a3, a3 = 4 t
  float corner_c;      // 16 (1 - t)
};

struct Object {
  float cx, cy, roi, two_sigma_sq;
  int ok;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// ops/radius.center_threshold_radius, operation for operation
__device__ float center_radius(float w, float h, const Consts& c) {
  float b1 = add(h, w);
  float c1 = dvd(mul(mul(w, h), c.one_minus_t), c.one_plus_t);
  float r1 = dvd(add(b1, __fsqrt_rn(sub(mul(b1, b1), mul(4.0f, c1)))), 2.0f);

  float b2 = mul(2.0f, add(h, w));
  float c2 = mul(mul(c.one_minus_t, w), h);
  float r2 = dvd(add(b2, __fsqrt_rn(sub(mul(b2, b2), mul(16.0f, c2)))), 2.0f);

  float b3 = mul(c.minus_two_t, add(h, w));
  float c3 = mul(mul(c.t_minus_one, w), h);
  float r3 = dvd(add(b3, __fsqrt_rn(sub(mul(b3, b3), mul(c.sixteen_t, c3)))),
                 2.0f);
  return fminf(fminf(r1, r2), r3);
}

// ops/radius.corner_threshold_radius, operation for operation
__device__ float corner_radius(float w, float h, const Consts& c) {
  float sum_sq = add(mul(w, w), mul(h, h));
  float prod = mul(w, h);
  float lead = dvd(mul(2.0f, __fsqrt_rn(sum_sq)), prod);
  float root = __fsqrt_rn(sub(dvd(mul(4.0f, sum_sq), mul(prod, prod)),
                              dvd(c.corner_c, sum_sq)));
  return dvd(sub(lead, root), dvd(8.0f, sum_sq));
}

// kCorner: the corner radius and offsets (offs (B, K, 2)); else the center
template <bool kCorner>
__global__ void render_heatmap_kernel(const float* __restrict__ locs,
                                      const unsigned char* __restrict__ valid,
                                      const float* __restrict__ offs,
                                      float* __restrict__ heat, int K, int S,
                                      Consts c) {
  extern __shared__ Object objects[];
  const int b = blockIdx.x;
  const float* rec = locs + (long long)b * K * 8;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float* r = rec + k * 8;
    float px = r[0], py = r[1];
    if (kCorner) {
      const float* o = offs + ((long long)b * K + k) * 2;
      px = add(px, o[0]);
      py = add(py, o[1]);
    }
    float cx = truncf(px);
    float cy = truncf(py);
    bool ok = valid[(long long)b * K + k] != 0 && cx >= 0.0f &&
              cx < (float)S && cy >= 0.0f && cy < (float)S;
    float maj = __fsqrt_rn(add(mul(r[4], r[4]), mul(r[5], r[5])));
    float w = mul(2.0f, maj), h = mul(2.0f, r[6]);
    float radius = kCorner ? corner_radius(w, h, c) : center_radius(w, h, c);
    radius = (ok && radius > 0.0f) ? radius : 1.0f;
    float sigma = dvd(radius, 3.0f);
    Object o;
    o.cx = cx;
    o.cy = cy;
    o.roi = ceilf(mul(radius, 2.0f));
    o.two_sigma_sq = mul(mul(2.0f, sigma), sigma);
    o.ok = ok;
    objects[k] = o;
  }
  __syncthreads();

  const int pixel = blockIdx.y * blockDim.x + threadIdx.x;
  if (pixel >= S * S) return;
  const float y = (float)(pixel / S);
  const float x = (float)(pixel % S);
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) {
    const Object o = objects[k];
    float dx = sub(x, o.cx);
    float dy = sub(y, o.cy);
    if (!o.ok || fabsf(dx) > o.roi || fabsf(dy) > o.roi) continue;
    float d2 = add(mul(dx, dx), mul(dy, dy));
    acc = add(acc, expf(dvd(-d2, o.two_sigma_sq)));
  }
  heat[(long long)b * S * S + pixel] = fminf(acc, 1.0f);
}

}  // namespace

extern "C" {

// locs (B, K, 8) float32, valid (B, K) uint8, heat (B, S, S) float32, all
// contiguous on the device; threshold is the IoU of the radius solver.
// offsets: null for the center heatmap, else (B, K, 2) float32 corner
// offsets, which select the corner radius.
int render_heatmap_f32(const float* locs, const unsigned char* valid,
                       const float* offsets, float* heat, int B, int K,
                       int S, double threshold, void* stream) {
  const int threads = 256;
  long long tiles = ((long long)S * S + threads - 1) / threads;
  if (B <= 0 || S <= 0 || K < 0 || tiles > 65535)
    return (int)cudaErrorInvalidValue;
  Consts c;
  c.one_minus_t = (float)(1.0 - threshold);
  c.one_plus_t = (float)(1.0 + threshold);
  c.minus_two_t = (float)(-2.0 * threshold);
  c.t_minus_one = (float)(threshold - 1.0);
  c.sixteen_t = (float)(4.0 * (4.0 * threshold));
  c.corner_c = (float)(16.0 * (1.0 - threshold));
  dim3 grid((unsigned)B, (unsigned)tiles);
  size_t smem = (size_t)K * sizeof(Object);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (offsets != nullptr)
    render_heatmap_kernel<true><<<grid, threads, smem, s>>>(
        locs, valid, offsets, heat, K, S, c);
  else
    render_heatmap_kernel<false><<<grid, threads, smem, s>>>(
        locs, valid, offsets, heat, K, S, c);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
