// Deformable bilinear gather (the im2col of a modulated deformable
// convolution, DCNv2) and its backward.
//
// Replaces the TPU kernel dcn_gather_pallas
// (scd_resnet_tpu/ops/pallas_kernels.py:190, body _dcn_gather_kernel
// l.106) and its XLA backward (l.206-216). Inputs: x (B, H, W, C) float32
// channels-last, positions py, px (B, N) float32; output (B, N, C)
// float32. Per sample (ops/dcn.dcn_gather_plain is the same function in
// PyTorch):
//
//   y0 = floor(py), ly = py - y0, hy = 1 - ly   (likewise x0, lx, hx)
//   out = sum over the corners (y0, x0), (y0, x0+1), (y0+1, x0),
//         (y0+1, x0+1) of x[corner] * (w_c * v_c), weights hy hx, hy lx,
//         ly hx, ly lx, v_c = 1 when the corner lies in the map and the
//         sample inside the outer cutoff (-1 < py < H, -1 < px < W).
//
// The backward, for a cotangent g (B, N, C): dx[corner] += v_c w_c g;
// dpy = sum_c v_c (d w_c / d py) <g, x[corner]> (d/dpy of the four
// weights: -hx, -lx, +hx, +lx) and dpx likewise (-hy, +hy, -ly, +ly);
// floor and the flags pass no gradient.
//
// The TPU body builds a one-hot (TILE_N, HW) weight matrix and multiplies
// it with the VMEM-resident map on the MXU. On this card that product is
// pointless work: each sample needs four rows of C values. What bounds
// the kernel is memory: at the served shape, x (48, 16, 16, 512) is 25 MB
// and the output (48, 2304, 512) 226 MB, so the least time is the output
// write, 0.075 ms at 3.35 TB/s; the corner reads hit L2 (x is 0.5 MB per
// image, read by 2304 x 4 corners). The design:
//
//   * one warp per sample: lane 0..31 derive the same four corner
//     indices and weights in registers (no shared memory), then the lanes
//     stride over C, so every row read and every output write is 128
//     contiguous bytes per warp instruction;
//   * the backward keeps the mapping: the lanes atomicAdd v_c w_c g into
//     a zeroed float32 dx (B, H, W, C) (each map pixel is a corner of up
//     to 4 K samples of its neighbourhood, so the adds collide; no order
//     is fixed) and reduce their partial dpy and dpx over C with warp
//     shuffles; lane 0 writes them.
//
// Exactness: the lerp weights and the four-corner sum are evaluated in
// the plain version's order with round-to-nearest intrinsics (__fsub_rn,
// __fmul_rn, __fadd_rn), so no multiply-add is contracted into an FMA:
// the forward equals its plain version to the bit, NaN in x included (an
// invalid corner reads the clamped pixel and multiplies it by 0, as the
// plain version does). The backward's atomics add in any order, so it is
// held to the float32 summation bound.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;  // samples per block of 256 threads

struct Corners {
  long long row[4];  // pixel index y * W + x in the image, clamped
  bool live[4];      // v_c: the corner in the map, the sample inside the cutoff
  float w[4];        // the lerp weight where live, else 0
  float d_py[4];     // d w / d py where live, else 0
  float d_px[4];
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ Corners corners(float py, float px, int H, int W) {
  Corners k;
  const float y0 = floorf(py), x0 = floorf(px);
  const float ly = sub(py, y0), lx = sub(px, x0);
  const float hy = sub(1.0f, ly), hx = sub(1.0f, lx);
  const bool inside = py > -1.0f && py < (float)H && px > -1.0f &&
                      px < (float)W;
  const float weight[4] = {mul(hy, hx), mul(hy, lx), mul(ly, hx),
                           mul(ly, lx)};
  const float dwy[4] = {-hx, -lx, hx, lx};
  const float dwx[4] = {-hy, hy, -ly, ly};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float yi = add(y0, (float)(c >> 1));
    const float xi = add(x0, (float)(c & 1));
    const bool valid = yi >= 0.0f && yi < (float)H && xi >= 0.0f &&
                       xi < (float)W;
    // clamp as jnp.clip does before the integer cast
    const int yc = (int)fminf(fmaxf(yi, 0.0f), (float)(H - 1));
    const int xc = (int)fminf(fmaxf(xi, 0.0f), (float)(W - 1));
    k.row[c] = (long long)yc * W + xc;
    k.live[c] = valid && inside;
    k.w[c] = k.live[c] ? weight[c] : 0.0f;
    k.d_py[c] = k.live[c] ? dwy[c] : 0.0f;
    k.d_px[c] = k.live[c] ? dwx[c] : 0.0f;
  }
  return k;
}

__global__ void __launch_bounds__(kWarps * 32)
dcn_gather_kernel(const float* __restrict__ x, const float* __restrict__ py,
                  const float* __restrict__ px, float* __restrict__ out,
                  int H, int W, int C, long long N, long long samples) {
  const long long s = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (s >= samples) return;
  const int lane = threadIdx.x % 32;
  const long long b = s / N;
  const Corners k = corners(py[s], px[s], H, W);
  const float* image = x + b * H * W * C;
  const float* r0 = image + k.row[0] * C;
  const float* r1 = image + k.row[1] * C;
  const float* r2 = image + k.row[2] * C;
  const float* r3 = image + k.row[3] * C;
  float* o = out + s * C;
  for (int c = lane; c < C; c += 32) {
    float acc = mul(__ldg(r0 + c), k.w[0]);
    acc = add(acc, mul(__ldg(r1 + c), k.w[1]));
    acc = add(acc, mul(__ldg(r2 + c), k.w[2]));
    o[c] = add(acc, mul(__ldg(r3 + c), k.w[3]));
  }
}

__global__ void __launch_bounds__(kWarps * 32)
dcn_gather_bwd_kernel(const float* __restrict__ x,
                      const float* __restrict__ py,
                      const float* __restrict__ px,
                      const float* __restrict__ g, float* __restrict__ dx,
                      float* __restrict__ dpy, float* __restrict__ dpx,
                      int H, int W, int C, long long N, long long samples) {
  const long long s = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (s >= samples) return;
  const int lane = threadIdx.x % 32;
  const long long b = s / N;
  const Corners k = corners(py[s], px[s], H, W);
  const long long image = b * H * W * C;
  const float* gs = g + s * C;
  float dot[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int ch = lane; ch < C; ch += 32) {
    const float gv = __ldg(gs + ch);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (!k.live[c]) continue;
      const long long at = image + k.row[c] * C + ch;
      dot[c] = add(dot[c], mul(gv, __ldg(x + at)));
      if (k.w[c] != 0.0f) atomicAdd(dx + at, mul(k.w[c], gv));
    }
  }
  float sy = 0.0f, sx = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    sy = add(sy, mul(k.d_py[c], dot[c]));
    sx = add(sx, mul(k.d_px[c], dot[c]));
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset /= 2) {
    sy = add(sy, __shfl_down_sync(0xffffffffu, sy, offset));
    sx = add(sx, __shfl_down_sync(0xffffffffu, sx, offset));
  }
  if (lane == 0) {
    dpy[s] = sy;
    dpx[s] = sx;
  }
}

bool bad_shape(int B, int H, int W, int C, long long N, long long* blocks) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || N <= 0) return true;
  const long long samples = (long long)B * N;
  *blocks = (samples + kWarps - 1) / kWarps;
  return *blocks > 2147483647LL;
}

}  // namespace

extern "C" {

// x (B, H, W, C), py and px (B, N), out (B, N, C); all float32,
// contiguous, on the device.
int dcn_gather_f32(const float* x, const float* py, const float* px,
                   float* out, int B, int H, int W, int C, long long N,
                   void* stream) {
  long long blocks = 0;
  if (bad_shape(B, H, W, C, N, &blocks)) return (int)cudaErrorInvalidValue;
  dcn_gather_kernel<<<(unsigned)blocks, kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      x, py, px, out, H, W, C, N, (long long)B * N);
  return (int)cudaGetLastError();
}

// the backward of dcn_gather_f32 for the cotangent g (B, N, C): dx
// (B, H, W, C) must hold zeros; dpy and dpx (B, N) are written.
int dcn_gather_bwd_f32(const float* x, const float* py, const float* px,
                       const float* g, float* dx, float* dpy, float* dpx,
                       int B, int H, int W, int C, long long N,
                       void* stream) {
  long long blocks = 0;
  if (bad_shape(B, H, W, C, N, &blocks)) return (int)cudaErrorInvalidValue;
  dcn_gather_bwd_kernel<<<(unsigned)blocks, kWarps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      x, py, px, g, dx, dpy, dpx, H, W, C, N, (long long)B * N);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
