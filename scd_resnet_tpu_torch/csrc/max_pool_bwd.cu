// Backward of the stem's 3x3 / stride 2 / pad 1 max pool: d(input) from
// d(output), a window's gradient going to its first maximum in raster
// order.
//
// Replaces the TPU kernel pool_bwd_pallas (tools/pool_bwd_pallas_probe.py:
// 120, body _kernel l.46), which scatters four window rows at a time into
// a VMEM ring. Here it is a gather, with no atomics and no index tensor.
// x (B, C, H, W), dy (B, C, Ho, Wo), dx like x. Input pixel (i, j) lies in
// the windows (oy, ox) with 2 oy - 1 <= i <= 2 oy + 1 and 2 ox - 1 <= j <=
// 2 ox + 1: one window for an even index, two for an odd one. A window's
// gradient goes to the first of its nine taps in raster order equal to
// their maximum m, padding counting as -inf and a NaN propagating (to no
// pixel when that tap is padding or m is NaN). Each pixel adds dy of the
// windows it wins in (oy, ox) ascending order, in float32, and rounds
// once to the input's type. ops/max_pool.max_pool_3x3_s2_bwd_plain is
// the same function in PyTorch and adds in the same order, so the two
// agree to the bit.
//
// Design: one thread per 2 x 2 block of input pixels (2 oy .. 2 oy + 1,
// 2 ox .. 2 ox + 1). Every window those pixels lie in is among (oy, ox),
// (oy, ox + 1), (oy + 1, ox) and (oy + 1, ox + 1), whose taps span the
// 5 x 5 input patch from (2 oy - 1, 2 ox - 1): the thread loads the patch
// once into registers, finds the four windows' first maxima there and
// writes its four pixels. (The first version, one thread per input pixel
// rescanning each of its windows from memory, about 40 loads a pixel,
// took 3.97 ms at the shape below on an H100 80GB HBM3 at 700 W.)
//
// What bounds it: memory. x and dy are read once and dx written once: at
// the training shape (32, 64, 256, 256) bf16, 268.4 + 67.1 + 268.4 MB,
// 0.180 ms at 3.35 TB/s. Neighbouring threads' patches overlap by one
// column and row, which come from L1; a warp's loads and stores cover
// contiguous rows.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// the first tap (raster order) of the 3 x 3 window at patch offset
// (r0, c0) equal to the window's maximum, as patch coordinates packed
// r * 8 + c; -1 when that tap is padding or the maximum is NaN
__device__ __forceinline__ int first_max(const float (&v)[5][5],
                                         const bool (&in)[5][5], int r0,
                                         int c0) {
  float m = -INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      float t = v[r0 + a][c0 + b];
      m = (t > m || t != t) ? t : m;
    }
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    int r = r0 + t / 3, c = c0 + t % 3;
    if (v[r][c] == m) return in[r][c] ? r * 8 + c : -1;
  }
  return -1;
}

// one thread's 2 x 2 block (2 oy .. 2 oy + 1, 2 ox .. 2 ox + 1) of one
// (b, c) plane; in-plane indices are 32-bit
template <typename T>
__device__ __forceinline__ void block_bwd(const T* __restrict__ plane,
                                          const T* __restrict__ grad,
                                          T* __restrict__ out, int oy, int ox,
                                          int H, int W, int Ho, int Wo) {
  // the 5 x 5 patch from (2 oy - 1, 2 ox - 1), padding as -inf
  float v[5][5];
  bool in[5][5];
#pragma unroll
  for (int r = 0; r < 5; ++r) {
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      int i = 2 * oy - 1 + r, j = 2 * ox - 1 + c;
      in[r][c] = i >= 0 && i < H && j >= 0 && j < W;
      v[r][c] = in[r][c] ? load(plane + i * W + j) : -INFINITY;
    }
  }
  // windows (oy + wy, ox + wx) in ascending order; their taps start at
  // patch row 2 wy, column 2 wx
  int win[4];
  float g[4];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    int wy = w / 2, wx = w % 2;
    bool exists = oy + wy < Ho && ox + wx < Wo;
    win[w] = exists ? first_max(v, in, 2 * wy, 2 * wx) : -1;
    g[w] = win[w] >= 0 ? load(grad + (oy + wy) * Wo + (ox + wx)) : 0.0f;
  }
  // the block's pixels sit at patch rows and columns 1 and 2
#pragma unroll
  for (int di = 0; di < 2; ++di) {
#pragma unroll
    for (int dj = 0; dj < 2; ++dj) {
      int i = 2 * oy + di, j = 2 * ox + dj;
      if (i >= H || j >= W) continue;
      int here = (1 + di) * 8 + (1 + dj);
      float acc = 0.0f;
#pragma unroll
      for (int w = 0; w < 4; ++w)
        if (win[w] == here) acc = __fadd_rn(acc, g[w]);
      store(out + i * W + j, acc);
    }
  }
}

// grid (ceil(Ho Wo / blockDim), min(planes, 65535)): x walks a plane's
// 2 x 2 blocks, y the (b, c) planes
template <typename T>
__global__ void max_pool_bwd_kernel(const T* __restrict__ x,
                                    const T* __restrict__ dy,
                                    T* __restrict__ dx, long long planes,
                                    int H, int W, int Ho, int Wo) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= Ho * Wo) return;
  for (long long bc = blockIdx.y; bc < planes; bc += gridDim.y)
    block_bwd(x + bc * H * W, dy + bc * Ho * Wo, dx + bc * H * W, p / Wo,
              p % Wo, H, W, Ho, Wo);
}

template <typename T>
int launch(const T* x, const T* dy, T* dx, long long B, long long C, int H,
           int W, void* stream) {
  if (H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  if ((long long)H * W > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const long long planes = B * C;
  if (planes <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;  // one thread per 2 x 2 block of a plane
  dim3 grid((unsigned)((Ho * Wo + threads - 1) / threads),
            (unsigned)(planes < 65535 ? planes : 65535));
  max_pool_bwd_kernel<T><<<grid, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      x, dy, dx, planes, H, W, Ho, Wo);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, dx: (B, C, H, W) and dy: (B, C, (H-1)/2+1, (W-1)/2+1), contiguous on
// the device, of one type: float32 or bfloat16.
int max_pool_3x3_s2_bwd_f32(const float* x, const float* dy, float* dx,
                            long long B, long long C, int H, int W,
                            void* stream) {
  return launch<float>(x, dy, dx, B, C, H, W, stream);
}

int max_pool_3x3_s2_bwd_bf16(const void* x, const void* dy, void* dx,
                             long long B, long long C, int H, int W,
                             void* stream) {
  return launch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x),
                               static_cast<const __nv_bfloat16*>(dy),
                               static_cast<__nv_bfloat16*>(dx), B, C, H, W,
                               stream);
}

const char* cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
