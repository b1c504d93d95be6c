// Corner pooling: directional running max of an NCHW float32 tensor.
//
// Replaces the TPU kernel corner_pool_pallas
// (scd_resnet_tpu/ops/pallas_kernels.py:260, body _pool_kernel l.222),
// which walks the pooled axis of a VMEM-resident NHWC block with a carry
// vector. Here the tensor is NCHW (B, C, H, W), contiguous:
//
//   dim 2 (H): top pool = reverse, bottom pool = forward;
//   dim 3 (W): left pool = reverse, right pool = forward.
//
// What bounds it: memory. Each element is read once and written once
// with one compare in between, so at the served shape (48,128,128,128)
// the floor is 2 x 402.7 MB over the card's memory rate (about 0.24 ms on
// an H100 SXM at 3.35 TB/s). The design keeps every load and store
// coalesced and reads each element exactly once:
//
//   * H direction: one thread per (b, c, w) column walks the rows. The 32
//     threads of a warp hold 32 neighbouring w, so each row step is one
//     128-byte load and one 128-byte store per warp.
//   * W direction: one warp per (b, c, h) row. The row is taken in chunks
//     of 32 floats (one per lane, contiguous), each chunk is max-scanned
//     inside the warp with __shfl_up_sync, and the chunk's last value
//     carries into the next. A thread per row would stride its neighbours
//     W floats apart and waste most of each memory transaction.
//
// The running max propagates NaN (as torch.cummax and lax.cummax do) and
// otherwise returns input values only, so the result is exact.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

// a is earlier in scan order, b later
__device__ __forceinline__ float run_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

__global__ void pool_h_kernel(const float* __restrict__ x,
                              float* __restrict__ y, long long columns,
                              int H, int W, int reverse) {
  long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= columns) return;
  long long bc = col / W;
  int w = (int)(col - bc * W);
  long long base = bc * (long long)H * W + w;
  const float* src = x + base;
  float* dst = y + base;
  float m = -INFINITY;
  if (reverse) {
#pragma unroll 8
    for (int i = H - 1; i >= 0; --i) {
      m = run_max(m, __ldg(src + (long long)i * W));
      dst[(long long)i * W] = m;
    }
  } else {
#pragma unroll 8
    for (int i = 0; i < H; ++i) {
      m = run_max(m, __ldg(src + (long long)i * W));
      dst[(long long)i * W] = m;
    }
  }
}

__global__ void pool_w_kernel(const float* __restrict__ x,
                              float* __restrict__ y, long long rows, int W,
                              int reverse) {
  const unsigned full = 0xffffffffu;
  int lane = threadIdx.x & 31;
  long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (row >= rows) return;  // whole warps leave together
  const float* src = x + row * W;
  float* dst = y + row * W;
  float carry = -INFINITY;
  for (int start = 0; start < W; start += 32) {
    int k = start + lane;  // position in scan order
    int pos = reverse ? W - 1 - k : k;
    bool valid = k < W;
    float v = valid ? __ldg(src + pos) : -INFINITY;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      float t = __shfl_up_sync(full, v, off);
      if (lane >= off) v = run_max(t, v);
    }
    v = run_max(carry, v);
    if (valid) dst[pos] = v;
    carry = __shfl_sync(full, v, 31);
  }
}

}  // namespace

extern "C" {

// x, y: (B, C, H, W) contiguous float32 on the device; dim 2 or 3.
int corner_pool_f32(const float* x, float* y, long long B, long long C,
                    int H, int W, int dim, int reverse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  if (dim == 2) {
    long long columns = B * C * W;
    long long blocks = (columns + threads - 1) / threads;
    pool_h_kernel<<<(unsigned)blocks, threads, 0, s>>>(x, y, columns, H, W,
                                                        reverse);
  } else if (dim == 3) {
    long long rows = B * C * H;
    long long warps_per_block = threads / 32;
    long long blocks = (rows + warps_per_block - 1) / warps_per_block;
    pool_w_kernel<<<(unsigned)blocks, threads, 0, s>>>(x, y, rows, W,
                                                        reverse);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
