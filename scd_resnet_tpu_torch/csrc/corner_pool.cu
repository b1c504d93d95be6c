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
// Backward (corner_pool_bwd_f32): replaces the TPU kernel
// corner_pool_bwd_pallas (scd_resnet_tpu/ops/pallas_kernels.py:344, body
// _pool_bwd_kernel l.293). The cotangent g of out[i] goes to the running
// argmax at i, a tie to the element scanned first; with is_new[i] = x[i]
// > (max of the earlier elements) and R the suffix sum of g in scan
// order,
//
//   dx[i] = is_new[i] ? R[i] - R[next new max after i] : 0
//
// (ops/corner_pool.corner_pool_bwd_plain is the same function in
// PyTorch). Two passes, as the TPU kernel's two VMEM row loops: pass 1
// walks the scan order and writes is_new as 1.0/0.0 into dx, which
// serves as the flag scratch because each element is read back by the
// thread that wrote it; pass 2 walks back carrying R and R at the last
// new max seen. What bounds it: memory, x and g read once and dx written
// once, 3 x 268.4 MB at the training shape (32, 128, 128, 128), 0.240 ms
// at 3.35 TB/s; the flag round trip adds two more passes over dx.
//
//   * H direction: one thread per (b, c, w) column, coalesced row steps
//     as in the forward.
//   * W direction: one warp per row in 32-float chunks. Pass 1 takes the
//     exclusive running max from the forward's __shfl_up_sync scan; pass
//     2 walks the chunks backwards with a reverse add-scan (R) and a
//     reverse "first new max to the right" fill, each carried from chunk
//     to chunk.
//
// R sums g in another order than the plain version's cumsum, so dx
// differs from it by float32 summation rounding; which elements are zero
// (the routing) does not depend on the order.
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

__global__ void pool_bwd_h_kernel(const float* __restrict__ x,
                                  const float* __restrict__ g,
                                  float* __restrict__ dx, long long columns,
                                  int H, int W, int reverse) {
  long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= columns) return;
  long long bc = col / W;
  int w = (int)(col - bc * W);
  long long base = bc * (long long)H * W + w;
  const float* xs = x + base;
  const float* gs = g + base;
  float* out = dx + base;
  // scan order: i = first, first + step, ...
  const int first = reverse ? H - 1 : 0;
  const int step = reverse ? -1 : 1;
  float m = -INFINITY;
  int i = first;
  for (int k = 0; k < H; ++k, i += step) {
    float v = __ldg(xs + (long long)i * W);
    out[(long long)i * W] = v > m ? 1.0f : 0.0f;
    m = run_max(m, v);
  }
  float r = 0.0f, r_new = 0.0f;
  i -= step;
  for (int k = 0; k < H; ++k, i -= step) {
    long long at = (long long)i * W;
    r = __fadd_rn(r, __ldg(gs + at));
    bool is_new = out[at] != 0.0f;
    out[at] = is_new ? __fsub_rn(r, r_new) : 0.0f;
    if (is_new) r_new = r;
  }
}

__global__ void pool_bwd_w_kernel(const float* __restrict__ x,
                                  const float* __restrict__ g,
                                  float* __restrict__ dx, long long rows,
                                  int W, int reverse) {
  const unsigned full = 0xffffffffu;
  int lane = threadIdx.x & 31;
  long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (row >= rows) return;  // whole warps leave together
  const float* xs = x + row * W;
  const float* gs = g + row * W;
  float* out = dx + row * W;
  // pass 1, scan order: the flag is_new = x > exclusive running max
  float carry = -INFINITY;
  for (int start = 0; start < W; start += 32) {
    int k = start + lane;
    int pos = reverse ? W - 1 - k : k;
    bool valid = k < W;
    float v = valid ? __ldg(xs + pos) : -INFINITY;
    float incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      float t = __shfl_up_sync(full, incl, off);
      if (lane >= off) incl = run_max(t, incl);
    }
    float before = __shfl_up_sync(full, incl, 1);
    float excl = lane == 0 ? carry : run_max(carry, before);
    if (valid) out[pos] = v > excl ? 1.0f : 0.0f;
    carry = run_max(carry, __shfl_sync(full, incl, 31));
  }
  // pass 2, chunks from the last in scan order back to the first
  float r_carry = 0.0f;     // R at the first position of the later chunks
  float next_carry = 0.0f;  // R at the first new max in the later chunks
  int last_start = ((W - 1) / 32) * 32;
  for (int start = last_start; start >= 0; start -= 32) {
    int k = start + lane;
    int pos = reverse ? W - 1 - k : k;
    bool valid = k < W;
    float gv = valid ? __ldg(gs + pos) : 0.0f;
    bool is_new = valid && out[pos] != 0.0f;
    // reverse inclusive add-scan: the chunk's suffix sums
    float suffix = gv;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      float t = __shfl_down_sync(full, suffix, off);
      if (lane + off < 32) suffix = __fadd_rn(suffix, t);
    }
    float r = __fadd_rn(r_carry, suffix);
    // reverse fill: R at the first new max at or after each lane
    float fill = r;
    bool has = is_new;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      float tv = __shfl_down_sync(full, fill, off);
      bool th = __shfl_down_sync(full, (int)has, off) != 0;
      if (lane + off < 32 && !has) {
        fill = tv;
        has = th;
      }
    }
    // strictly after: the next lane's fill, or the later chunks'
    float after = __shfl_down_sync(full, fill, 1);
    bool after_has = __shfl_down_sync(full, (int)has, 1) != 0;
    if (lane == 31 || !after_has) after = next_carry;
    if (valid) out[pos] = is_new ? __fsub_rn(r, after) : 0.0f;
    float fill0 = __shfl_sync(full, fill, 0);
    bool has0 = __shfl_sync(full, (int)has, 0) != 0;
    if (has0) next_carry = fill0;
    r_carry = __shfl_sync(full, r, 0);
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

// x, g, dx: (B, C, H, W) contiguous float32 on the device, dx apart from
// both inputs; dim 2 or 3.
int corner_pool_bwd_f32(const float* x, const float* g, float* dx,
                        long long B, long long C, int H, int W, int dim,
                        int reverse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  if (dim == 2) {
    long long columns = B * C * W;
    long long blocks = (columns + threads - 1) / threads;
    pool_bwd_h_kernel<<<(unsigned)blocks, threads, 0, s>>>(x, g, dx, columns,
                                                            H, W, reverse);
  } else if (dim == 3) {
    long long rows = B * C * H;
    long long warps_per_block = threads / 32;
    long long blocks = (rows + warps_per_block - 1) / warps_per_block;
    pool_bwd_w_kernel<<<(unsigned)blocks, threads, 0, s>>>(x, g, dx, rows, W,
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
