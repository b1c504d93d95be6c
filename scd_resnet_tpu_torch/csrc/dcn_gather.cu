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
// both kernels is memory: at a train step's shape, x (32, 16, 16, 512) is
// 16.8 MB and the output or the cotangent (32, 2304, 512) 151 MB, so the
// least time is that tensor's one pass, 0.05 ms at 3.35 TB/s; the corner
// reads hit L2 or shared memory (x is 0.5 MB per image, read by 2304 x 4
// corners).
//
// The forward: one warp per sample; lanes 0..31 derive the same four
// corner indices and weights in registers (no shared memory), then the
// lanes stride over C, so every row read and every output write is 128
// contiguous bytes per warp instruction.
//
// The backward. The previous design kept the forward's mapping and did a
// global atomicAdd into a zeroed float32 dx for every (sample, live
// corner, channel): at the train step's shape up to 151 M float atomics
// into 4.2 M addresses, about 36 per address, after a 16.8 MB memset.
// It took 0.236 ms on an H100 80GB HBM3 at 700 W, 0.79 TB/s of the bytes
// it must move, where the forward, with the same reads and no atomics,
// takes 0.076 ms: the read-modify-writes in L2 bounded it, not DRAM.
// A first redesign kept each block's dx tile in shared memory and added
// into it with atomics: on this card a shared float atomicAdd is a
// compare-and-swap loop, and those swaps, about one lane a clock an SM,
// took 0.33 ms at that shape. This design adds with no atomics at all:
//
//   * a sample's bucket is its top-left corner (floor(py), floor(px));
//     its four corners are that pixel and the three below and to the
//     right. A first kernel (one block per image) sorts the samples
//     inside the outer cutoff by bucket (a counting sort in shared
//     memory);
//   * one block of kBwdThreads takes one (image b, slice of cs <= 32
//     channels, tile of rows x cols map pixels), the plan ops/dcn.bwd_plan
//     picks (at the DCN's 16 x 16 x 512 map: 32 channels, the whole map).
//     Its warps take the tile's buckets, the (rows + 1) x (cols + 1) top-
//     left corners whose corners reach the tile, one at a time: lane l
//     holds channel l; the bucket's four corner pixels' x are loaded once;
//     the bucket's samples come 32 at a time (lane i loads one's index
//     and position), their g rows kAhead at a time (coalesced, each g
//     byte read once in the launch where one tile covers the map). For
//     each sample the warp adds w_c g into four register sums, one per
//     corner, takes the dot products with the corners' x, and sums dpy
//     and dpx over the lanes with five shuffles into a (B, slices x
//     slots, N) float32 scratch: a sample's corners lie in at most 2 x 2
//     tiles, and the slot says which of them the block's is (one slot
//     where one tile covers the map);
//   * the block keeps each bucket's four sums in shared memory (512 bytes
//     a bucket, 148 KB at the DCN's map) and then writes dx: pixel (y, x)
//     is corner 0 of bucket (y, x), 1 of (y, x - 1), 2 of (y - 1, x) and 3
//     of (y - 1, x - 1). The tiles cover dx exactly: no zeroing;
//   * a third small kernel sums each sample's parts (its slices, and the
//     slots of the tiles its bucket reaches) in a fixed order.
// dx adds a bucket's samples in the order the sort left them, which
// varies from run to run; dpy and dpx do not.
//
// Exactness: the forward's lerp weights and four-corner sum are
// evaluated in the plain version's order with round-to-nearest
// intrinsics (__fsub_rn, __fmul_rn, __fadd_rn), so no multiply-add is
// contracted into an FMA: the forward equals its plain version to the
// bit, NaN in x included (an invalid corner reads the clamped pixel and
// multiplies it by 0, as the plain version does). The backward sums in
// another order than the plain version, so it is held to the float32
// summation bound.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;  // forward: samples per block of 256 threads
constexpr int kBwdThreads = 1024;  // backward: 32 warps a block
constexpr int kSlice = 32;  // backward: a slice's channels, one a lane
constexpr int kAhead = 4;   // samples whose g a warp loads before using them
constexpr int kSortChunk = 8 * kBwdThreads;  // buckets counted at a time
constexpr int kSharedBytes = 232448;  // the most a block may use

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

// how one backward launch cuts the work: blocks (b, slice, row tile,
// column tile), a slice of cs <= 32 channels and a tile of rows x cols
// pixels; the tile's buckets are the top-left corners (y0, x0) with
// ty - 1 <= y0 < ty + rows and tx - 1 <= x0 < tx + cols. A sample's
// corners lie in rows y0, y0 + 1 and columns x0, x0 + 1, so in at most
// two row tiles and two column tiles: its scratch holds a slot for each
// (slice, the first or second of those row tiles, column tiles)
struct Plan {
  int cs, rows, cols, slices, row_tiles, col_tiles;
  __host__ __device__ int tiles() const { return row_tiles * col_tiles; }
  __host__ __device__ int col_slots() const { return col_tiles > 1 ? 2 : 1; }
  __host__ __device__ int slots() const {
    return (row_tiles > 1 ? 2 : 1) * col_slots();
  }
  // the row tile of the bucket's first corner row within the map
  __device__ int first_row_tile(int y0) const { return max(y0, 0) / rows; }
  __device__ int first_col_tile(int x0) const { return max(x0, 0) / cols; }
};

// a sample's bucket, (floor(py) + 1) (W + 1) + floor(px) + 1, or -1 when
// it lies beyond the outer cutoff (no live corner)
__device__ __forceinline__ int bucket(float py, float px, int H, int W) {
  if (!(py > -1.0f && py < (float)H && px > -1.0f && px < (float)W))
    return -1;
  return ((int)floorf(py) + 1) * (W + 1) + (int)floorf(px) + 1;
}

// an exclusive scan of counts[0 .. n) in place, n <= kSortChunk;
// returns the total
__device__ int block_scan(int* counts, int n, int* warp_sums) {
  constexpr int kPer = kSortChunk / kBwdThreads;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int first = threadIdx.x * kPer;
  int mine = 0;
  for (int k = first; k < first + kPer && k < n; ++k) mine += counts[k];
  int inclusive = mine;
#pragma unroll
  for (int offset = 1; offset < 32; offset *= 2) {
    const int v = __shfl_up_sync(0xffffffffu, inclusive, offset);
    if (lane >= offset) inclusive += v;
  }
  if (lane == 31) warp_sums[warp] = inclusive;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kBwdThreads / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int offset = 1; offset < 32; offset *= 2) {
      const int v = __shfl_up_sync(0xffffffffu, w, offset);
      if (lane >= offset) w += v;
    }
    warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  int running = inclusive - mine + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int k = first; k < first + kPer && k < n; ++k) {
    const int c = counts[k];
    counts[k] = running;
    running += c;
  }
  const int total = warp_sums[kBwdThreads / 32 - 1];
  __syncthreads();
  return total;
}

// one block per image: the samples inside the outer cutoff sorted by
// bucket into order (N), bucket k's run order[starts[k] .. starts[k+1]);
// buckets are counted kSortChunk at a time in shared memory
__global__ void __launch_bounds__(kBwdThreads)
dcn_bucket_sort_kernel(const float* __restrict__ py,
                       const float* __restrict__ px, int* __restrict__ order,
                       int* __restrict__ starts, int H, int W, long long N,
                       int buckets) {
  __shared__ int counts[kSortChunk];
  __shared__ int warp_sums[32];
  const long long b = blockIdx.x;
  const float* pyb = py + b * N;
  const float* pxb = px + b * N;
  int* ob = order + b * N;
  int* sb = starts + b * (long long)(buckets + 1);
  int base = 0;
  for (int k0 = 0; k0 < buckets; k0 += kSortChunk) {
    const int n = min(kSortChunk, buckets - k0);
    for (int k = threadIdx.x; k < n; k += kBwdThreads) counts[k] = 0;
    __syncthreads();
    for (long long s = threadIdx.x; s < N; s += kBwdThreads) {
      const int k = bucket(pyb[s], pxb[s], H, W) - k0;
      if (k >= 0 && k < n) atomicAdd(&counts[k], 1);
    }
    __syncthreads();
    const int total = block_scan(counts, n, warp_sums);
    for (int k = threadIdx.x; k < n; k += kBwdThreads)
      sb[k0 + k] = base + counts[k];
    __syncthreads();
    for (long long s = threadIdx.x; s < N; s += kBwdThreads) {
      const int k = bucket(pyb[s], pxb[s], H, W) - k0;
      if (k >= 0 && k < n) ob[base + atomicAdd(&counts[k], 1)] = (int)s;
    }
    base += total;
    __syncthreads();
  }
  if (threadIdx.x == 0) sb[buckets] = base;
}

// shared memory: for each corner c and each of the tile's buckets, the
// sum of w_c g over the bucket's samples, 32 channels
__global__ void __launch_bounds__(kBwdThreads, 1)
dcn_gather_bwd_kernel(const float* __restrict__ x,
                      const float* __restrict__ py,
                      const float* __restrict__ px,
                      const float* __restrict__ g,
                      const int* __restrict__ order,
                      const int* __restrict__ starts, float* __restrict__ dx,
                      float* __restrict__ part_y, float* __restrict__ part_x,
                      int H, int W, int C, long long N, Plan plan) {
  extern __shared__ float sums[];  // [corner][tile bucket][channel]
  const int per_image = plan.slices * plan.tiles();
  const long long b = blockIdx.x / per_image;
  const int part = blockIdx.x % per_image;
  const int slice = part / plan.tiles();
  const int c0 = slice * plan.cs;
  const int nch = min(plan.cs, C - c0);
  const int r = part / plan.col_tiles % plan.row_tiles;
  const int q = part % plan.col_tiles;
  const int ty = r * plan.rows, tx = q * plan.cols;
  const int nr = min(plan.rows, H - ty), nc = min(plan.cols, W - tx);
  const int nb = (nr + 1) * (nc + 1);  // the tile's buckets
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const bool active = lane < nch;
  const float* image = x + b * H * W * C + c0 + lane;
  const float* gb = g + b * N * C + c0 + lane;
  const float* pyb = py + b * N;
  const float* pxb = px + b * N;
  const int* ob = order + b * N;
  const int* sb = starts + b * (long long)((H + 1) * (W + 1) + 1);
  const long long slots = (b * plan.slices + slice) * plan.slots();

  for (int j = warp; j < nb; j += kBwdThreads / 32) {
    const int y0 = ty - 1 + j / (nc + 1), x0 = tx - 1 + j % (nc + 1);
    const int k = (y0 + 1) * (W + 1) + x0 + 1;
    const int first = sb[k], end = sb[k + 1];
    // which of the bucket's tiles this block's is
    const long long slot =
        slots + (r - plan.first_row_tile(y0)) * plan.col_slots() + q -
        plan.first_col_tile(x0);
    float* out_y = part_y + slot * N;
    float* out_x = part_x + slot * N;
    // the bucket's corners in the tile, and their x
    bool use[4];
    float xv[4], acc[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int y = y0 + (c >> 1), xx = x0 + (c & 1);
      use[c] = y >= ty && y < ty + nr && xx >= tx && xx < tx + nc;
      xv[c] = use[c] && active ? __ldg(image + ((long long)y * W + xx) * C)
                               : 0.0f;
      acc[c] = 0.0f;
    }
    // 32 samples at a time: lane i holds sample first + i's index and
    // lerp fractions; the warp takes them kAhead at a time, their g rows
    // loaded before they are used
    for (int at = first; at < end; at += 32) {
      const int n = min(32, end - at);
      int s_lane = 0;
      float ly_lane = 0.0f, lx_lane = 0.0f;
      if (lane < n) {
        s_lane = ob[at + lane];
        const float fy = pyb[s_lane], fx = pxb[s_lane];
        ly_lane = sub(fy, (float)y0);  // y0 = floor(fy)
        lx_lane = sub(fx, (float)x0);
      }
      for (int i = 0; i < n; i += kAhead) {
        int s[kAhead];
        float gv[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          s[u] = __shfl_sync(0xffffffffu, s_lane, (i + u) % 32);
          gv[u] = i + u < n && active ? __ldg(gb + (long long)s[u] * C) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const float ly = __shfl_sync(0xffffffffu, ly_lane, (i + u) % 32);
          const float lx = __shfl_sync(0xffffffffu, lx_lane, (i + u) % 32);
          if (i + u >= n) break;
          // the weights and their derivatives as corners() has them
          const float hy = sub(1.0f, ly), hx = sub(1.0f, lx);
          const float w[4] = {mul(hy, hx), mul(hy, lx), mul(ly, hx),
                              mul(ly, lx)};
          const float wy[4] = {-hx, -lx, hx, lx};
          const float wx[4] = {-hy, hy, -ly, ly};
          float sy = 0.0f, sx = 0.0f;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (!use[c]) continue;
            acc[c] += w[c] * gv[u];
            const float d = gv[u] * xv[c];
            sy += wy[c] * d;
            sx += wx[c] * d;
          }
          // lanes 0-15 sum sy, 16-31 sx: one exchange, then four within
          // each half, in a fixed order
          const bool upper = lane & 16;
          float v = (upper ? sx : sy) +
                    __shfl_xor_sync(0xffffffffu, upper ? sy : sx, 16);
#pragma unroll
          for (int offset = 8; offset > 0; offset /= 2)
            v += __shfl_xor_sync(0xffffffffu, v, offset);
          if (lane == 0) out_y[s[u]] = v;
          if (lane == 16) out_x[s[u]] = v;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) sums[(c * nb + j) * 32 + lane] = acc[c];
  }
  __syncthreads();

  // dx at pixel (y, x) of the tile: corner 0 of bucket (y, x), 1 of
  // (y, x - 1), 2 of (y - 1, x), 3 of (y - 1, x - 1), added in that order
  float* dimage = dx + b * H * W * C + c0;
  for (int t = threadIdx.x; t < nr * nc * 32; t += kBwdThreads) {
    const int ch = t % 32, p = t / 32;
    if (ch >= nch) continue;
    const int j = (p / nc + 1) * (nc + 1) + p % nc + 1;
    float v = sums[(0 * nb + j) * 32 + ch];
    v += sums[(1 * nb + j - 1) * 32 + ch];
    v += sums[(2 * nb + j - nc - 1) * 32 + ch];
    v += sums[(3 * nb + j - nc - 2) * 32 + ch];
    dimage[((long long)(ty + p / nc) * W + tx + p % nc) * C + ch] = v;
  }
}

// dpy, dpx (B, N): each sample's parts summed in a fixed order, those of
// the tiles that hold its corners (slice by slice); 0 beyond the cutoff
__global__ void dcn_parts_sum_kernel(const float* __restrict__ py,
                                     const float* __restrict__ px,
                                     const float* __restrict__ part_y,
                                     const float* __restrict__ part_x,
                                     float* __restrict__ dpy,
                                     float* __restrict__ dpx, int H, int W,
                                     long long N, long long samples,
                                     Plan plan) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= samples) return;
  float sy = 0.0f, sx = 0.0f;
  const float fy = py[t], fx = px[t];
  if (bucket(fy, fx, H, W) >= 0) {
    const int y0 = (int)floorf(fy), x0 = (int)floorf(fx);
    // 1 where rows y0 and y0 + 1 within the map lie in two row tiles,
    // else 0; likewise columns
    const int r1 = min(y0 + 1, H - 1) / plan.rows - plan.first_row_tile(y0);
    const int q1 = min(x0 + 1, W - 1) / plan.cols - plan.first_col_tile(x0);
    const long long at = t / N * plan.slices * plan.slots() * N + t % N;
    for (int slice = 0; slice < plan.slices; ++slice)
      for (int r = 0; r <= r1; ++r)
        for (int q = 0; q <= q1; ++q) {
          const long long p =
              slice * plan.slots() + r * plan.col_slots() + q;
          sy += part_y[at + p * N];
          sx += part_x[at + p * N];
        }
  }
  dpy[t] = sy;
  dpx[t] = sx;
}

bool bad_shape(int B, int H, int W, int C, long long N) {
  return B <= 0 || H <= 0 || W <= 0 || C <= 0 || N <= 0;
}

}  // namespace

extern "C" {

// x (B, H, W, C), py and px (B, N), out (B, N, C); all float32,
// contiguous, on the device.
int dcn_gather_f32(const float* x, const float* py, const float* px,
                   float* out, int B, int H, int W, int C, long long N,
                   void* stream) {
  if (bad_shape(B, H, W, C, N)) return (int)cudaErrorInvalidValue;
  const long long blocks = ((long long)B * N + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  dcn_gather_kernel<<<(unsigned)blocks, kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      x, py, px, out, H, W, C, N, (long long)B * N);
  return (int)cudaGetLastError();
}

// the backward of dcn_gather_f32 for the cotangent g (B, N, C): dx
// (B, H, W, C), dpy and dpx (B, N) are written, nothing needs zeroing.
// The plan (ops/dcn.bwd_plan): cs channels (1..32) and rows x cols
// pixels a block, whose (rows + 1) (cols + 1) buckets take 512 bytes each
// of the 232448 a block may use. Scratch: index (B (N + (H + 1) (W + 1) +
// 1) int32: the sorted samples, then the buckets' starts) and parts (2 B
// P N float32: part_y then part_x, P = ceil(C / cs) x slots, slots 1, 2
// or 4: 2 for each of H and W that the plan cuts into tiles).
int dcn_gather_bwd_f32(const float* x, const float* py, const float* px,
                       const float* g, float* dx, float* dpy, float* dpx,
                       int* index, float* parts, int B, int H, int W, int C,
                       long long N, int cs, int rows, int cols,
                       void* stream) {
  if (bad_shape(B, H, W, C, N) || N > 2147483647LL || cs <= 0 ||
      cs > kSlice || rows <= 0 || cols <= 0)
    return (int)cudaErrorInvalidValue;
  const long long buckets = (long long)(H + 1) * (W + 1);
  const long long bytes = 4LL * 4 * kSlice * (rows + 1) * (cols + 1);
  if (bytes > kSharedBytes || buckets >= 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const Plan plan = {cs, rows, cols, (C + cs - 1) / cs, (H + rows - 1) / rows,
                     (W + cols - 1) / cols};
  const long long blocks = (long long)B * plan.slices * plan.tiles();
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* order = index;
  int* starts = index + (long long)B * N;
  dcn_bucket_sort_kernel<<<B, kBwdThreads, 0, s>>>(py, px, order, starts, H,
                                                   W, N, (int)buckets);
  cudaError_t status = cudaGetLastError();
  if (status != cudaSuccess) return (int)status;
  status = cudaFuncSetAttribute(dcn_gather_bwd_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
  if (status != cudaSuccess) return (int)status;
  float* part_y = parts;
  float* part_x = parts + (long long)B * plan.slices * plan.slots() * N;
  dcn_gather_bwd_kernel<<<(unsigned)blocks, kBwdThreads, bytes, s>>>(
      x, py, px, g, order, starts, dx, part_y, part_x, H, W, C, N, plan);
  status = cudaGetLastError();
  if (status != cudaSuccess) return (int)status;
  const long long samples = (long long)B * N;
  dcn_parts_sum_kernel<<<(unsigned)((samples + 255) / 256), 256, 0, s>>>(
      py, px, part_y, part_x, dpy, dpx, H, W, N, samples, plan);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
