// Gaussian heatmap labels: every label map a batch transform needs, in
// one launch. Each map is the sum of K truncated-center Gaussians per
// clip, clamped to 1.
//
// Replaces the TPU kernel render_heatmap_pallas
// (scd_resnet_tpu/ops/pallas_kernels.py:77, body _render_kernel l.41),
// which accumulates the K objects of one clip into a VMEM tile. Inputs:
// locs (B, K, 8) float32 records [ctX, ctY, offX, offY, majX, majY, minL,
// halo] in heatmap coordinates and valid (B, K) bytes (a bool tensor's
// storage); output (M, B, S, S) float32, map m of clip b at
// heat[m][b]. Per object and map (ops/gaussian.render_heatmap_plain is
// the same function in PyTorch):
//
//   cx, cy = trunc(ctX + offX'), trunc(ctY + offY'); ok = valid &&
//   0 <= cx, cy < S
//   r = radius(2 |maj|, 2 minL, iou), or 1 where !ok or r <= 0;
//   roi = ceil(2r); sigma = r / 3
//   heat += exp(-(dx^2 + dy^2) / (2 sigma^2)) where |dx|, |dy| <= roi
//
// and heat = min(heat, 1), so every center is exactly 1.0. The map sets:
//
//   M = 1, no offsets: the center map (center_threshold_radius, no
//     offset);
//   M = 3, no offsets: the center map, then the corner families' tl and
//     br maps (corner_threshold_radius, the corner at the center -/+
//     (|maj|, minL), which the kernel derives itself: a sqrt_rn, then an
//     add, as the plain version's corner_offsets does; a corner in
//     (-1, 0) truncates to 0 and is stamped there);
//   M = 1 with a (B, K, 2) float32 offset (offX', offY'): one corner map
//     with the caller's offsets.
//
// What bounds it: not memory. At the training shape (32, 30, 8) -> 128^2
// a map is 2.1 MB (0.63 us at 3.35 TB/s), about the floor of one launch.
// Each (pixel, object) term inside a box costs an IEEE division and an
// expf, and a warp issues them whenever one of its lanes' pixels is
// inside the box; in front of the pixels stand the records' loads, the
// derivation's chain of IEEE square roots and divisions and a cluster
// barrier. An experiment with parts of the kernel
// cut out (not kept) put most of a launch's time in the pixel loop, then
// in the derivation and the barrier. The design:
//
//   * a cluster of 8 blocks per (map, clip), grid (8, M, B): 256 blocks
//     for M = 1 at B = 32, about two an SM. Block r of a cluster derives
//     objects r, r + 8, ... (one thread each: center, radius, box,
//     2 sigma^2, in round-to-nearest float32), so each (clip, map,
//     object) is derived once, not once per block of pixels; after a
//     cluster barrier every block copies the K records from the blocks
//     that derived them (distributed shared memory);
//   * block r owns rows [r ceil(S/8), (r + 1) ceil(S/8)) of its map. One
//     warp lists, with ballots, the objects whose box reaches those rows,
//     still in k = 0..K-1 order (the sum's order decides its bits);
//   * a warp takes a tile of 8 rows x 16 pixels at a time and skips the
//     listed objects whose box misses it; a lane takes 4 neighbouring
//     pixels of one row: each object's row test and dy^2 once for the
//     four, then the per-pixel box test, and one 16-byte store (scalar
//     stores when S is not a multiple of 4). At the training shape a box
//     is a small part of a 128-pixel row: a warp on one row kept few of
//     its lanes busy in each term, a tile keeps more of them;
//   * the block signals the cluster barrier when it has copied the
//     records and waits on it only before it exits, so no block leaves
//     while another still reads its shared memory, and nobody waits for
//     that in front of the pixels.
//
// Exactness: the float32 operations run in the JAX function's order with
// round-to-nearest intrinsics (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn, __fsqrt_rn), so no multiply-add is contracted into an FMA
// and sqrt and division are IEEE; expf is CUDA's (2 ulp). Pixels outside
// an object's box skip it, as the plain version adds +0.0 there. The
// constants derived from the IoU threshold are computed in double and
// rounded to float, as Python computes them before JAX and PyTorch see
// them.
//
// Plain C interface for ctypes: the entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;    // blocks per (map, clip), each a band of rows
constexpr int kThreads = 256;  // per block
// each block of a cluster derives at most kThreads objects, one a thread
constexpr int kMaxObjects = kCluster * kThreads;

// which radius and offset an object takes on a map
enum Kind { kCenter = 0, kTopLeft = 1, kBottomRight = 2, kOffset = 3 };

struct Consts {
  float one_minus_t;   // 1 - t
  float one_plus_t;    // 1 + t
  float minus_two_t;   // -2 t
  float t_minus_one;   // t - 1
  float sixteen_t;     // 4 a3, a3 = 4 t
  float corner_c;      // 16 (1 - t)
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// torch.minimum's and jnp.minimum's: NaN if either is (fminf drops it;
// a root of a negative discriminant is NaN)
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}

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
  return min_nan(min_nan(r1, r2), r3);
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

// One object on one map: (cx, cy, roi, 2 sigma^2), roi = -1 where it is
// not stamped (invalid, or its center off the map). ``off`` is read only
// for kOffset.
__device__ float4 derive(const float* r, bool valid, Kind kind,
                         const float* off, int S, const Consts& c) {
  float maj = __fsqrt_rn(add(mul(r[4], r[4]), mul(r[5], r[5])));
  float px = r[0], py = r[1];
  if (kind == kTopLeft) {
    px = add(px, -maj);
    py = add(py, -r[6]);
  } else if (kind == kBottomRight) {
    px = add(px, maj);
    py = add(py, r[6]);
  } else if (kind == kOffset) {
    px = add(px, off[0]);
    py = add(py, off[1]);
  }
  float cx = truncf(px);
  float cy = truncf(py);
  bool ok = valid && cx >= 0.0f && cx < (float)S && cy >= 0.0f &&
            cy < (float)S;
  float w = mul(2.0f, maj), h = mul(2.0f, r[6]);
  float radius = kind == kCenter ? center_radius(w, h, c)
                                 : corner_radius(w, h, c);
  radius = (ok && radius > 0.0f) ? radius : 1.0f;
  float sigma = dvd(radius, 3.0f);
  return make_float4(cx, cy, ok ? ceilf(mul(radius, 2.0f)) : -1.0f,
                     mul(mul(2.0f, sigma), sigma));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// grid (kCluster, M, B); offsets null except for the kOffset map set.
// Dynamic shared memory: ceil(K / kCluster) derived records, K copied
// records (float4 each), then K uint16 list entries.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
render_heatmaps_kernel(const float* __restrict__ locs,
                       const unsigned char* __restrict__ valid,
                       const float* __restrict__ offsets,
                       float* __restrict__ heat, int B, int K, int S,
                       Consts c) {
  extern __shared__ float4 smem[];
  __shared__ int listed;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int map = blockIdx.y, b = blockIdx.z;
  const Kind kind = offsets != nullptr ? kOffset : static_cast<Kind>(map);
  const int per_block = (K + kCluster - 1) / kCluster;
  float4* own = smem;
  float4* all = smem + per_block;
  unsigned short* list = reinterpret_cast<unsigned short*>(all + K);

  // 1. this block's share of the clip's objects on this map
  const long long rec0 = (long long)b * K;
  const int k_own = rank + kCluster * (int)threadIdx.x;
  if (k_own < K)
    own[threadIdx.x] = derive(
        locs + (rec0 + k_own) * 8, valid[rec0 + k_own] != 0, kind,
        kind == kOffset ? offsets + (rec0 + k_own) * 2 : nullptr, S, c);
  cluster.sync();

  // 2. every record, from the block that derived it
  for (int k = threadIdx.x; k < K; k += kThreads)
    all[k] = cluster.map_shared_rank(own, k % kCluster)[k / kCluster];
  cluster_arrive();  // no read of another block's memory after this
  __syncthreads();

  // 3. the objects whose box reaches this block's rows, in k order
  const int rows = (S + kCluster - 1) / kCluster;
  const int r0 = rank * rows;
  const int r1 = min(S, r0 + rows);  // exclusive; r1 <= r0: no rows
  if (threadIdx.x < 32) {
    const unsigned lane = threadIdx.x;
    const float top = (float)r0, bottom = (float)(r1 - 1);
    int n = 0;
    for (int base = 0; base < K; base += 32) {
      const int k = base + (int)lane;
      bool keep = false;
      if (k < K && r0 < r1) {
        const float4 o = all[k];
        // the distance from cy to the band; exact for integers < 2^24
        const float d = fmaxf(fmaxf(sub(top, o.y), sub(o.y, bottom)), 0.0f);
        keep = o.z >= 0.0f && !(d > o.z);
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      if (keep)
        list[n + __popc(ballot & ((1u << lane) - 1u))] = (unsigned short)k;
      n += __popc(ballot);
    }
    if (lane == 0) listed = n;
  }
  __syncthreads();

  // 4. the band in tiles of 8 rows x 16 pixels, a tile a warp: a lane
  // takes 4 neighbouring pixels of one row, so a box covers many of a
  // warp's lanes; the warp skips the objects whose box misses its tile
  const int n = listed;
  const int groups = (S + 3) / 4;        // 4-pixel groups in a row
  const int tiles_x = (groups + 3) / 4;  // 4 groups a tile row
  const int tiles = (max(r1 - r0, 0) + 7) / 8 * tiles_x;
  const int lane = threadIdx.x % 32;
  const bool vector_stores = (S & 3) == 0;
  float* out = heat + ((long long)map * B + b) * S * S;
  for (int t = threadIdx.x / 32; t < tiles; t += kThreads / 32) {
    const int ty0 = r0 + 8 * (t / tiles_x);
    const int g0 = 4 * (t % tiles_x);
    const float top = (float)ty0, bottom = (float)(min(ty0 + 8, r1) - 1);
    const float left = (float)(4 * g0);
    const float right = (float)(min(4 * g0 + 16, S) - 1);
    const int y = ty0 + lane / 4;
    const int x0 = 4 * (g0 + lane % 4);
    const float fy = (float)y;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int i = 0; i < n; ++i) {
      const float4 o = all[list[i]];
      // the box's distance from the tile, the same for the whole warp
      const float ty = fmaxf(fmaxf(sub(top, o.y), sub(o.y, bottom)), 0.0f);
      const float tx = fmaxf(fmaxf(sub(left, o.x), sub(o.x, right)), 0.0f);
      if (ty > o.z || tx > o.z) continue;
      const float dy = sub(fy, o.y);
      if (fabsf(dy) > o.z) continue;
      const float dy2 = mul(dy, dy);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float dx = sub((float)(x0 + j), o.x);
        if (fabsf(dx) > o.z) continue;
        acc[j] = add(acc[j], expf(dvd(-add(mul(dx, dx), dy2), o.w)));
      }
    }
    if (y >= r1 || x0 >= S) continue;  // beyond a ragged band or row
    float* row = out + (long long)y * S;
    if (vector_stores) {
      *reinterpret_cast<float4*>(row + x0) =
          make_float4(fminf(acc[0], 1.0f), fminf(acc[1], 1.0f),
                      fminf(acc[2], 1.0f), fminf(acc[3], 1.0f));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (x0 + j < S) row[x0 + j] = fminf(acc[j], 1.0f);
    }
  }
  cluster_wait();  // the other blocks have copied this block's records
}

}  // namespace

extern "C" {

// locs (B, K, 8) float32, valid (B, K) bytes (0 or not), heat (M, B, S, S)
// float32, all contiguous on the device; threshold is the IoU of the
// radius solver. offsets null: M = 1 renders the center map, M = 3 the
// center, tl and br maps; offsets (B, K, 2) float32: M = 1 renders one
// corner map at those offsets. Anything else is cudaErrorInvalidValue.
int render_heatmaps_f32(const float* locs, const unsigned char* valid,
                        const float* offsets, float* heat, int B, int K,
                        int S, int M, double threshold, void* stream) {
  const bool map_set = offsets == nullptr ? (M == 1 || M == 3) : M == 1;
  if (!map_set || B <= 0 || B > 65535 || S <= 0 || S > 46340 || K < 0 ||
      K > kMaxObjects)
    return (int)cudaErrorInvalidValue;
  Consts c;
  c.one_minus_t = (float)(1.0 - threshold);
  c.one_plus_t = (float)(1.0 + threshold);
  c.minus_two_t = (float)(-2.0 * threshold);
  c.t_minus_one = (float)(threshold - 1.0);
  c.sixteen_t = (float)(4.0 * (4.0 * threshold));
  c.corner_c = (float)(16.0 * (1.0 - threshold));
  const int per_block = (K + kCluster - 1) / kCluster;
  size_t smem = (size_t)(per_block + K) * sizeof(float4) +
                (size_t)K * sizeof(unsigned short);
  dim3 grid(kCluster, (unsigned)M, (unsigned)B);
  render_heatmaps_kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      locs, valid, offsets, heat, B, K, S, c);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
