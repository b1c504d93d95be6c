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
// What bounds it: memory. x and dy are read once and dx written once: at
// the training shape (32, 64, 256, 256) bf16, 268.4 + 67.1 + 268.4 MB,
// 0.180 ms at 3.35 TB/s.
//
// What bounded the previous design (one thread per 2 x 2 block of input
// pixels, its 5 x 5 patch loaded as 25 predicated scalar loads, the four
// windows' maxima found in registers, four scalar stores): instruction
// issue, not memory. It moved those 604 MB in 1.706 ms on an H100 80GB
// HBM3 at 700 W, 0.35 TB/s, a tenth of the card's rate: each 2-byte load
// carried its own bounds test and address arithmetic, every window's
// nine taps were compared by each of the four threads whose block it
// touches, and the stores were 2-byte stores at a 4-byte stride.
//
// This design: one block of 256 threads takes one (b, c) plane's band of
// kBandRows output rows and a tile of kTileCols output columns (the whole
// row up to W = 256), and owns the input pixels of rows 2 oy0 .. 2 oy0 +
// 2 kBandRows - 1 and the matching columns; the windows it needs are
// oy0 .. oy0 + kBandRows (the last one shared with the next band, so
// computed twice) and likewise in columns.
//   0. It issues all its global loads before it uses any: the
//      2 kBandRows + 3 input rows those windows read, with 16-byte loads
//      (the halo columns one by one), and the windows' dy; the rows go
//      to shared memory, padding as -inf.
//   1. One thread per window reads its nine taps as pairs of columns,
//      finds the first maximum in one pass (a tap replaces the running
//      one only when greater or NaN) and keeps its tap (int8, -1 for
//      none) and its dy in shared memory.
//   2. One thread per 16 bytes of an input row (8 bf16 or 4 float32
//      pixels) reads the claims of the windows those pixels lie in, adds
//      each pixel's claims in ascending (oy, ox) order and writes its
//      pixels with one 16-byte store.
// Rows whose width is not a multiple of 16 bytes, or tensors not
// 16-byte aligned, take the same three phases with scalar loads and
// stores (a template flag); B C H W >= 1 of any size.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBandRows = 8;    // output rows per block
constexpr int kTileCols = 128;  // output columns per block
constexpr int kThreads = 256;
constexpr int kStagedRows = 2 * kBandRows + 3;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float2 to_float2(float2 v) { return v; }
__device__ __forceinline__ float2 to_float2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 16 bytes of -inf, and 16 bytes of pixels from their float32 values
template <typename T>
__device__ __forceinline__ uint4 neg_inf16();
template <>
__device__ __forceinline__ uint4 neg_inf16<float>() {
  return make_uint4(0xff800000u, 0xff800000u, 0xff800000u, 0xff800000u);
}
template <>
__device__ __forceinline__ uint4 neg_inf16<__nv_bfloat16>() {
  return make_uint4(0xff80ff80u, 0xff80ff80u, 0xff80ff80u, 0xff80ff80u);
}
__device__ __forceinline__ uint4 pack16(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // lo at the lower address
  return *reinterpret_cast<unsigned*>(&h);
}
__device__ __forceinline__ uint4 pack16(const float (&v)[8]) {
  return make_uint4(bf16x2(v[0], v[1]), bf16x2(v[2], v[3]),
                    bf16x2(v[4], v[5]), bf16x2(v[6], v[7]));
}

template <typename T>
struct Layout {
  using Pair = typename std::conditional<sizeof(T) == 4, float2,
                                         __nv_bfloat162>::type;
  static constexpr int kVec = 16 / sizeof(T);  // pixels per 16 bytes
  // a staged row: kVec - 1 unused, the left halo column, the tile's
  // 2 kTileCols columns from a 16-byte boundary, two right halo columns
  static constexpr int kPitch = 2 * kTileCols + 2 * kVec;
  // the window columns of phase 2's thread start at 16-byte group q / 2;
  // window column wc is stored at (wc % kSpan) * kWinPitch + wc / kSpan,
  // so that the 32 threads of a warp read 32 consecutive words
  static constexpr int kSpan = kVec / 2;
  static constexpr int kWinPitch = kTileCols / kSpan + 32 / kSpan;
  static constexpr int kWinRow = kSpan * kWinPitch;
  static __device__ __forceinline__ int slot(int wc) {
    return (wc % kSpan) * kWinPitch + wc / kSpan;
  }
};

// grid: one block per (plane, band, tile), tile fastest, in a grid-stride
// loop; in-plane indices are 32-bit. At most 64 registers a thread, so
// that four blocks share an SM (the compiler's own choice, 66 in bf16,
// leaves room for three, and was slower at the training shape)
template <typename T, bool kVectorised>
__global__ void __launch_bounds__(kThreads, 4)
max_pool_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                    T* __restrict__ dx, long long blocks, int H, int W,
                    int Ho, int Wo, int bands, int tiles) {
  using L = Layout<T>;
  constexpr int V = L::kVec;
  constexpr int kGroups = 2 * kTileCols / V;  // 16-byte groups a row
  __shared__ __align__(16) T xs[kStagedRows][L::kPitch];
  __shared__ signed char claim[kBandRows + 1][L::kWinRow];
  __shared__ float grad[kBandRows + 1][L::kWinRow];

  for (long long blk = blockIdx.x; blk < blocks; blk += gridDim.x) {
    const long long plane_index = blk / ((long long)bands * tiles);
    const int rest = (int)(blk % ((long long)bands * tiles));
    const int oy0 = rest / tiles * kBandRows;
    const int ox0 = rest % tiles * kTileCols;
    const T* plane = x + plane_index * H * W;
    const T* dplane = dy + plane_index * Ho * Wo;
    T* out = dx + plane_index * H * W;
    const int i0 = 2 * oy0 - 1;  // the input row of staged row 0
    const int j0 = 2 * ox0;      // the input column of staged column V

    // 0. every global load of the block issued before any is used: the
    // staged rows (-inf outside the plane) and the windows' dy
    constexpr int kRowLoads = (kStagedRows * kGroups + kThreads - 1) / kThreads;
    constexpr int kWindows = (kBandRows + 1) * (kTileCols + 1);
    constexpr int kWinLoads = (kWindows + kThreads - 1) / kThreads;
    uint4 row16[kVectorised ? kRowLoads : 1];
    if (kVectorised) {
#pragma unroll
      for (int k = 0; k < kRowLoads; ++k) {
        const int t = threadIdx.x + k * kThreads;
        const int r = t / kGroups, q = t % kGroups * V;
        const int i = i0 + r, j = j0 + q;
        row16[k] = (t < kStagedRows * kGroups && i >= 0 && i < H && j < W)
                       ? __ldg(reinterpret_cast<const uint4*>(plane + i * W + j))
                       : neg_inf16<T>();
      }
    }
    float dy_win[kWinLoads];
#pragma unroll
    for (int k = 0; k < kWinLoads; ++k) {
      const int t = threadIdx.x + k * kThreads;
      const int oy = oy0 + t / (kTileCols + 1), ox = ox0 + t % (kTileCols + 1);
      dy_win[k] = (t < kWindows && oy < Ho && ox < Wo)
                 ? to_float(dplane[oy * Wo + ox])
                 : 0.0f;
    }
    if (threadIdx.x < kStagedRows * 3) {  // the halo columns
      const int r = threadIdx.x / 3, h = threadIdx.x % 3;
      const int c = h == 0 ? V - 1 : V + 2 * kTileCols + h - 1;
      const int i = i0 + r, j = j0 + c - V;
      xs[r][c] = (i >= 0 && i < H && j >= 0 && j < W)
                     ? plane[i * W + j]
                     : from_float<T>(-INFINITY);
    }
    if (kVectorised) {
#pragma unroll
      for (int k = 0; k < kRowLoads; ++k) {
        const int t = threadIdx.x + k * kThreads;
        if (t < kStagedRows * kGroups)
          *reinterpret_cast<uint4*>(&xs[t / kGroups][V + t % kGroups * V]) =
              row16[k];
      }
    } else {
      for (int t = threadIdx.x; t < kStagedRows * kGroups; t += kThreads) {
        const int r = t / kGroups, q = t % kGroups * V;
        const int i = i0 + r, j = j0 + q;
#pragma unroll
        for (int e = 0; e < V; ++e)
          xs[r][V + q + e] = (i >= 0 && i < H && j + e < W)
                                 ? plane[i * W + j + e]
                                 : from_float<T>(-INFINITY);
      }
    }
    __syncthreads();

    // 1. each window's first maximum in one pass: a tap replaces the
    // running one only when greater (so ties keep the first) or NaN, and
    // a NaN maximum stays; the claim is that tap 0..8, or -1 when it is
    // padding, the maximum is NaN or the window lies beyond the plane
#pragma unroll
    for (int k = 0; k < kWinLoads; ++k) {
      const int t = threadIdx.x + k * kThreads;
      if (t >= kWindows) break;
      const int wr = t / (kTileCols + 1), wc = t % (kTileCols + 1);
      const int oy = oy0 + wr, ox = ox0 + wc;
      int win = -1;
      if (oy < Ho && ox < Wo) {
        // a row's three taps from two aligned pairs of columns
        using P = typename Layout<T>::Pair;
        float v[9];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const P* pair =
              reinterpret_cast<const P*>(&xs[2 * wr + a][V - 2 + 2 * wc]);
          const float2 lo = to_float2(pair[0]), hi = to_float2(pair[1]);
          v[3 * a] = lo.y;
          v[3 * a + 1] = hi.x;
          v[3 * a + 2] = hi.y;
        }
        float m = v[0];
        win = 0;
#pragma unroll
        for (int a = 1; a < 9; ++a) {
          if (v[a] > m || (v[a] != v[a] && m == m)) {
            m = v[a];
            win = a;
          }
        }
        const int i = 2 * oy - 1 + win / 3, j = 2 * ox - 1 + win % 3;
        if (m != m || i < 0 || i >= H || j < 0 || j >= W) win = -1;
      }
      claim[wr][L::slot(wc)] = (signed char)win;
      grad[wr][L::slot(wc)] = win >= 0 ? dy_win[k] : 0.0f;
    }
    __syncthreads();

    // 2. V pixels of one input row per thread. Row r lies in window row
    // r / 2 (tap row 1) when even, in r / 2 (tap row 2) and r / 2 + 1
    // (tap row 0) when odd; likewise the columns, pixel d of the group in
    // window column q / 2 + d / 2 (tap column 1, d even) or q / 2 + d / 2
    // and q / 2 + d / 2 + 1 (tap columns 2 and 0, d odd).
    for (int t = threadIdx.x; t < 2 * kBandRows * kGroups; t += kThreads) {
      const int r = t / kGroups, q = t % kGroups * V;
      const int i = 2 * oy0 + r, j = j0 + q;
      if (i >= H || j >= W) continue;
      const bool odd = r & 1;
      int tap_row[2] = {odd ? 2 : 1, 0};
      int win[2][V / 2 + 1];
      float g[2][V / 2 + 1];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int wr = r / 2 + k;
#pragma unroll
        for (int e = 0; e <= V / 2; ++e) {
          const bool use = k == 0 || odd;
          win[k][e] = use ? claim[wr][L::slot(q / 2 + e)] : -1;
          g[k][e] = use ? grad[wr][L::slot(q / 2 + e)] : 0.0f;
        }
      }
      float acc[V];
#pragma unroll
      for (int d = 0; d < V; ++d) {
        float a = 0.0f;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int tr = 3 * tap_row[k];
          if (d % 2 == 0) {
            if (win[k][d / 2] == tr + 1) a = __fadd_rn(a, g[k][d / 2]);
          } else {
            if (win[k][d / 2] == tr + 2) a = __fadd_rn(a, g[k][d / 2]);
            if (win[k][d / 2 + 1] == tr) a = __fadd_rn(a, g[k][d / 2 + 1]);
          }
        }
        acc[d] = a;
      }
      T* dst = out + i * W + j;
      if (kVectorised) {
        *reinterpret_cast<uint4*>(dst) = pack16(acc);
      } else {
#pragma unroll
        for (int d = 0; d < V; ++d)
          if (j + d < W) dst[d] = from_float<T>(acc[d]);
      }
    }
    __syncthreads();  // the next block's staging overwrites shared memory
  }
}

template <typename T>
int launch(const T* x, const T* dy, T* dx, long long B, long long C, int H,
           int W, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  if ((long long)H * W > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const int bands = (Ho + kBandRows - 1) / kBandRows;
  const int tiles = (Wo + kTileCols - 1) / kTileCols;
  const long long blocks = B * C * bands * tiles;
  const unsigned grid =
      (unsigned)(blocks < 0x7fffffffLL ? blocks : 0x7fffffffLL);
  const bool aligned = W % Layout<T>::kVec == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (aligned)
    max_pool_bwd_kernel<T, true><<<grid, kThreads, 0, s>>>(
        x, dy, dx, blocks, H, W, Ho, Wo, bands, tiles);
  else
    max_pool_bwd_kernel<T, false><<<grid, kThreads, 0, s>>>(
        x, dy, dx, blocks, H, W, Ho, Wo, bands, tiles);
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

// the output rows and columns one block covers: input shapes of more
// than 2 x these cross a band or a column tile
int max_pool_3x3_s2_bwd_band_rows(void) { return kBandRows; }
int max_pool_3x3_s2_bwd_tile_cols(void) { return kTileCols; }

const char* cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
