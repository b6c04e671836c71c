// K4: bilinear backwarp for large flow, with the TPU kernel's per-tile base
// displacement and residual envelope.
//
// Replaces v2e_tpu/ops/pallas/warp_v2.py::bilinear_warp_tiled (_kernel and
// its XLA prepass).  The plain PyTorch version is
// v2e_tpu_torch/ops/kernels/warp_tiled.py::warp_tiled_plain.
//
// What it computes, per output tile of 8x128 pixels (rows x columns):
//   base  bu = clamp(128 * rint(mean(u) / 128), +-max_base),
//         bv = clamp(  8 * rint(mean(v) /   8), +-max_base),
//         the means taken over the tile of the flow edge-replicated to a
//         whole number of tiles; rint rounds half to even, as jnp.round;
//   sample for the pixel at (i, j) inside the tile
//         ly = clamp(i + (v - bv) - 0.5, -12, 19) + 13
//         lx = clamp(j + (u - bu) - 0.5, -72, 199) + 73
//         bilinear between image rows r0 + bv - 13 + floor(ly) (+1) and
//         columns c0 + bu - 73 + floor(lx) (+1), zero outside the image.
// Inside the envelope (|u - bu| and |v - bv| small enough that the clamps
// do not act) that is the plain backwarp at (x + u - 0.5, y + v - 0.5).
//
// Design.  The TPU kernel DMAed a 40x384 region around the displaced tile
// into VMEM and turned the gather into one-hot matrix products; the
// quantized base only kept its dynamic slice starts tile-aligned.  Hopper
// gathers directly, so one block per output tile
//   1. sums the tile's (edge-replicated) flow in float64, reduced over the
//      block with warp shuffles: the mean is then the same whatever the
//      order, in the kernel and in the plain version, and the rounding
//      decision of the base is taken on the same float32 value;
//   2. samples each of its 1024 pixels (4 per thread) from device memory:
//      the four taps of neighbouring pixels are neighbouring addresses and
//      hit L1.  Staging the 40x384 region in shared memory would read 15x
//      the tile's bytes to use about 4x; the cache does that for free.
// The weights are applied in the TPU kernel's order: the two column taps
// of each row first (its matrix product), then the two rows.
//
// Bound on the card: it reads the image and both flow planes and writes the
// output, 16 bytes per pixel (the flow is read a second time from L1/L2);
// some 40 operations per pixel.  So it is bound by memory bytes.
//
// Rounding: built with --fmad=false and without fast math; the plain
// version does the same float32 operations in the same order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBH = 8;
constexpr int kBW = 128;
constexpr int kThreads = 256;
constexpr float kMRow = 12.0f;
constexpr float kMCol = 72.0f;

__device__ __forceinline__ float pix(const float* __restrict__ img, int y,
                                     int x, int H, int W) {
  return (y >= 0 && y < H && x >= 0 && x < W) ? img[(size_t)y * W + x] : 0.0f;
}

__device__ __forceinline__ double block_sum(double x, double* scratch) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0) {
    for (int k = 0; k < kThreads / 32; ++k) total += scratch[k];
  }
  return total;
}

__device__ __forceinline__ int tile_base(double sum, float quantum,
                                         float max_base) {
  float mean = (float)(sum / (double)(kBH * kBW));
  float b = quantum * rintf(mean / quantum);
  return (int)fminf(fmaxf(b, -max_base), max_base);
}

__global__ void __launch_bounds__(kThreads)
warp_tiled_kernel(const float* __restrict__ img, const float* __restrict__ u,
                  const float* __restrict__ v, float* __restrict__ out,
                  int H, int W, long long uv_nstride, int nty, int ntx,
                  float max_base) {
  int tj = blockIdx.x % ntx;
  int ti = (blockIdx.x / ntx) % nty;
  long long n = blockIdx.x / ((long long)ntx * nty);
  int r0 = ti * kBH;
  int c0 = tj * kBW;
  const float* un = u + n * uv_nstride;
  const float* vn = v + n * uv_nstride;
  const float* src = img + n * (long long)H * W;
  float* dst = out + n * (long long)H * W;

  __shared__ double scratch_u[kThreads / 32];
  __shared__ double scratch_v[kThreads / 32];
  __shared__ int base_uv[2];
  double su = 0.0, sv = 0.0;
  for (int k = threadIdx.x; k < kBH * kBW; k += kThreads) {
    int r = min(r0 + k / kBW, H - 1);
    int c = min(c0 + k % kBW, W - 1);
    size_t p = (size_t)r * W + c;
    su += (double)un[p];
    sv += (double)vn[p];
  }
  su = block_sum(su, scratch_u);
  sv = block_sum(sv, scratch_v);
  if (threadIdx.x == 0) {
    base_uv[0] = tile_base(su, 128.0f, max_base);
    base_uv[1] = tile_base(sv, 8.0f, max_base);
  }
  __syncthreads();
  int bu = base_uv[0];
  int bv = base_uv[1];
  float buf = (float)bu;
  float bvf = (float)bv;

  for (int k = threadIdx.x; k < kBH * kBW; k += kThreads) {
    int i = k / kBW;
    int j = k % kBW;
    int r = r0 + i;
    int c = c0 + j;
    if (r >= H || c >= W) continue;
    size_t p = (size_t)r * W + c;
    float ly = fminf(fmaxf(((float)i + (vn[p] - bvf)) - 0.5f, -kMRow),
                     (float)(kBH - 1) + kMRow) + (kMRow + 1.0f);
    float lx = fminf(fmaxf(((float)j + (un[p] - buf)) - 0.5f, -kMCol),
                     (float)(kBW - 1) + kMCol) + (kMCol + 1.0f);
    float y0 = floorf(ly);
    float x0 = floorf(lx);
    float wy = ly - y0;
    float wx = lx - x0;
    int ry = r0 + bv - 13 + (int)y0;
    int cx = c0 + bu - 73 + (int)x0;
    float t0 = pix(src, ry, cx, H, W) * (1.0f - wx) + pix(src, ry, cx + 1, H, W) * wx;
    float t1 = pix(src, ry + 1, cx, H, W) * (1.0f - wx) +
               pix(src, ry + 1, cx + 1, H, W) * wx;
    dst[p] = (1.0f - wy) * t0 + wy * t1;
  }
}

}  // namespace

// img, out: [N,H,W] contiguous f32.  u, v: the flow planes of image n start
// at u + n*uv_nstride (v likewise), each [H,W] contiguous.  max_base: the
// clamp of the tile base, a multiple of 128.  One launch of N*ceil(H/8)*
// ceil(W/128) blocks on `stream`, no sync.  Returns cudaGetLastError().
extern "C" int v2e_warp_tiled(const float* img, const float* u, const float* v,
                              float* out, int N, int H, int W,
                              long long uv_nstride, int max_base,
                              void* stream) {
  if ((long long)N * H * W == 0) return 0;
  int nty = (H + kBH - 1) / kBH;
  int ntx = (W + kBW - 1) / kBW;
  long long blocks = (long long)N * nty * ntx;
  warp_tiled_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      img, u, v, out, H, W, uv_nstride, nty, ntx, (float)max_base);
  return (int)cudaGetLastError();
}
