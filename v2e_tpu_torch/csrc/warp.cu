// K3: bilinear backwarp of single-plane images by a flow field.
//
// Replaces v2e_tpu/ops/pallas/warp.py::bilinear_warp_pallas
// (_warp_kernel_rowwise).  The plain PyTorch version is
// v2e_tpu_torch/ops/kernels/warp.py::warp_plain (= models/backwarp.py's
// backwarp).
//
// out[n,y,x] samples img[n] bilinearly at (x + u - 0.5, y + v - 0.5) with
// zero padding outside the image: torch grid_sample with
// align_corners=False, as the original SuperSloMo backWarp builds its grid.
//
// Design.  The TPU kernel turned the gather into one-hot matrix products on
// the MXU over a window of +-max_disp pixels around each tile, and clamped
// flow to that window.  Hopper gathers directly: one thread per output
// pixel reads its four taps in f32.  The flow is not clamped, so the kernel
// equals backwarp for any flow; on the main path the chunk's window already
// covers its flow, where the two agree.
//
// Bound on the card: it reads the image and both flow planes and writes the
// output, 16 bytes per pixel (the taps mostly hit L1/L2, since flow is
// smooth); some 30 operations per pixel.  So it is bound by memory bytes.
//
// Rounding: built with --fmad=false; the taps are weighted and summed in
// backwarp's order, so the kernel matches the plain version bit for bit.
//
// The VJP (v2e_bilinear_warp_bwd) is K3's gradient for SuperSloMo training:
// the JAX package differentiates backwarp with XLA's autodiff, which the
// plain PyTorch version warp_plain_vjp writes out.  The floor and the
// clamped tap indices have zero gradient, so with v_k a tap's value times
// its in-bounds mask:
//   grad_u = gout * (-(1-wy) v00 + (1-wy) v10 - wy v01 + wy v11)
//   grad_v = gout * (-(1-wx) v00 - wx v10 + (1-wx) v01 + wx v11)
// One thread per output pixel recomputes its four taps and writes both
// flow gradients: no reduction, 24 bytes per pixel (image, flow planes and
// gout read, two gradient planes written), so bound by memory bytes.  On
// request the image gradient is scattered too: each in-bounds tap adds
// gout * w_k into a zeroed plane with atomicAdd, whose order of additions
// is not fixed (a tolerance, not equality, holds it).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float tap(const float* __restrict__ img, float xi,
                                     float yi, float w, int H, int W) {
  float inb = (xi >= 0.0f && xi < (float)W && yi >= 0.0f && yi < (float)H)
                  ? 1.0f : 0.0f;
  int xc = (int)fminf(fmaxf(xi, 0.0f), (float)(W - 1));
  int yc = (int)fminf(fmaxf(yi, 0.0f), (float)(H - 1));
  return img[(size_t)yc * W + xc] * (w * inb);
}

__global__ void warp_kernel(const float* __restrict__ img,
                            const float* __restrict__ u,
                            const float* __restrict__ v,
                            float* __restrict__ out, int N, int H, int W,
                            long long uv_nstride) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long plane = (long long)H * W;
  if (idx >= (long long)N * plane) return;
  int n = (int)(idx / plane);
  long long p = idx - (long long)n * plane;
  int y = (int)(p / W);
  int x = (int)(p - (long long)y * W);
  long long fo = (long long)n * uv_nstride + p;
  float fx = ((float)x + u[fo]) - 0.5f;
  float fy = ((float)y + v[fo]) - 0.5f;
  float x0 = floorf(fx);
  float y0 = floorf(fy);
  float wx = fx - x0;
  float wy = fy - y0;
  const float* src = img + (long long)n * plane;
  float acc = tap(src, x0, y0, (1.0f - wx) * (1.0f - wy), H, W);
  acc = acc + tap(src, x0 + 1.0f, y0, wx * (1.0f - wy), H, W);
  acc = acc + tap(src, x0, y0 + 1.0f, (1.0f - wx) * wy, H, W);
  acc = acc + tap(src, x0 + 1.0f, y0 + 1.0f, wx * wy, H, W);
  out[idx] = acc;
}

// The four taps of out[n,y,x] for the VJP: their values times their
// in-bounds masks, and for the image gradient their flat indices (-1 for a
// tap outside the image).
__device__ __forceinline__ float tap_value(const float* __restrict__ img, float xi,
                                           float yi, int H, int W, long long* at) {
  bool inside = xi >= 0.0f && xi < (float)W && yi >= 0.0f && yi < (float)H;
  int xc = (int)fminf(fmaxf(xi, 0.0f), (float)(W - 1));
  int yc = (int)fminf(fmaxf(yi, 0.0f), (float)(H - 1));
  long long k = (long long)yc * W + xc;
  *at = inside ? k : -1;
  return img[k] * (inside ? 1.0f : 0.0f);
}

__global__ void warp_bwd_kernel(const float* __restrict__ img,
                                const float* __restrict__ u,
                                const float* __restrict__ v,
                                const float* __restrict__ gout,
                                float* __restrict__ gu, float* __restrict__ gv,
                                float* __restrict__ gimg, int N, int H, int W,
                                long long uv_nstride, long long g_nstride) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long plane = (long long)H * W;
  if (idx >= (long long)N * plane) return;
  int n = (int)(idx / plane);
  long long p = idx - (long long)n * plane;
  int y = (int)(p / W);
  int x = (int)(p - (long long)y * W);
  long long fo = (long long)n * uv_nstride + p;
  float fx = ((float)x + u[fo]) - 0.5f;
  float fy = ((float)y + v[fo]) - 0.5f;
  float x0 = floorf(fx);
  float y0 = floorf(fy);
  float wx = fx - x0;
  float wy = fy - y0;
  const float* src = img + (long long)n * plane;
  long long a00, a10, a01, a11;
  float v00 = tap_value(src, x0, y0, H, W, &a00);
  float v10 = tap_value(src, x0 + 1.0f, y0, H, W, &a10);
  float v01 = tap_value(src, x0, y0 + 1.0f, H, W, &a01);
  float v11 = tap_value(src, x0 + 1.0f, y0 + 1.0f, H, W, &a11);
  float g = gout[idx];
  float omx = 1.0f - wx;
  float omy = 1.0f - wy;
  float du = (((-omy) * v00 + omy * v10) - wy * v01) + wy * v11;
  float dv = (((-omx) * v00 - wx * v10) + omx * v01) + wx * v11;
  long long go = (long long)n * g_nstride + p;
  gu[go] = g * du;
  gv[go] = g * dv;
  if (gimg != nullptr) {
    float* dst = gimg + (long long)n * plane;
    if (a00 >= 0) atomicAdd(dst + a00, g * (omx * omy));
    if (a10 >= 0) atomicAdd(dst + a10, g * (wx * omy));
    if (a01 >= 0) atomicAdd(dst + a01, g * (omx * wy));
    if (a11 >= 0) atomicAdd(dst + a11, g * (wx * wy));
  }
}

}  // namespace

// img, out: [N,H,W] contiguous f32.  u, v: the flow planes of image n start
// at u + n*uv_nstride (v likewise), each [H,W] contiguous.  One launch on
// `stream`, no sync.  Returns cudaGetLastError().
extern "C" int v2e_bilinear_warp(const float* img, const float* u,
                                 const float* v, float* out, int N, int H,
                                 int W, long long uv_nstride, void* stream) {
  long long total = (long long)N * H * W;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  warp_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      img, u, v, out, N, H, W, uv_nstride);
  return (int)cudaGetLastError();
}

// K3's VJP.  img, gout: [N,H,W] contiguous f32; u, v as for
// v2e_bilinear_warp.  gu, gv: the flow gradient planes of image n start at
// gu + n*g_nstride (gv likewise), each [H,W] contiguous.  gimg: a zeroed
// [N,H,W] f32 plane to accumulate the image gradient into, or null.  One
// launch on `stream`, no sync.  Returns cudaGetLastError().
extern "C" int v2e_bilinear_warp_bwd(const float* img, const float* u,
                                     const float* v, const float* gout,
                                     float* gu, float* gv, float* gimg, int N,
                                     int H, int W, long long uv_nstride,
                                     long long g_nstride, void* stream) {
  long long total = (long long)N * H * W;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  warp_bwd_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      img, u, v, gout, gu, gv, gimg, N, H, W, uv_nstride, g_nstride);
  return (int)cudaGetLastError();
}
