// K5: 3x3 stride-1 'same' convolution + bias + LeakyReLU on NHWC input,
// accumulated in float32.
//
// Replaces v2e_tpu/ops/pallas/conv3.py:201 (conv3x3_lane, its _kernel).
// The plain PyTorch version is
// v2e_tpu_torch/ops/kernels/conv3.py::conv3x3_lane_plain.
//
// What it computes, for x [N,H,W,Ci] (bf16 or f32), the weights w cast to
// x's type and laid out [9][CiP][CoP] by the wrapper (tap-major, zero
// padded to CiP = Ci rounded up to 16 and CoP = Co rounded up to 64) and a
// float32 bias b [Co]:
//   acc[n,h,w,o] = sum_{ky,kx,i} x[n,h+ky-1,w+kx-1,i] * w[ky,kx,i,o]
//                  (float32; taps outside the image are zero)
//   y = acc + b[o];  y = max(y, slope * y) when act;  out = y cast once
// to x's type.  That is the TPU kernel's epilogue: bias and activation in
// float32, one rounding at the end (the dense UNet form rounds the
// convolution, the bias add and the activation separately).
//
// Design.  The TPU kernel rearranged the taps (hcol, zfull) so that a
// narrow Co would fill the 128 lanes of its matrix unit; it measured slower
// than the dense conv there.  None of that carries over.  Here the conv is
// an implicit GEMM: M = N*H*W output pixels, N = Co, K = 9*Ci.  One block
// of 8 warps computes a tile of 8 output rows x 16 columns of one image for
// up to 64 output channels (blockIdx.z walks images and 64-channel slices).
// It walks Ci in slices: per slice it stages the 10x18 input tile with its
// one-pixel halo (zeros outside the image: 'same' padding) and the slice's
// 9 x slice x 64 weights in shared memory, then
//   bf16: each warp owns one output row of 16 pixels and issues, per tap,
//         one 16x16x16 bf16 MMA (WMMA, float32 accumulation) for each 16
//         output channels.  The A fragment of tap (ky,kx) is the staged
//         row ky+warp starting at column kx: 16 pixels whose slice of 16
//         channels lies at a stride of 16 elements, so no im2col copy is
//         made.  Products of two bf16 values are exact in float32.
//   f32:  each thread owns one pixel and 32 output channels and runs
//         float32 FMAs on the CUDA cores (the f32 form serves the tests and
//         the plain-precision UNet; the main path is bf16).
// The epilogue (bf16: through shared memory) adds the bias to the float32
// sums, applies the activation and writes NHWC rows, Co contiguous.
//
// Shared memory: bf16 5,760 B input + 18,432 B weights, reused as the
// 32,768 B float32 output tile; f32 6,480 + 18,432 B.  Below the 48 KB of
// static shared memory, so no cudaFuncSetAttribute: the up4 weights
// (9*128*64 bf16 = 147 KB) never sit in shared memory whole, one Ci slice
// at a time does.
//
// Bound on the card: at the UNet's up-tail shapes (Ci 64-128, Co 32-64)
// the tensor-core FLOPs (2*9*Ci*Co per pixel) and the bytes (x read once,
// y written once) bound it about equally; chip_smoke.py computes both for
// the shapes the main path launches.  This first version has no pipeline:
// each slice's loads wait for the previous slice's MMAs, and the halo is
// re-read by neighbouring blocks (18*10/(16*8) = 1.4x the input).  TMA,
// wgmma and a multi-stage ring are later work.
//
// Rounding: built with --fmad=false; the f32 form uses explicit fmaf.  The
// order of the float32 sums differs from the plain version's (cuDNN or the
// CPU's conv), so the result agrees to float32 rounding before the final
// cast: within one bf16 ulp of the output for bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kTH = 8;        // output rows per block, one warp each
constexpr int kTW = 16;       // output columns per block: one MMA row block
constexpr int kIH = kTH + 2;  // staged input rows and columns, with the halo
constexpr int kIW = kTW + 2;
constexpr int kCoBlk = 64;    // output channels per block
constexpr int kThreads = kTH * 32;

// bf16: Ci in slices of 16, one MMA depth
constexpr int kKC = 16;

// shared memory of the bf16 form, carved from raw bytes (the bf16 type has
// constructors, which __shared__ variables may not have): the staged input
// [row][col][ci] and weights [tap][ci][co], reused as the float32 output
// tile [pixel][co] after the last slice
constexpr int kXBytes = kIH * kIW * kKC * 2;        // 5,760
constexpr int kWBytes = 9 * kKC * kCoBlk * 2;       // 18,432
constexpr int kYBytes = kTH * kTW * kCoBlk * 4;     // 32,768
constexpr int kSmemBf16 = kXBytes + kWBytes > kYBytes ? kXBytes + kWBytes : kYBytes;

// f32: Ci in slices of 8; the staged pixel stride is padded to 9 floats
// so that the 32 pixels a warp reads fall in 32 different banks
constexpr int kKC32 = 8;
constexpr int kKP32 = 9;

struct SmemF32 {
  float x[kIH * kIW * kKP32];
  float w[9 * kKC32 * kCoBlk];
};

__device__ __forceinline__ float epilogue(float acc, float bias, float slope,
                                          int act) {
  float v = acc + bias;
  return act ? fmaxf(v, slope * v) : v;
}

__global__ void __launch_bounds__(kThreads)
conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w9,
                    const float* __restrict__ b, __nv_bfloat16* __restrict__ y,
                    int H, int W, int Ci, int Co, int CiP, int CoP,
                    int co_blocks, float slope, int act, int vec) {
  __shared__ __align__(128) unsigned char smem[kSmemBf16];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + kXBytes);
  float* ys = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int w0 = blockIdx.x * kTW;
  const int h0 = blockIdx.y * kTH;
  const int n = blockIdx.z / co_blocks;
  const int co0 = (blockIdx.z - n * co_blocks) * kCoBlk;
  const int nco = min(kCoBlk, Co - co0);
  const int nfrag = (nco + 15) >> 4;
  const size_t img = (size_t)n * H;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kCoBlk / 16];
#pragma unroll
  for (int f = 0; f < kCoBlk / 16; ++f) wmma::fill_fragment(acc[f], 0.0f);

  for (int ci0 = 0; ci0 < Ci; ci0 += kKC) {
    // input tile with the halo; zeros outside the image and past Ci
    if (vec) {  // Ci % 8 == 0 and x 16-byte aligned: 8 channels per load
      for (int v = tid; v < kIH * kIW * (kKC / 8); v += kThreads) {
        const int pix = v >> 1, part = v & 1;
        const int r = pix / kIW, c = pix - r * kIW;
        const int h = h0 - 1 + r, wc = w0 - 1 + c, ci = ci0 + part * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (h >= 0 && h < H && wc >= 0 && wc < W && ci < Ci)
          val = *reinterpret_cast<const uint4*>(x + ((img + h) * W + wc) * Ci + ci);
        *reinterpret_cast<uint4*>(&xs[pix * kKC + part * 8]) = val;
      }
    } else {
      for (int e = tid; e < kIH * kIW * kKC; e += kThreads) {
        const int pix = e / kKC, k = e - pix * kKC;
        const int r = pix / kIW, c = pix - r * kIW;
        const int h = h0 - 1 + r, wc = w0 - 1 + c, ci = ci0 + k;
        __nv_bfloat16 val = __float2bfloat16_rn(0.0f);
        if (h >= 0 && h < H && wc >= 0 && wc < W && ci < Ci)
          val = x[((img + h) * W + wc) * Ci + ci];
        xs[e] = val;
      }
    }
    // the slice's weights: [9][16][64] from [9][CiP][CoP], 8 per load
    for (int v = tid; v < 9 * kKC * kCoBlk / 8; v += kThreads) {
      const int e = v * 8;
      const int t = e / (kKC * kCoBlk);
      const int rem = e - t * (kKC * kCoBlk);
      const int k = rem / kCoBlk, j = rem - k * kCoBlk;
      *reinterpret_cast<uint4*>(&ws[e]) = *reinterpret_cast<const uint4*>(
          w9 + ((size_t)t * CiP + ci0 + k) * CoP + co0 + j);
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int ky = t / 3, kx = t - ky * 3;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, &xs[((warp + ky) * kIW + kx) * kKC], kKC);
#pragma unroll
      for (int f = 0; f < kCoBlk / 16; ++f) {
        if (f < nfrag) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bm;
          wmma::load_matrix_sync(bm, &ws[t * kKC * kCoBlk + f * 16], kCoBlk);
          wmma::mma_sync(acc[f], a, bm, acc[f]);
        }
      }
    }
    __syncthreads();
  }

  // float32 sums -> shared memory (over the staged inputs: all warps are
  // past the last slice's barrier), then bias, activation, one cast
#pragma unroll
  for (int f = 0; f < kCoBlk / 16; ++f) {
    if (f < nfrag)
      wmma::store_matrix_sync(&ys[warp * kTW * kCoBlk + f * 16], acc[f], kCoBlk,
                              wmma::mem_row_major);
  }
  __syncthreads();
  for (int e = tid; e < kTH * kTW * nco; e += kThreads) {
    const int p = e / nco, j = e - p * nco;
    const int h = h0 + p / kTW, wc = w0 + (p % kTW);
    if (h < H && wc < W) {
      const float v = epilogue(ys[p * kCoBlk + j], b[co0 + j], slope, act);
      y[((img + h) * W + wc) * Co + co0 + j] = __float2bfloat16_rn(v);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ w9,
                   const float* __restrict__ b, float* __restrict__ y, int H,
                   int W, int Ci, int Co, int CiP, int CoP, int co_blocks,
                   float slope, int act) {
  __shared__ __align__(16) SmemF32 s;
  const int tid = threadIdx.x;
  const int p = tid % (kTH * kTW);  // this thread's pixel in the tile
  const int g = tid / (kTH * kTW);  // and its half of the 64 channels
  const int pr = p / kTW, pc = p - pr * kTW;
  const int w0 = blockIdx.x * kTW;
  const int h0 = blockIdx.y * kTH;
  const int n = blockIdx.z / co_blocks;
  const int co0 = (blockIdx.z - n * co_blocks) * kCoBlk;
  const size_t img = (size_t)n * H;

  float acc[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.0f;

  for (int ci0 = 0; ci0 < Ci; ci0 += kKC32) {
    for (int e = tid; e < kIH * kIW * kKC32; e += kThreads) {
      const int pix = e / kKC32, k = e - pix * kKC32;
      const int r = pix / kIW, c = pix - r * kIW;
      const int h = h0 - 1 + r, wc = w0 - 1 + c, ci = ci0 + k;
      float val = 0.0f;
      if (h >= 0 && h < H && wc >= 0 && wc < W && ci < Ci)
        val = x[((img + h) * W + wc) * Ci + ci];
      s.x[pix * kKP32 + k] = val;
    }
    for (int e = tid; e < 9 * kKC32 * kCoBlk; e += kThreads) {
      const int t = e / (kKC32 * kCoBlk);
      const int rem = e - t * (kKC32 * kCoBlk);
      const int k = rem / kCoBlk, j = rem - k * kCoBlk;
      s.w[e] = w9[((size_t)t * CiP + ci0 + k) * CoP + co0 + j];
    }
    __syncthreads();
    for (int t = 0; t < 9; ++t) {
      const int ky = t / 3, kx = t - ky * 3;
      const float* xp = &s.x[((pr + ky) * kIW + pc + kx) * kKP32];
#pragma unroll
      for (int k = 0; k < kKC32; ++k) {
        const float a = xp[k];
        const float* wp = &s.w[(t * kKC32 + k) * kCoBlk + g * 32];
#pragma unroll
        for (int j = 0; j < 32; ++j) acc[j] = __fmaf_rn(a, wp[j], acc[j]);
      }
    }
    __syncthreads();
  }

  const int h = h0 + pr, wc = w0 + pc;
  if (h < H && wc < W) {
    float* out = y + ((img + h) * W + wc) * Co;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int co = co0 + g * 32 + j;
      if (co < Co) out[co] = epilogue(acc[j], b[co], slope, act);
    }
  }
}

}  // namespace

// x, y: [N,H,W,Ci] and [N,H,W,Co] contiguous, bf16 (is_bf16 = 1) or f32.
// w9: [9][CiP][CoP] in x's type, zero past Ci and Co; CiP a multiple of 16,
// CoP of 64.  b: f32 [Co].  act = 0 skips the activation.  vec = 1 lets
// the bf16 form load 8 channels at once (Ci % 8 == 0, x 16-byte aligned).
// One launch on `stream`, no sync.  Returns cudaGetLastError().
extern "C" int v2e_conv3x3(const void* x, const void* w9, const float* b,
                           void* y, int N, int H, int W, int Ci, int Co,
                           int CiP, int CoP, float slope, int act, int is_bf16,
                           int vec, void* stream) {
  if (N == 0 || H == 0 || W == 0 || Co == 0) return 0;
  const int co_blocks = (Co + kCoBlk - 1) / kCoBlk;
  dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, N * co_blocks);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    conv3x3_bf16_kernel<<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w9, b,
        (__nv_bfloat16*)y, H, W, Ci, Co, CiP, CoP, co_blocks, slope, act, vec);
  } else {
    conv3x3_f32_kernel<<<grid, kThreads, 0, st>>>(
        (const float*)x, (const float*)w9, b, (float*)y, H, W, Ci, Co, CiP,
        CoP, co_blocks, slope, act);
  }
  return (int)cudaGetLastError();
}
