// K6: bilinear x2 upsample of NCHW images and its VJP, for the SuperSloMo
// UNets' up path (models/unet.py::_upsample2).
//
// Replaces no Pallas kernel: the JAX package leaves its upsample to
// jax.image.resize (v2e_tpu/models/unet.py::_upsample2_nhwc).  The port
// called F.interpolate(x, scale_factor=2, mode="bilinear",
// align_corners=False), whose NCHW CUDA kernel runs one thread per output
// pixel that loops over all N*C planes: at the first up level (16x20 out)
// that is 320 threads, each walking tens of thousands of planes.  The plain
// PyTorch version is v2e_tpu_torch/ops/kernels/upsample.py::
// upsample2x_plain (and upsample2x_plain_vjp for the gradient).
//
// What it computes, as F.interpolate does: along each axis of n input
// samples, output o samples the source at max(0.5 (o + 0.5) - 0.5, 0), so
//   o = 0:       taps (0, min(1, n-1)),   weights (1, 0)
//   o = 2i, i>0: taps (i-1, i),           weights (0.25, 0.75)
//   o = 2i+1:    taps (i, min(i+1, n-1)), weights (0.75, 0.25)
// and out = h0 (w0 a + w1 b) + h1 (w0 c + w1 d), F.interpolate's expression
// with its taps a, b (row tap 0) and c, d (row tap 1), in float32, rounded
// once to the output type.  Built with --fmad=false, so every product and
// sum rounds as written: the kernel equals the plain version bit for bit,
// and PyTorch's kernel (built with FMA contraction) to one ulp of the
// output type.
//
// The VJP is the transpose: along each axis input i collects outputs
//   2i-1 (0.25), 2i (0.75, or 1 at i = 0), 2i+1 (0.75, or 1 at i = n-1),
//   2i+2 (0.25)
// (the clamped edges take their full weight), with out-of-range outputs
// weighted 0.  It is a gather with no atomics, summed in float32 in a fixed
// order (columns, then rows, each left to right) and rounded once, so it is
// deterministic.  It is built for float32 NCHW alone: training's type and
// layout.
//
// Bound on the card: memory bytes.  An input pixel costs 2 B read and 8 B
// written per bf16 plane (one 2x2 output block), some 12 float operations.
// Design: one thread per run of V input pixels along a row (NCHW) or per V
// channels of one pixel (channels_last), so the grid covers N*C*H*W / V
// threads and fills the 132 SMs at every level; no thread loops over planes.
// A thread reads the clamped 3x3 neighbourhood of its pixels (L1/L2 serve
// the rereads) and writes their 2x2 outputs with 16-byte stores, adjacent
// threads on adjacent addresses.  V is the widest vector for which the row
// (NCHW) or the channels (channels_last) divide and the pointers are 16-byte
// aligned; any other shape runs the same code with V = 1 and scalar access.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// N contiguous elements: one vector access (VEC, aligned to its size up
// to 16 bytes) or N element accesses (the V = 1 path, on any alignment).
template <typename T, int N, bool VEC>
struct alignas(!VEC ? sizeof(T) : N * sizeof(T) < 16 ? N * sizeof(T) : 16) Pack {
  T v[N];
};

// N elements from src to float.
template <typename T, int N, bool VEC>
__device__ __forceinline__ void load(const T* __restrict__ src, float* dst) {
  const Pack<T, N, VEC> p = *reinterpret_cast<const Pack<T, N, VEC>*>(src);
#pragma unroll
  for (int k = 0; k < N; ++k) dst[k] = to_f(p.v[k]);
}

// N floats rounded once to T and stored at dst.
template <typename T, int N, bool VEC>
__device__ __forceinline__ void store(T* __restrict__ dst, const float* src) {
  Pack<T, N, VEC> p;
#pragma unroll
  for (int k = 0; k < N; ++k) p.v[k] = from_f<T>(src[k]);
  *reinterpret_cast<Pack<T, N, VEC>*>(dst) = p;
}

// Even output 2i of an axis from the samples at i-1, i, i+1 (clamped):
// (0, 1) -> weights (1, 0) at i = 0, else (i-1, i) -> (0.25, 0.75).
__device__ __forceinline__ float even_tap(bool first, float prev, float cur, float next) {
  return first ? 1.0f * cur + 0.0f * next : 0.25f * prev + 0.75f * cur;
}

// Odd output 2i+1: (i, i+1 clamped) -> (0.75, 0.25).
__device__ __forceinline__ float odd_tap(float cur, float next) {
  return 0.75f * cur + 0.25f * next;
}

// Thread = (plane, input row h, V input columns from w0).  Loads rows
// h-1, h, h+1 and columns w0-1 .. w0+V (clamped), interpolates each row
// along W into 2V columns, then rows 2h and 2h+1 along H.
template <typename T, int V>
__global__ void __launch_bounds__(256)
upsample_bilinear2x_nchw(const T* __restrict__ x, T* __restrict__ out, int total,
                         int H, int W) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  int G = W / V;
  int g = idx % G;
  int rest = idx / G;
  int h = rest % H;
  int p = rest / H;
  int w0 = g * V;
  const T* src = x + (size_t)p * H * W;
  float t[3][2 * V];
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const T* row = src + (size_t)min(max(h - 1 + s, 0), H - 1) * W;
    float r[V + 2];
    r[0] = to_f(row[max(w0 - 1, 0)]);
    load<T, V, (V > 1)>(row + w0, r + 1);
    r[V + 1] = to_f(row[min(w0 + V, W - 1)]);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      t[s][2 * k] = even_tap(w0 + k == 0, r[k], r[k + 1], r[k + 2]);
      t[s][2 * k + 1] = odd_tap(r[k + 1], r[k + 2]);
    }
  }
  float o[2 * V];
  T* dst = out + ((size_t)p * 2 * H + 2 * h) * 2 * W + 2 * w0;
#pragma unroll
  for (int c = 0; c < 2 * V; ++c) o[c] = even_tap(h == 0, t[0][c], t[1][c], t[2][c]);
  store<T, 2 * V, (V > 1)>(dst, o);
#pragma unroll
  for (int c = 0; c < 2 * V; ++c) o[c] = odd_tap(t[1][c], t[2][c]);
  store<T, 2 * V, (V > 1)>(dst + 2 * W, o);
}

// Thread = (image n, input pixel (h, w), V channels from c0): the pixel's
// 3x3 neighbourhood (clamped) to its 2x2 output pixels.
template <typename T, int V>
__global__ void __launch_bounds__(256)
upsample_bilinear2x_nhwc(const T* __restrict__ x, T* __restrict__ out, int total,
                         int H, int W, int C) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  int G = C / V;
  int c0 = (idx % G) * V;
  int rest = idx / G;
  int w = rest % W;
  rest /= W;
  int h = rest % H;
  int n = rest / H;
  const T* src = x + (size_t)n * H * W * C + c0;
  float t[3][2][V];
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const T* row = src + (size_t)min(max(h - 1 + s, 0), H - 1) * W * C;
    float r[3][V];
#pragma unroll
    for (int q = 0; q < 3; ++q)
      load<T, V, (V > 1)>(row + (size_t)min(max(w - 1 + q, 0), W - 1) * C, r[q]);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      t[s][0][k] = even_tap(w == 0, r[0][k], r[1][k], r[2][k]);
      t[s][1][k] = odd_tap(r[1][k], r[2][k]);
    }
  }
  T* dst = out + (((size_t)n * 2 * H + 2 * h) * 2 * W + 2 * w) * C + c0;
  size_t down = (size_t)2 * W * C;
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    float o[V];
#pragma unroll
    for (int k = 0; k < V; ++k) o[k] = even_tap(h == 0, t[0][b][k], t[1][b][k], t[2][b][k]);
    store<T, V, (V > 1)>(dst + b * C, o);
#pragma unroll
    for (int k = 0; k < V; ++k) o[k] = odd_tap(t[1][b][k], t[2][b][k]);
    store<T, V, (V > 1)>(dst + down + b * C, o);
  }
}

// The VJP's taps of input i along an axis of n: the outputs 2i-1 .. 2i+2
// (clamped into 0 .. 2n-1) and their weights.
struct VjpTaps {
  int at[4];
  float w[4];
};

__device__ __forceinline__ VjpTaps vjp_taps(int i, int n) {
  VjpTaps t;
  t.at[0] = max(2 * i - 1, 0);
  t.at[1] = 2 * i;
  t.at[2] = 2 * i + 1;
  t.at[3] = min(2 * i + 2, 2 * n - 1);
  t.w[0] = i >= 1 ? 0.25f : 0.0f;
  t.w[1] = i >= 1 ? 0.75f : 1.0f;
  t.w[2] = i <= n - 2 ? 0.75f : 1.0f;
  t.w[3] = i <= n - 2 ? 0.25f : 0.0f;
  return t;
}

// Thread = (plane, input row i, V input columns from j0).  For each of the
// four output rows: the 2V+2 gradient columns 2j0-1 .. 2j0+2V (clamped)
// summed along W into V columns, then the four rows summed along H.
template <typename T, int V>
__global__ void __launch_bounds__(256)
upsample_bilinear2x_vjp_nchw(const T* __restrict__ gout, T* __restrict__ gx, int total,
                             int H, int W) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  int G = W / V;
  int g = idx % G;
  int rest = idx / G;
  int i = rest % H;
  int p = rest / H;
  int j0 = g * V;
  int W2 = 2 * W;
  const T* src = gout + (size_t)p * 4 * H * W;
  VjpTaps ty = vjp_taps(i, H);
  VjpTaps tx[V];
#pragma unroll
  for (int k = 0; k < V; ++k) tx[k] = vjp_taps(j0 + k, W);
  float acc[V];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const T* row = src + (size_t)ty.at[a] * W2;
    // r[q] = column 2j0 - 1 + q, clamped
    float r[2 * V + 2];
    r[0] = to_f(row[max(2 * j0 - 1, 0)]);
    load<T, 2 * V, (V > 1)>(row + 2 * j0, r + 1);
    r[2 * V + 1] = to_f(row[min(2 * j0 + 2 * V, W2 - 1)]);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float u = tx[k].w[0] * r[2 * k] + tx[k].w[1] * r[2 * k + 1];
      u = u + tx[k].w[2] * r[2 * k + 2];
      u = u + tx[k].w[3] * r[2 * k + 3];
      acc[k] = a == 0 ? ty.w[0] * u : acc[k] + ty.w[a] * u;
    }
  }
  store<T, V, (V > 1)>(gx + ((size_t)p * H + i) * W + j0, acc);
}

constexpr int kThreads = 256;

// The launch of one of the three kernels at vector width VMAX where `along`
// (W for NCHW, C for channels_last) divides by it and both pointers are
// 16-byte aligned, else at width 1.  `threads_per_v1` is the thread count
// at width 1.
template <int VMAX, typename Launch>
int launch(const void* a, const void* b, long long threads_per_v1, int along, Launch fn,
           void* stream) {
  bool aligned = ((uintptr_t)a % 16 == 0) && ((uintptr_t)b % 16 == 0);
  int v = (aligned && along % VMAX == 0) ? VMAX : 1;
  long long total = threads_per_v1 / v;
  if (total == 0) return 0;
  if (total > 0x7fffffffLL - kThreads) return (int)cudaErrorInvalidValue;
  unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  fn(v == VMAX, (int)total, blocks, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

template <typename T>
int forward(const void* x, void* out, int N, int C, int H, int W, int channels_last,
            void* stream) {
  long long px = (long long)N * C * H * W;
  if (channels_last) {
    constexpr int VM = 16 / sizeof(T);
    return launch<VM>(x, out, px, C, [&](bool wide, int total, unsigned blocks, cudaStream_t s) {
      const T* xi = (const T*)x;
      T* o = (T*)out;
      if (wide)
        upsample_bilinear2x_nhwc<T, VM><<<blocks, kThreads, 0, s>>>(xi, o, total, H, W, C);
      else
        upsample_bilinear2x_nhwc<T, 1><<<blocks, kThreads, 0, s>>>(xi, o, total, H, W, C);
    }, stream);
  }
  // a thread's 2V outputs of a row fill one 16-byte store
  constexpr int VM = 8 / sizeof(T);
  return launch<VM>(x, out, px, W, [&](bool wide, int total, unsigned blocks, cudaStream_t s) {
    const T* xi = (const T*)x;
    T* o = (T*)out;
    if (wide)
      upsample_bilinear2x_nchw<T, VM><<<blocks, kThreads, 0, s>>>(xi, o, total, H, W);
    else
      upsample_bilinear2x_nchw<T, 1><<<blocks, kThreads, 0, s>>>(xi, o, total, H, W);
  }, stream);
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16.  x: [N,C,H,W] contiguous
// (channels_last = 0) or channels_last (1); out: [N,C,2H,2W] in the same
// layout and type.  One launch on `stream`, no sync.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a dtype it does not take
// or more than 2^31 threads.
extern "C" int v2e_upsample_bilinear2x(const void* x, void* out, int N, int C, int H,
                                       int W, int dtype, int channels_last, void* stream) {
  switch (dtype) {
    case 0: return forward<float>(x, out, N, C, H, W, channels_last, stream);
    case 1: return forward<__half>(x, out, N, C, H, W, channels_last, stream);
    case 2: return forward<__nv_bfloat16>(x, out, N, C, H, W, channels_last, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K6's VJP in float32 NCHW, the only form training runs.  gout:
// [N,C,2H,2W], gx: [N,C,H,W], both float32 and contiguous.  Every element
// of gx is written.  A thread's V = 4 input columns read 8 gradient columns
// of a row, two 16-byte loads.  One launch on `stream`, no sync.
extern "C" int v2e_upsample_bilinear2x_vjp(const float* gout, float* gx, int N, int C, int H,
                                           int W, void* stream) {
  constexpr int VM = 4;
  return launch<VM>(gout, gx, (long long)N * C * H * W, W,
                    [&](bool wide, int total, unsigned blocks, cudaStream_t s) {
    if (wide)
      upsample_bilinear2x_vjp_nchw<float, VM><<<blocks, kThreads, 0, s>>>(gout, gx, total, H, W);
    else
      upsample_bilinear2x_vjp_nchw<float, 1><<<blocks, kThreads, 0, s>>>(gout, gx, total, H, W);
  }, stream);
}
