// K8: the epilogue of the SuperSloMo UNets' dense convolutions on the
// inference path, NHWC: bias, LeakyReLU(0.1) and, at each up level's conv1,
// the concatenation with the skip, in one pass (models/unet.py).
//
// Replaces no Pallas kernel: the JAX package's NHWC UNet leaves bias and
// activation to XLA's fusion (v2e_tpu/models/unet.py::_conv_block).  The
// port had run nn.Conv2d in NCHW, so cuDNN's NHWC kernels transposed every
// input and output, ATen added the bias in a broadcast pass of its own,
// F.leaky_relu read and wrote the activation again and torch.cat copied
// conv1's output and the skip.  The plain PyTorch version is
// v2e_tpu_torch/ops/kernels/conv_epilogue.py::conv_bias_leaky_plain.
//
// What it computes, for y [N,H,W,Co] (the bias-free conv's output):
//   out[n,h,w,c] = round(LeakyReLU_0.1(float(y[n,h,w,c]) + bias[c]))
// with the float32 master bias and one rounding to y's type, as K5's
// epilogue does; LeakyReLU is v > 0 ? v : 0.1f v, F.leaky_relu's.  With a
// skip [N,H,W,Co], out is [N,H,W,2Co]: channels 0..Co-1 take the epilogue
// and Co..2Co-1 the skip, copied bit for bit.  Built with --fmad=false; an
// add and a multiply round as written, so the kernel equals the plain
// version bit for bit.
//
// Bound on the card: memory bytes.  Per element it reads 2 B and writes
// 2 B (bf16) for two float operations, so it runs at the card's bandwidth
// or not at all.  Design: one thread per V channels of a pixel (V = 8 in
// bf16 and fp16, 4 in float32: one 16-byte load and one 16-byte store),
// adjacent threads on adjacent addresses; with the skip, a pixel's second
// half of lanes copies the skip with the same 16-byte accesses.  The grid
// fills the card once (2048 threads an SM) and strides over the pixels by
// a whole number of pixels, so each thread keeps its channels and loads
// their V biases into registers once.  A block holds a whole number of
// pixels' lanes.  Where Co does not divide by V (conv3's 5 and 4 outputs)
// or a pointer is not 16-byte aligned, the same code runs with V = 1.

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

// V contiguous elements, one access (V elements of 16 bytes at most).
template <typename T, int V>
struct alignas(V * sizeof(T) < 16 ? V * sizeof(T) : 16) Pack {
  T v[V];
};

__device__ __forceinline__ float leaky(float v) { return v > 0.0f ? v : v * 0.1f; }

// Thread = one of L lanes of a pixel (L = G = Co / V, or 2G with the skip,
// lanes G..2G-1 copying it), then the same lane every `step` pixels.
template <typename T, int V, bool SKIP>
__global__ void __launch_bounds__(1024)
conv_bias_leaky_nhwc(const T* y, const float* __restrict__ bias, const T* skip, T* out,
                     long long pixels, int G) {
  const int L = SKIP ? 2 * G : G;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = (int)(tid % L);
  const long long step = (long long)gridDim.x * blockDim.x / L;
  const bool epi = !SKIP || lane < G;
  const int c0 = (epi ? lane : lane - G) * V;
  const long long Co = (long long)G * V, Cout = (long long)L * V;
  float b[V];
#pragma unroll
  for (int k = 0; k < V; ++k) b[k] = epi ? bias[c0 + k] : 0.0f;
  for (long long p = tid / L; p < pixels; p += step) {
    if (epi) {
      const Pack<T, V> in = *reinterpret_cast<const Pack<T, V>*>(y + p * Co + c0);
      Pack<T, V> o;
#pragma unroll
      for (int k = 0; k < V; ++k) o.v[k] = from_f<T>(leaky(to_f(in.v[k]) + b[k]));
      *reinterpret_cast<Pack<T, V>*>(out + p * Cout + c0) = o;
    } else {
      *reinterpret_cast<Pack<T, V>*>(out + p * Cout + Co + c0) =
          *reinterpret_cast<const Pack<T, V>*>(skip + p * Co + c0);
    }
  }
}

constexpr int kThreadsPerSm = 2048;

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (!count[dev] &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    count[dev] = 132;
  return count[dev];
}

template <typename T, int V, bool SKIP>
int launch_v(const void* y, const float* bias, const void* skip, void* out, long long pixels,
             int Co, cudaStream_t stream) {
  const int G = Co / V;
  const int L = SKIP ? 2 * G : G;
  if (L > 1024) return (int)cudaErrorInvalidValue;
  const int block = L <= 256 ? (256 / L) * L : L;
  const long long want = (pixels * L + block - 1) / block;
  const int per_sm = kThreadsPerSm / block > 0 ? kThreadsPerSm / block : 1;
  const long long fill = (long long)sm_count() * per_sm;
  const unsigned grid = (unsigned)(want < fill ? want : fill);
  conv_bias_leaky_nhwc<T, V, SKIP><<<grid, block, 0, stream>>>(
      (const T*)y, bias, (const T*)skip, (T*)out, pixels, G);
  return (int)cudaGetLastError();
}

template <typename T>
int epilogue(const void* y, const float* bias, const void* skip, void* out, long long pixels,
             int Co, void* stream) {
  constexpr int VM = 16 / sizeof(T);
  const bool aligned = (uintptr_t)y % 16 == 0 && (uintptr_t)out % 16 == 0 &&
                       (uintptr_t)skip % 16 == 0;
  const bool wide = aligned && Co % VM == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (skip) {
    return wide ? launch_v<T, VM, true>(y, bias, skip, out, pixels, Co, s)
                : launch_v<T, 1, true>(y, bias, skip, out, pixels, Co, s);
  }
  return wide ? launch_v<T, VM, false>(y, bias, skip, out, pixels, Co, s)
              : launch_v<T, 1, false>(y, bias, skip, out, pixels, Co, s);
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16.  y: [pixels, Co] (NHWC, the
// conv's output), bias: [Co] float32, skip: [pixels, Co] or null, out:
// [pixels, Co] or, with the skip, [pixels, 2Co]; y, skip and out in one
// type, each contiguous.  One launch on `stream`, no sync.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a dtype it does not take
// or more than 1024 lanes a pixel.
extern "C" int v2e_conv_bias_leaky(const void* y, const float* bias, const void* skip,
                                   void* out, long long pixels, int Co, int dtype,
                                   void* stream) {
  if (pixels <= 0 || Co <= 0) return pixels < 0 || Co < 0 ? (int)cudaErrorInvalidValue : 0;
  switch (dtype) {
    case 0: return epilogue<float>(y, bias, skip, out, pixels, Co, stream);
    case 1: return epilogue<__half>(y, bias, skip, out, pixels, Co, stream);
    case 2: return epilogue<__nv_bfloat16>(y, bias, skip, out, pixels, Co, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
