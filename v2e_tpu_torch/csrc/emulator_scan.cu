// The DVS emulator's sequential core, one chunk of F frames over an H*W
// pixel plane: K1 with the closed-form refractory filter, and K2 without it
// (at the end of this file).
//
// K1 replaces v2e_tpu/ops/pallas/emulator_scan.py::emulator_scan_refractory_pallas
// (_refr_kernel).  The plain PyTorch version is
// v2e_tpu_torch/ops/kernels/emulator_scan.py::refractory_scan_plain.
//
// Per frame f, in order: base -= leak[f]; pos/neg = floor(relu(+-diff)/thr);
// K[f] = the largest count over the whole plane; the closed-form refractory
// filter (first index i0, stride m, emitted count, spike-time memory); base
// update; base reset to lp where shot noise fired.
//
// Design.  K[f] couples every pixel of frame f, and the TPU kernel took it
// as an in-kernel reduction over a plane held in VMEM.  Here each frame is
// two launches on the caller's stream, with no host sync and no grid
// barrier (a spinning barrier deadlocks once the grid is larger than what
// can be resident):
//   refr_count: diff and count per pixel, warp and block max, one atomicMax
//               into K[f] (zeroed by the wrapper once per chunk);
//   refr_apply: reads K[f] and applies the filter, updating base and the
//               spike-time memory in place and writing counts and i0.
// Stream order makes launch 2f+1 see the finished K[f].  2F launches per
// chunk.
//
// Bound on the card: it streams lp and leak (f32), the shot mask (u8) and
// writes counts and i0 (i16): 13 bytes per pixel per frame, plus the state
// planes once; the arithmetic is some 40 operations per pixel and frame,
// far below the card's rate.  So it is bound by memory bytes, plus the
// latency of 2F dependent launches; the count pass reads lp, leak and base
// a second time, which a later version can fuse away (F+1 launches).
//
// Rounding.  Built with --fmad=false and without fast math, so every float
// operation is rounded as written, in the reference's order.  The base
// update and the spike time are one multiply-add in the reference (XLA
// contracts them into an FMA); here, as in the plain version, they are one
// float64 multiply-add rounded once to float32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kI32MaxF = 2147483520.0f;  // largest float below 2^31

__device__ __forceinline__ float mul_add_once(float a, float b, float c) {
  return (float)((double)a * (double)b + (double)c);
}

__device__ __forceinline__ int pixel_count(float lp, float base, float pos,
                                           float neg, float* pe, float* ne) {
  float diff = lp - base;
  *pe = floorf(fmaxf(diff, 0.0f) / pos);
  *ne = floorf(fmaxf(-diff, 0.0f) / neg);
  return (int)(*pe + *ne);
}

// K2: the core without the refractory filter.  Each thread owns one pixel
// and walks the F frames in order with base in a register.
__global__ void scan_kernel(const float* __restrict__ lp,
                            const float* __restrict__ leak,
                            const uint8_t* __restrict__ shot,
                            const float* __restrict__ pos,
                            const float* __restrict__ neg,
                            float* __restrict__ base, int n_frames, int npix,
                            int16_t* __restrict__ count_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npix) return;
  float b = base[i];
  float pth = pos[i];
  float nth = neg[i];
#pragma unroll 4
  for (int f = 0; f < n_frames; ++f) {
    size_t off = (size_t)f * (size_t)npix + (size_t)i;
    float l = lp[off];
    if (leak != nullptr) b = b - leak[off];
    float pe, ne;
    pixel_count(l, b, pth, nth, &pe, &ne);
    b = mul_add_once(pe, pth, b);
    b = mul_add_once(-ne, nth, b);
    if (shot != nullptr && shot[off] != 0) b = l;
    count_out[off] = (int16_t)(int)(pe - ne);
  }
  base[i] = b;
}

__global__ void refr_count(const float* __restrict__ lp,
                           const float* __restrict__ leak,
                           const float* __restrict__ base,
                           const float* __restrict__ pos,
                           const float* __restrict__ neg, int npix,
                           int* __restrict__ k_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int c = 0;
  if (i < npix) {
    float b = base[i];
    if (leak != nullptr) b = b - leak[i];
    float pe, ne;
    c = pixel_count(lp[i], b, pos[i], neg[i], &pe, &ne);
  }
  for (int o = 16; o > 0; o >>= 1) c = max(c, __shfl_xor_sync(0xffffffffu, c, o));
  __shared__ int warp_max[32];
  int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = c;
  __syncthreads();
  if (warp == 0) {
    c = lane < (int)(blockDim.x >> 5) ? warp_max[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) c = max(c, __shfl_xor_sync(0xffffffffu, c, o));
    if (lane == 0 && c > 0) atomicMax(k_out, c);
  }
}

__global__ void refr_apply(const float* __restrict__ lp,
                           const float* __restrict__ leak,
                           const uint8_t* __restrict__ shot,
                           const float* __restrict__ pos,
                           const float* __restrict__ neg,
                           float* __restrict__ base, float* __restrict__ mem,
                           const float* __restrict__ dts,
                           const float* __restrict__ t_prevs,
                           const int* __restrict__ k_all, int f, int npix,
                           float R, int16_t* __restrict__ count_out,
                           int16_t* __restrict__ i0_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npix) return;
  float l = lp[i];
  float b = base[i];
  if (leak != nullptr) b = b - leak[i];
  float pth = pos[i];
  float nth = neg[i];
  float pe, ne;
  int count = pixel_count(l, b, pth, nth, &pe, &ne);

  int k_eff = max(k_all[f], 1);
  float t_prev = t_prevs[f];
  float ts_step = fmaxf(dts[f], 1e-12f) / (float)k_eff;
  bool active = R > ts_step;

  float m_old = mem[i];
  float q = ((m_old + R) - t_prev) / ts_step;
  int i0 = (int)fminf(fmaxf(floorf(q), 0.0f), kI32MaxF);
  int m = (int)fminf(floorf(R / ts_step) + 1.0f, kI32MaxF);
  bool has = (count > 0) && (i0 <= count - 1);
  int n_emit = has ? (count - 1 - i0) / max(m, 1) + 1 : 0;
  int i_last = i0 + (n_emit - 1) * m;
  float t_last = mul_add_once((float)i_last + 1.0f, ts_step, t_prev);
  float m_new = n_emit > 0 ? t_last : m_old;
  if (!active) {
    n_emit = count;
    m_new = m_old;
  }
  int i0_keep = (active && has) ? i0 : 0;

  int fpos = pe > 0.0f ? n_emit : 0;
  int fneg = ne > 0.0f ? n_emit : 0;
  b = mul_add_once((float)fpos, pth, b);
  b = mul_add_once(-(float)fneg, nth, b);
  if (shot != nullptr && shot[i] != 0) b = l;

  base[i] = b;
  mem[i] = m_new;
  count_out[i] = (int16_t)(fpos - fneg);
  i0_out[i] = (int16_t)i0_keep;
}

}  // namespace

// Runs the scan over all F frames: 2F launches on `stream`, no sync.
// leak and shot may be null (no leak, no shot noise); base and mem are
// updated in place; k must hold F zeros.  Returns cudaGetLastError().
extern "C" int v2e_refractory_scan(const float* lp, const float* leak,
                                   const uint8_t* shot, const float* pos,
                                   const float* neg, float* base, float* mem,
                                   const float* dts, const float* t_prevs,
                                   int* k, int16_t* counts, int16_t* i0,
                                   int n_frames, int npix, float R,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  const int blocks = (npix + threads - 1) / threads;
  for (int f = 0; f < n_frames; ++f) {
    size_t off = (size_t)f * (size_t)npix;
    const float* leak_f = leak != nullptr ? leak + off : nullptr;
    const uint8_t* shot_f = shot != nullptr ? shot + off : nullptr;
    refr_count<<<blocks, threads, 0, s>>>(lp + off, leak_f, base, pos, neg,
                                          npix, k + f);
    refr_apply<<<blocks, threads, 0, s>>>(lp + off, leak_f, shot_f, pos, neg,
                                          base, mem, dts, t_prevs, k, f, npix,
                                          R, counts + off, i0 + off);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// K2: the emulator's sequential core without the refractory filter, the
// path of every configuration with R <= 0 (the clean and noisy presets).
//
// Replaces v2e_tpu/ops/pallas/emulator_scan.py::emulator_scan_pallas
// (_kernel).  The plain PyTorch version is
// v2e_tpu_torch/ops/kernels/emulator_scan.py::scan_plain.
//
// Per frame f, in order: base -= leak[f]; pos/neg = floor(relu(+-diff)/thr);
// base += pos*pos_thr - neg*neg_thr; base = lp[f] where shot noise fired;
// counts[f] = pos - neg.
//
// Design.  No pixel depends on another, so one launch covers the chunk:
// one thread per pixel loops over the F frames with base in a register
// (scan_kernel above).  The TPU kernel cut F into segments of 128 frames
// to bound its VMEM blocks; a thread here holds one frame's values at a
// time, so there is no segmenting and the counts are those of one pass.
// Reads of frame f are coalesced across the threads of a warp.
//
// Bound on the card: it streams lp and leak (f32) and the shot mask (u8) in
// and writes counts (i16): 11 bytes per pixel per frame, plus base and the
// thresholds once; some 15 operations per pixel and frame.  So it is bound
// by memory bytes.
//
// Rounding: as K1, built with --fmad=false, and the base update is one
// float64 multiply-add rounded once per term (the reference's XLA program
// contracts it into an FMA); at most one of pos and neg is non-zero.
//
// base is updated in place; leak and shot may be null.  One launch on
// `stream`, no sync.  Returns cudaGetLastError().
extern "C" int v2e_scan(const float* lp, const float* leak, const uint8_t* shot,
                        const float* pos, const float* neg, float* base,
                        int16_t* counts, int n_frames, int npix, void* stream) {
  if (npix == 0 || n_frames == 0) return 0;
  const int threads = 256;
  const int blocks = (npix + threads - 1) / threads;
  scan_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      lp, leak, shot, pos, neg, base, n_frames, npix, counts);
  return (int)cudaGetLastError();
}
