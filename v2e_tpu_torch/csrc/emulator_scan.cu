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
// Design.  K[f] couples every pixel of frame f; the TPU kernel kept the
// plane on chip across the F frames and reduced K inside the kernel.  Here
// one persistent kernel does the same for the whole chunk: ONE cooperative
// launch (cudaLaunchCooperativeKernel) whose grid is at most what the
// occupancy API says can be resident at once, so every block runs
// concurrently and the grid barrier cannot deadlock.  Each thread owns a
// fixed, grid-strided set of pixels.  Per frame:
//   1. leak and count for its pixels; warp max, block max;
//   2. a grid barrier that carries the maximum (grid_max): each block
//      publishes (frame tag, block max) in one 64-bit atomic exchange to
//      its own slot, and warp 0 of every block polls all slots until they
//      carry this frame's tag, then takes their max, K[f], and computes
//      the frame's filter constants for its block;
//   3. the filter, the base update and the counts and i0 stores.
// The loads of frame f+1 (lp, leak, shot) go out during the barrier.
// Why these choices (each measured faster on an H100 80GB HBM3 at
// chip_smoke.py's [k1] shape, 260x346):
//   - the slots need one atomic and the polls; cooperative_groups'
//     grid.sync() with an atomicMax into K[f] and a read of it after the
//     barrier took 5.2 us per frame (two fences, three dependent L2 round
//     trips);
//   - the slot is written with an atomic: a plain store waited in the SM;
//   - one block per SM sized to the plane (132 x 704 threads): the barrier
//     waits for the slowest SM, and two blocks on one SM make it slow;
//   - counts without dividing zero (pixel_count_k1), the filter constants
//     once per block, and one float64 multiply-add per base update keep
//     the frame's dependent chain short.
// State: when one block per SM holds one pixel per thread (planes up to
// 132 x 1024 pixels on an H100; 260x346 is one), base, spike-time memory,
// thresholds, and the frame's lp and count stay in registers for all F
// frames (refr_persistent<true>).  A larger plane (720x1280) keeps base
// and memory in global memory, which the working set of a frame (a few
// bytes per pixel) leaves in the 50 MB L2 (refr_persistent<false>; its
// apply phase re-reads lp from L2, not from device memory).
// Either way lp, leak and shot are read once per pixel-frame from device
// memory, and counts and i0 written once.
//
// Bound on the card: 13 bytes per pixel per frame (lp and leak f32, shot
// u8, counts and i0 i16) plus the state planes once; some 40 operations
// per pixel and frame, far below the card's rate.  So the bytes bound it,
// but at 260x346 a frame is 1.2 MB, 0.35 us at 3.35 TB/s, and the frame's
// grid barrier (an atomic and a poll across SMs, through L2) costs more:
// the kernel is bound by the latency of F barriers, not by bytes.
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
constexpr int kRefrMaxThreads = 1024;
constexpr int kMaxSlotsPerLane = 16;  // grids of up to 512 blocks
constexpr int kMaxBlocks = 32 * kMaxSlotsPerLane;

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

// pixel_count for K1, where a frame's latency is its cost: the same counts
// without dividing zero (the IEEE division takes its slow path on a zero
// numerator, and one of the two numerators is always zero).  pe and ne
// only feed comparisons with 0 and conversions to int, where the sign of
// a zero does not matter.
__device__ __forceinline__ int pixel_count_k1(float lp, float base, float pos,
                                              float neg, float* pe, float* ne) {
  const float diff = lp - base;
  *pe = diff > 0.0f ? floorf(diff / pos) : 0.0f;
  *ne = diff < 0.0f ? floorf(-diff / neg) : 0.0f;
  return (int)(*pe + *ne);
}

// The frame's filter constants, from K[f] (identical in every thread).
struct FrameFilter {
  float t_prev, ts_step, R;
  bool active;
  int m;
};

__device__ __forceinline__ FrameFilter frame_filter(int k, float dt,
                                                    float t_prev, float R) {
  FrameFilter ff;
  ff.t_prev = t_prev;
  ff.ts_step = fmaxf(dt, 1e-12f) / (float)max(k, 1);
  ff.R = R;
  ff.active = R > ff.ts_step;
  ff.m = (int)fminf(floorf(R / ff.ts_step) + 1.0f, kI32MaxF);
  return ff;
}

// The filter and the base update of one pixel: updates b and m_mem, returns
// the signed count and writes the kept first index to *i0_keep.
__device__ __forceinline__ int apply_pixel(const FrameFilter& ff, int count,
                                           float pe, float ne, float l,
                                           float pth, float nth, bool shot,
                                           float* b, float* m_mem,
                                           int* i0_keep) {
  const float m_old = *m_mem;
  float q = ((m_old + ff.R) - ff.t_prev) / ff.ts_step;
  int i0 = (int)fminf(fmaxf(floorf(q), 0.0f), kI32MaxF);
  bool has = (count > 0) && (i0 <= count - 1);
  int n_emit = has ? (count - 1 - i0) / max(ff.m, 1) + 1 : 0;
  int i_last = i0 + (n_emit - 1) * ff.m;
  float t_last = mul_add_once((float)i_last + 1.0f, ff.ts_step, ff.t_prev);
  float m_new = n_emit > 0 ? t_last : m_old;
  if (!ff.active) {
    n_emit = count;
    m_new = m_old;
  }
  *i0_keep = (ff.active && has) ? i0 : 0;
  int fpos = pe > 0.0f ? n_emit : 0;
  int fneg = ne > 0.0f ? n_emit : 0;
  // the reference's two multiply-adds, base += fpos*pth then base -=
  // fneg*nth; at most one term is non-zero (pe and ne exclude each other),
  // and a zero term only adds +0 (which turns -0 into +0) or -0 (which
  // changes nothing), so one multiply-add on one dependent path is exact
  float bb;
  if (fpos != 0)
    bb = mul_add_once((float)fpos, pth, *b);
  else if (fneg != 0)
    bb = mul_add_once(-(float)fneg, nth, *b + 0.0f);
  else
    bb = *b + 0.0f;
  *b = shot ? l : bb;
  *m_mem = m_new;
  return fpos - fneg;
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// The grid barrier of frame f, which also reduces the frame's largest
// count: every block publishes (f + 1, its max) as ONE 64-bit atomic
// exchange into its slot of the frame's parity, then warp 0 polls all
// blocks' slots until each carries the tag f + 1, and takes the max of
// their values.  Tag and value travel in one single-copy-atomic word, so no
// fence is needed; the parity keeps a block that is one frame ahead from
// overwriting a slot that a slower block still reads (it cannot get two
// frames ahead: frame f + 1's barrier waits for every block's f + 1 slot,
// written after that block has read frame f's slots).  Between the publish
// and the poll every thread runs `prefetch` (the next frame's loads).
// Block 0 writes K[f].  Returns the frame's filter constants, computed from
// K[f] once per block, to every thread.
template <class Prefetch>
__device__ __forceinline__ FrameFilter grid_max(int c, int f,
                                                unsigned long long* slots, int* k_out,
                                                int* warp_max, float dt, float tp,
                                                float R, FrameFilter* ff_shared,
                                                Prefetch prefetch) {
  c = __reduce_max_sync(0xffffffffu, c);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = c;
  __syncthreads();
  unsigned long long* par = slots + (size_t)(f & 1) * gridDim.x;
  const unsigned long long tag = (unsigned long long)(f + 1) << 32;
  if (warp == 0) {
    c = lane < (int)(blockDim.x >> 5) ? warp_max[lane] : 0;
    c = __reduce_max_sync(0xffffffffu, c);
    // an atomic is performed at L2 at once; a plain store may wait in the
    // SM before it is written through (on an H100 the barrier measured
    // slower with st.relaxed.gpu)
    if (lane == 0) atomicExch(par + blockIdx.x, tag | (unsigned)c);
  }
  // the loads of the next frame go out while the grid gathers
  prefetch();
  if (warp == 0) {
    // every lane loads all its slots before looking at any: one L2 round
    // trip per poll
    int k = 0;
    bool done = false;
    while (!done) {
      unsigned long long v[kMaxSlotsPerLane];
#pragma unroll
      for (int r = 0; r < kMaxSlotsPerLane; ++r) {
        const int j = lane + 32 * r;
        v[r] = j < (int)gridDim.x ? ld_relaxed(par + j) : tag;
      }
      done = true;
      k = 0;
#pragma unroll
      for (int r = 0; r < kMaxSlotsPerLane; ++r) {
        done = done && (v[r] & 0xffffffff00000000ull) == tag;
        k = max(k, (int)(unsigned)(v[r] & 0xffffffffull));
      }
      done = __all_sync(0xffffffffu, done);
    }
    k = __reduce_max_sync(0xffffffffu, k);
    if (lane == 0) {
      *ff_shared = frame_filter(k, dt, tp, R);
      if (blockIdx.x == 0) k_out[f] = k;
    }
  }
  __syncthreads();
  return *ff_shared;
}

// K1, one cooperative launch per chunk.  kRegs: one pixel per thread
// (tid < npix), its state in registers; otherwise any number of pixels per
// thread, grid-strided, with base and memory kept in global memory (in
// base and mem).  slots: 2 x gridDim.x zeroed words, written and polled
// across blocks (gpu-scope accesses, never through the non-coherent cache).
template <bool kRegs>
__global__ void __launch_bounds__(kRefrMaxThreads)
refr_persistent(const float* __restrict__ lp, const float* __restrict__ leak,
                const uint8_t* __restrict__ shot,
                const float* __restrict__ pos, const float* __restrict__ neg,
                float* __restrict__ base, float* __restrict__ mem,
                const float* __restrict__ dts,
                const float* __restrict__ t_prevs, int* __restrict__ k_all,
                unsigned long long* slots, int n_frames, int npix, float R,
                int16_t* __restrict__ count_out, int16_t* __restrict__ i0_out) {
  __shared__ int warp_max[kRefrMaxThreads / 32];
  __shared__ FrameFilter ff_shared;
  const int nthr = gridDim.x * blockDim.x;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;

  if constexpr (kRegs) {
    const bool own = tid < npix;
    const int i = own ? tid : 0;
    float b = 0.0f, mm = 0.0f, pth = 0.0f, nth = 0.0f, ln = 0.0f, lk = 0.0f;
    uint8_t shn = 0;  // the raw byte: no wait for the load until the apply
    if (own) {
      b = base[i];
      mm = mem[i];
      pth = pos[i];
      nth = neg[i];
      ln = lp[i];
      if (leak != nullptr) lk = leak[i];
      if (shot != nullptr) shn = shot[i];
    }
    float dt_n = dts[0], tp_n = t_prevs[0];
    for (int f = 0; f < n_frames; ++f) {
      const size_t off = (size_t)f * (size_t)npix;
      const float l = ln;
      float pe = 0.0f, ne = 0.0f;
      int cnt = 0;
      if (own) {
        if (leak != nullptr) b = b - lk;
        cnt = pixel_count_k1(l, b, pth, nth, &pe, &ne);
      }
      const uint8_t sh = shn;
      const float dt = dt_n, tp = tp_n;
      // the next frame's inputs load while the grid gathers
      const FrameFilter ff =
          grid_max(cnt, f, slots, k_all, warp_max, dt, tp, R, &ff_shared, [&]() {
            if (f + 1 < n_frames) {
              dt_n = dts[f + 1];
              tp_n = t_prevs[f + 1];
              if (own) {
                ln = lp[off + npix + i];
                if (leak != nullptr) lk = leak[off + npix + i];
                if (shot != nullptr) shn = shot[off + npix + i];
              }
            }
          });
      if (own) {
        int i0;
        const int c = apply_pixel(ff, cnt, pe, ne, l, pth, nth, sh != 0, &b, &mm, &i0);
        count_out[off + i] = (int16_t)c;
        i0_out[off + i] = (int16_t)i0;
      }
    }
    if (own) {
      base[i] = b;
      mem[i] = mm;
    }
  } else {
    for (int f = 0; f < n_frames; ++f) {
      const size_t off = (size_t)f * (size_t)npix;
      int cmax = 0;
      for (int i = tid; i < npix; i += nthr) {
        float bb = base[i];
        if (leak != nullptr) {
          bb = bb - leak[off + i];
          base[i] = bb;  // after the leak: the apply phase starts here
        }
        float pe, ne;
        cmax = max(cmax, pixel_count_k1(lp[off + i], bb, pos[i], neg[i], &pe, &ne));
      }
      const FrameFilter ff = grid_max(cmax, f, slots, k_all, warp_max, dts[f], t_prevs[f],
                                      R, &ff_shared, [] {});
      for (int i = tid; i < npix; i += nthr) {
        const float l = lp[off + i];
        const float pth = pos[i], nth = neg[i];
        float bb = base[i], mm = mem[i];
        float pe, ne;
        const int cnt = pixel_count_k1(l, bb, pth, nth, &pe, &ne);
        const bool sh = shot != nullptr && shot[off + i] != 0;
        int i0;
        const int c = apply_pixel(ff, cnt, pe, ne, l, pth, nth, sh, &bb, &mm, &i0);
        base[i] = bb;
        mem[i] = mm;
        count_out[off + i] = (int16_t)c;
        i0_out[off + i] = (int16_t)i0;
      }
    }
  }
}

typedef void (*RefrKernel)(const float*, const float*, const uint8_t*,
                           const float*, const float*, float*, float*,
                           const float*, const float*, int*,
                           unsigned long long*, int, int, float, int16_t*,
                           int16_t*);

// The form and grid K1 takes for npix pixels on the current device.  The
// register form while one block per SM holds one pixel per thread: blocks
// = SMs (fewer on small planes), so every SM carries the same share of the
// plane and no block lags at the barrier, and threads per block just
// enough for the pixels.  A larger plane takes the global-state form on
// every resident block.
cudaError_t refr_config(int npix, RefrKernel* kern, int* blocks, int* threads,
                        int* regpix) {
  int dev = 0, sms = 0, coop = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorCooperativeLaunchTooLarge;
  const bool regs = (long long)npix <= (long long)sms * kRefrMaxThreads;
  *kern = regs ? refr_persistent<true> : refr_persistent<false>;
  *regpix = regs ? 1 : 0;
  if (regs) {
    const int warps = (npix + 31) / 32;
    *blocks = warps < sms ? warps : sms;
    const int per_block = (npix + *blocks - 1) / *blocks;
    *threads = (per_block + 31) / 32 * 32;
  } else {
    *threads = kRefrMaxThreads;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, *kern, *threads, 0);
  if (e != cudaSuccess) return e;
  long long resident = (long long)occ * sms;
  if (resident > kMaxBlocks) resident = kMaxBlocks;
  if (!regs) *blocks = (int)resident;
  if (*blocks < 1 || *blocks > resident) return cudaErrorCooperativeLaunchTooLarge;
  return cudaSuccess;
}

}  // namespace

// The grid v2e_refractory_scan launches for npix pixels on the current
// device: blocks, threads per block, and the pixels per thread held in
// registers (0: the global-state form).  Returns a CUDA error code.
extern "C" int v2e_refractory_scan_grid(int npix, int* blocks, int* threads,
                                        int* regpix) {
  RefrKernel kern;
  return (int)refr_config(npix > 0 ? npix : 1, &kern, blocks, threads, regpix);
}

// Runs the scan over all F frames: one cooperative launch on `stream`, no
// sync.  leak and shot may be null (no leak, no shot noise); base and mem
// are updated in place.  k receives K[F]; it must hold F ints, then (from
// index F rounded up to even) 4 x blocks zeros, the grid barrier's slots,
// blocks as v2e_refractory_scan_grid gives it.  Returns the launch's error
// (a grid the runtime refuses is an error, never a fallback).
extern "C" int v2e_refractory_scan(const float* lp, const float* leak,
                                   const uint8_t* shot, const float* pos,
                                   const float* neg, float* base, float* mem,
                                   const float* dts, const float* t_prevs,
                                   int* k, int16_t* counts, int16_t* i0,
                                   int n_frames, int npix, float R,
                                   void* stream) {
  if (npix == 0 || n_frames == 0) return 0;
  RefrKernel kern;
  int blocks = 0, threads = 0, regpix = 0;
  cudaError_t e = refr_config(npix, &kern, &blocks, &threads, &regpix);
  if (e != cudaSuccess) return (int)e;
  unsigned long long* slots = (unsigned long long*)(k + ((n_frames + 1) & ~1));
  void* args[] = {&lp,      &leak, &shot,  &pos,     &neg,  &base,
                  &mem,     &dts,  &t_prevs, &k,     &slots, &n_frames,
                  &npix,    &R,    &counts, &i0};
  e = cudaLaunchCooperativeKernel((const void*)kern, dim3(blocks),
                                  dim3(threads), args, 0,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
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
