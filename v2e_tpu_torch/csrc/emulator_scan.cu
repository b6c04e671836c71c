// The DVS emulator's sequential core, one chunk of F frames over an H*W
// pixel plane: K1 with the closed-form refractory filter, K1 on pixel strips
// (refr_strips, after K1), and K2 without the filter (at the end of this
// file).
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

// The ON and OFF counts of K1, where a frame's latency is its cost:
// floor(relu(+-diff)/thr) without dividing zero (the IEEE division takes
// its slow path on a zero numerator, and one of the two numerators is
// always zero).  pe and ne
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



// K1 on pixel strips (v2e_tpu_torch/parallel/mesh.py): refr_strips, ONE
// cooperative launch per strip and chunk, each frame's K exchanged across
// the strips in memory.  It replaces K1's two halves (the former refr_count
// and refr_apply: F + 1 launches per strip, and the host taking each
// frame's maximum over the strips between them).  The TPU counterpart is
// v2e_tpu/ops/pallas/emulator_scan.py:247 (emulator_scan_refractory_pallas),
// which the JAX package does not run under a mesh: there XLA runs the scan
// and turns each frame's maximum into an all-reduce
// (v2e_tpu/parallel/mesh.py:84-86).  The plain version is
// v2e_tpu_torch/ops/kernels/emulator_scan.py::refractory_scan_strips_plain.
//
// What it computes: K1 on the strip's rows with K[f] the largest count over
// EVERY strip's pixels, so the strips together equal K1 on the whole plane
// bit for bit.  The per-pixel code is K1's own (pixel_count_k1,
// frame_filter, apply_pixel, mul_add_once, --fmad=false), and so are its
// two state forms (registers when each block of the strip's share of the
// SMs holds one pixel per thread, global memory otherwise).
//
// Per frame f, with tag = tag0 + f + 1 (tag0 is the wrapper's counter,
// unique over all calls, so no slot is ever cleared between chunks):
//   1. every block of the strip publishes (tag | block max) to its slot of
//      the strip's barrier in device memory (one atomic, as in K1);
//   2. warp 0 of block 0 polls those slots (gpu scope), takes the strip's
//      max and stores (tag | max) into the strip's slot of the exchange;
//   3. it polls the exchange's S slots of the frame's parity until each
//      carries the tag, takes their max, K[f], and republishes (tag | K[f])
//      into the strip's K slot in device memory;
//   4. warp 0 of every other block polls the K slot (gpu scope); then each
//      block applies the filter as K1 does.
// The exchange is mapped pinned host memory, which every card of the mesh
// reaches, accessed at system scope (st/ld.relaxed.sys); the wrapper
// allocates it and fixes it in code, for one card and for several.
// Why these choices:
//   - one launch per strip and chunk, no host in the loop: the halves'
//     2 launches and host round trip per frame and strip cost ~36 us on an
//     H100, where K1's barrier costs ~3 us;
//   - only one warp per strip reads system memory (a read crosses PCIe);
//     the other blocks wait on device memory for block 0's K;
//   - one memory and one scope whether the strips share a card or not, so
//     one card runs exactly the code that several cards run;
//   - the exchange's parity keeps a strip one frame ahead from overwriting
//     a word another strip has not read yet (it cannot get two ahead:
//     frame f + 1 waits for every strip's f + 1 word, written after that
//     strip read frame f's); the block slots and the K slot need none, as a
//     block publishes frame f + 1 only after reading K[f], and block 0
//     writes K[f] only after reading every block's frame-f slot.
// Waiting is bounded: every poll loop reads %globaltimer and gives up after
// timeout_ns (the other blocks after twice that, so block 0 decides
// first).  Block 0 then writes an error word (code, strip, frame) into the
// exchange and an abort tag into its K slot, the strip's blocks leave, and
// the wrapper raises after the launch.  A strip that never arrives (a
// failed launch, grids that cannot co-reside) is an error within the
// limit, never a hang.
//
// Bound on the card: K1's 13 bytes per pixel-frame, and the latency of F
// two-level barriers: to K1's barrier a frame adds the hop to block 0 and
// back and a round trip through system memory (a write and a read across
// PCIe, microseconds), against 0.35 us of bytes per frame at 260x346.

namespace {

constexpr unsigned long long kTagMask = 0xffffffff00000000ull;
constexpr unsigned long long kAbortTag = kTagMask;  // above every frame's tag
constexpr int kMaxStrips = 32;  // one exchange slot per lane of a warp

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned long long ld_relaxed_sys(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.sys.global.b64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed_sys(unsigned long long* p,
                                               unsigned long long v) {
  asm volatile("st.relaxed.sys.global.b64 [%0], %1;\n" : : "l"(p), "l"(v) : "memory");
}

// Warp-wide: polls n tagged slots until every one carries `tag` (system
// scope with kSys, else gpu scope); true with their largest value in *k,
// false once timeout_ns have passed.  Each lane loads all its slots before
// looking at any.
template <int kPerLane, bool kSys>
__device__ __forceinline__ bool poll_max(const unsigned long long* p, int n,
                                         unsigned long long tag,
                                         unsigned long long timeout_ns, int* k) {
  const int lane = threadIdx.x & 31;
  const unsigned long long t0 = global_ns();
  while (true) {
    unsigned long long v[kPerLane];
#pragma unroll
    for (int r = 0; r < kPerLane; ++r) {
      const int j = lane + 32 * r;
      v[r] = j < n ? (kSys ? ld_relaxed_sys(p + j) : ld_relaxed(p + j)) : tag;
    }
    bool done = true;
    int m = 0;
#pragma unroll
    for (int r = 0; r < kPerLane; ++r) {
      done = done && (v[r] & kTagMask) == tag;
      m = max(m, (int)(unsigned)(v[r] & 0xffffffffull));
    }
    if (__all_sync(0xffffffffu, done)) {
      *k = __reduce_max_sync(0xffffffffu, m);
      return true;
    }
    // lane 0's clock decides for the warp
    if (__shfl_sync(0xffffffffu, (int)(global_ns() - t0 > timeout_ns), 0)) return false;
  }
}

struct StripArgs {
  unsigned long long* slots;  // gridDim.x block slots, then the K slot
  unsigned long long* xchg;   // 2 x n_strips exchange slots, then the error word
  int strip, n_strips;
  unsigned tag0;
  unsigned long long timeout_ns;
};

// The error word: what timed out (1: a block of the strip, 2: a strip at
// the exchange, 3: block 0's K), the strip and the frame.
__device__ __forceinline__ void strips_error(const StripArgs a, int code, int f) {
  st_relaxed_sys(a.xchg + 2 * a.n_strips,
                 ((unsigned long long)code << 56) |
                     ((unsigned long long)a.strip << 32) | (unsigned)f);
}

// The two-level barrier of frame f (see the note above), which reduces K[f]
// over every strip: writes the frame's filter constants to *ff and returns
// true, or returns false (in every thread of the block) when a wait timed
// out or another block aborted.  Between the publish and the poll every
// thread runs `prefetch`.
template <class Prefetch>
__device__ __forceinline__ bool strips_max(int c, int f, const StripArgs a,
                                           int* k_out, int* warp_max, float dt,
                                           float tp, float R, FrameFilter* ff,
                                           FrameFilter* ff_shared, int* ok_shared,
                                           Prefetch prefetch) {
  c = __reduce_max_sync(0xffffffffu, c);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = c;
  __syncthreads();
  const unsigned long long tag = (unsigned long long)(a.tag0 + (unsigned)f + 1u) << 32;
  unsigned long long* kslot = a.slots + gridDim.x;
  if (warp == 0) {
    c = lane < (int)(blockDim.x >> 5) ? warp_max[lane] : 0;
    c = __reduce_max_sync(0xffffffffu, c);
    if (lane == 0) atomicExch(a.slots + blockIdx.x, tag | (unsigned)c);
  }
  prefetch();
  if (warp == 0) {
    int k = 0, code = 0;
    bool ok = true;
    if (blockIdx.x == 0) {
      unsigned long long* x = a.xchg + (size_t)(f & 1) * a.n_strips;
      if (!poll_max<kMaxSlotsPerLane, false>(a.slots, gridDim.x, tag, a.timeout_ns, &k)) {
        code = 1;
      } else {
        if (lane == 0) st_relaxed_sys(x + a.strip, tag | (unsigned)k);
        if (!poll_max<1, true>(x, a.n_strips, tag, a.timeout_ns, &k)) code = 2;
      }
      ok = code == 0;
      if (lane == 0) atomicExch(kslot, ok ? tag | (unsigned)k : kAbortTag);
    } else if (lane == 0) {
      const unsigned long long t0 = global_ns();
      while (true) {
        const unsigned long long v = ld_relaxed(kslot);
        if ((v & kTagMask) == tag) {
          k = (int)(unsigned)(v & 0xffffffffull);
          break;
        }
        if ((v & kTagMask) == kAbortTag) {
          ok = false;
          break;
        }
        if (global_ns() - t0 > 2 * a.timeout_ns) {
          ok = false;
          code = 3;
          break;
        }
      }
    }
    if (lane == 0) {
      if (code) strips_error(a, code, f);
      *ok_shared = ok;
      if (ok) {
        *ff_shared = frame_filter(k, dt, tp, R);
        if (blockIdx.x == 0) k_out[f] = k;
      }
    }
  }
  __syncthreads();
  *ff = *ff_shared;
  return *ok_shared != 0;
}

// One strip of K1 on strips, one cooperative launch per chunk: K1's
// refr_persistent with strips_max for its grid barrier (and leaving the
// frame loop when a wait timed out).
template <bool kRegs>
__global__ void __launch_bounds__(kRefrMaxThreads)
refr_strips(const float* __restrict__ lp, const float* __restrict__ leak,
            const uint8_t* __restrict__ shot, const float* __restrict__ pos,
            const float* __restrict__ neg, float* __restrict__ base,
            float* __restrict__ mem, const float* __restrict__ dts,
            const float* __restrict__ t_prevs, int* __restrict__ k_all,
            StripArgs sa, int n_frames, int npix, float R,
            int16_t* __restrict__ count_out, int16_t* __restrict__ i0_out) {
  __shared__ int warp_max[kRefrMaxThreads / 32];
  __shared__ FrameFilter ff_shared;
  __shared__ int ok_shared;
  const int nthr = gridDim.x * blockDim.x;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;

  if constexpr (kRegs) {
    const bool own = tid < npix;
    const int i = own ? tid : 0;
    float b = 0.0f, mm = 0.0f, pth = 0.0f, nth = 0.0f, ln = 0.0f, lk = 0.0f;
    uint8_t shn = 0;
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
      FrameFilter ff;
      if (!strips_max(cnt, f, sa, k_all, warp_max, dt, tp, R, &ff, &ff_shared, &ok_shared,
                      [&]() {
                        if (f + 1 < n_frames) {
                          dt_n = dts[f + 1];
                          tp_n = t_prevs[f + 1];
                          if (own) {
                            ln = lp[off + npix + i];
                            if (leak != nullptr) lk = leak[off + npix + i];
                            if (shot != nullptr) shn = shot[off + npix + i];
                          }
                        }
                      }))
        break;
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
          base[i] = bb;
        }
        float pe, ne;
        cmax = max(cmax, pixel_count_k1(lp[off + i], bb, pos[i], neg[i], &pe, &ne));
      }
      FrameFilter ff;
      if (!strips_max(cmax, f, sa, k_all, warp_max, dts[f], t_prevs[f], R, &ff, &ff_shared,
                      &ok_shared, [] {}))
        break;
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

}  // namespace

// Blocks per SM of refr_strips (the register form when regs != 0) at
// `threads` threads per block, on the current device.  Returns a CUDA
// error code.
extern "C" int v2e_refractory_strips_occupancy(int regs, int threads, int* blocks_per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, regs ? refr_strips<true> : refr_strips<false>, threads, 0);
}

// The current device's address of pinned host memory (cudaHostGetDevicePointer).
extern "C" int v2e_host_device_ptr(void* host, void** dev) {
  return (int)cudaHostGetDevicePointer(dev, host, 0);
}

// One strip's launch of K1 on strips, on `stream`, no sync: a cooperative
// grid of `blocks` x `threads` in the register form (regs != 0: one pixel
// per thread) or the global-state form, as the wrapper's plan gives it.
// leak and shot may be null; base and mem are updated in place.  k: F ints,
// then (from index F rounded up to even) 2 x (blocks + 1) zeroed ints, the
// strip's barrier slots.  xchg: this device's address of the exchange,
// 2 x n_strips + 1 64-bit words in mapped pinned host memory, the error word
// last, zero before the call.  tag0 + F + 1 must stay below 2^32 - 1.
// Returns the launch's CUDA error (an invalid grid is an error).
extern "C" int v2e_refractory_scan_strips(
    const float* lp, const float* leak, const uint8_t* shot, const float* pos,
    const float* neg, float* base, float* mem, const float* dts,
    const float* t_prevs, int* k, int16_t* counts, int16_t* i0,
    unsigned long long* xchg, int strip, int n_strips, unsigned int tag0,
    long long timeout_ns, int n_frames, int npix, float R, int blocks,
    int threads, int regs, void* stream) {
  if (n_frames <= 0 || npix <= 0 || blocks < 1 || blocks > kMaxBlocks || threads < 32 ||
      threads > kRefrMaxThreads || threads % 32 != 0 || n_strips < 1 ||
      n_strips > kMaxStrips || strip < 0 || strip >= n_strips || timeout_ns <= 0 ||
      (unsigned long long)tag0 + (unsigned)n_frames + 1ull >= 0xffffffffull ||
      (regs && (long long)blocks * threads < npix))
    return (int)cudaErrorInvalidValue;
  StripArgs sa;
  sa.slots = (unsigned long long*)(k + ((n_frames + 1) & ~1));
  sa.xchg = xchg;
  sa.strip = strip;
  sa.n_strips = n_strips;
  sa.tag0 = tag0;
  sa.timeout_ns = (unsigned long long)timeout_ns;
  void* args[] = {&lp,  &leak, &shot, &pos, &neg, &base,   &mem,    &dts,
                  &t_prevs, &k, &sa, &n_frames, &npix, &R, &counts, &i0};
  cudaError_t e = cudaLaunchCooperativeKernel(
      regs ? (const void*)refr_strips<true> : (const void*)refr_strips<false>,
      dim3(blocks), dim3(threads), args, 0, (cudaStream_t)stream);
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
// Bound on the card: it streams lp and leak (f32) and the shot mask (u8) in
// and writes counts (i16), 11 bytes per pixel per frame, plus base (in and
// out) and the thresholds once; some 15 operations per pixel and frame.  So
// bytes bound it: 0.0288 ms for 96 frames of 260x346 at 3.35 TB/s, 0.295 ms
// for 96 frames of 720x1280.
//
// Design.  No pixel depends on another; each pixel's frames depend on the
// one before through base.  A thread per pixel that loads each frame when
// it reaches it waits one DRAM round trip per frame, so latency, not bytes,
// sets the time (the first port: 0.10 ms at 260x346, F=96).  Hence:
//   - one persistent block per SM.  The plane is cut into strips of whole
//     16-pixel units, one per block, their sizes differing by at most one
//     unit, so every SM carries the same share; a strip of more than
//     kScanMaxTile pixels (720x1280) is walked in tiles of equal size, the
//     whole F loop per tile.  Each consumer thread owns one pixel of the
//     tile and keeps its base and thresholds in registers for all F frames;
//     the next tile's are loaded meanwhile.
//   - the loads run ahead in a ring of kScanRing stages in dynamic shared
//     memory.  A stage holds kScanGroup frames of one tile (lp, leak and
//     shot, each present stream in its own region).  One producer thread,
//     alone in the last warp, fills the ring with cp.async.bulk copies (1-D
//     TMA) that complete on the stage's full mbarrier; the consumer warps
//     wait on it, compute its frames, and release it on its empty mbarrier.
//     The ring runs on across tiles, so one tile's first frames load while
//     the last one ends.
//   - a short per-frame chain (scan_step): one division, only where the
//     quotient reaches 1, and one float64 FMA for the base update.
// The plan.  ops/kernels/emulator_scan.py::scan_plan decides, for the
// plane, the frame count and each stream's data pointer mod 16, everything
// that says which bytes a copy moves: the tiles of each block, each tile's
// interior frames (those whose slices lie, in every stream, inside the
// tensor's aligned interior), and per stream its pointer's offset in its
// granule, the offset's step per frame, the aligned interior in bytes and
// the elements inside it.  The launch takes the plan as a parameter (the
// tile table in device memory); the kernel keeps only copy_range (the
// slice's granules, clipped to the interior outside the interior frames)
// and the running offsets, which tests/test_torch_scan_plan.py models on
// the CPU beside the plan.
// What the H100 showed (the numbers are in PERF.md): once the loads run
// ahead, the consumers' instructions bound the kernel at 260x346 (22 warps
// per SM), not the loads.  Rings of 8 to 64 frames took the same time, and
// loading the next frame into registers before computing this one was
// slower.  What helped was fewer instructions per pixel-frame (one division
// and one multiply-add path instead of one per sign, the thresholds in
// float64 once per tile, the interior test once per frame from the plan,
// incremental offsets) and one barrier wait and release per 4 frames (4
// over 1, 2 and 8).  Two or four pixels per thread (fewer warps) were
// slower at 260x346; at 720x1280 two matched what the final kernel reaches
// with one, near the card's byte rate.  The bulk copies are not weighed
// against per-thread cp.async: they take no instructions from the
// consumers, whose issue rate is the bound.
// Alignment.  A bulk copy needs 16-byte-aligned addresses and a size that
// is a multiple of 16, and a frame's slice of a stream rarely has either
// (the u8 shot frame of 260x346 is 89,960 B, 8 mod 16; a view can start at
// any element).  Tiles start at multiples of 16 pixels, so every tile's
// slice of frame 0 starts at the stream's pointer offset in its granule.
// Each copy takes the whole 16-byte granules that hold the tile's slice, so
// the stage mirrors their layout and the consumer reads element c at byte
// offset + 4c (or + c) of the stream's region.  Neighbouring tiles both copy
// the granule they share.  Only granules that reach outside the tensor (its
// first and last, when its ends are not aligned) are left out; their
// elements are read from global memory, never past the tensor's ends.
// The mbarrier phases: stage s of pass n is waited full with parity n & 1
// and empty with parity (n & 1) ^ 1 (the first pass finds it free), over
// one running count of stages shared by producer and consumers (each
// tile's F frames in groups, the last group maybe short), so a ring
// deeper than F frames, or F = 1, waits on no phase that never completes.
// The producer raises the stage's byte count before each frame's copies
// and arrives once, after all of them.
// Rounding: as K1, built with --fmad=false; the base update is one float64
// multiply-add rounded once to float32 (the reference's XLA program
// contracts it into an FMA); at most one of pos and neg is non-zero.

constexpr int kScanMaxBlocks = 512;
constexpr int kScanStreams = 3;  // lp, leak, shot

// The launch plan (ops/kernels/emulator_scan.py::scan_plan; its ctypes twin
// is _CPlan there), outside the unnamed namespace: v2e_scan takes it and
// must keep external linkage.  Per stream s (-1 / 0 where absent):
// region[s], its byte offset in a frame's part of a stage; offset[s], its
// data pointer mod 16; step[s], how far a slice's offset in its granule
// moves per frame; [lo[s], hi[s]), the tensor's aligned interior in bytes
// from the pointer's granule; [first[s], end[s]), the elements wholly
// inside it.  Block b runs tiles block_tiles[b] to block_tiles[b + 1] - 1
// of the tile table (t0, t1, f_lo, f_hi: pixels [t0, t1), interior frames
// [f_lo, f_hi]).  A stage is kScanGroup frames of frame_bytes.
struct ScanPlan {
  long long lo[kScanStreams], hi[kScanStreams], first[kScanStreams], end[kScanStreams];
  int npix, n_frames, blocks, threads, tile, frame_bytes, smem_bytes;
  int region[kScanStreams], offset[kScanStreams], step[kScanStreams];
  int block_tiles[kScanMaxBlocks + 1];
};

namespace {

constexpr int kScanMaxTile = 992;  // consumer threads; + the producer warp: 1024
constexpr int kScanGroup = 4;      // frames per stage
constexpr int kScanRing = 6;       // stages
constexpr int kScanBarBytes = 128;  // the 2 x kScanRing mbarriers, padded

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Raises the bytes the barrier's current phase waits for (no arrival).
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, uintptr_t src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// One stream's copy for one frame of a tile, in bytes from the stream's
// granule: the 16-byte granules that hold the slice [r, r + n), clipped to
// the tensor's aligned interior [lo, hi) unless the plan marks the frame
// interior; dst is the copy's offset in the stream's region.  Modelled in
// tests/test_torch_scan_plan.py::copy_range.
struct Bulk {
  long long src;
  uint32_t size, dst;
};

__device__ __forceinline__ Bulk copy_range(long long r, int n, bool interior, long long lo,
                                           long long hi) {
  const long long g = r & ~15ll;
  long long src = g, end = (r + n + 15) & ~15ll;
  if (!interior) {
    src = src > lo ? src : lo;
    end = end < hi ? end : hi;
  }
  return {src, end > src ? (uint32_t)(end - src) : 0u, (uint32_t)(src - g)};
}

// Element x of a stream outside its tile's interior frames: from the stage
// (at s) where the plan says its granule was copied, else from global
// memory.
template <class T>
__device__ __forceinline__ T staged(const unsigned char* s, const T* g, long long x,
                                    long long first, long long end) {
  return x >= first && x < end ? *reinterpret_cast<const T*>(s) : g[x];
}

// One pixel's frame after the leak, as scan_plain computes it: the
// signed count floor(relu(+-diff)/thr), and the base update base +=
// pos*pth, then base -= neg*nth, then the shot reset.  One division and
// one multiply-add, on |diff| and the threshold of its sign:
//   - it divides only where the quotient reaches 1.  For floats 0 < d < t
//     the quotient d/t is at most 1 - 2^-23/m, m in [1, 2) the mantissa of
//     t (1 - 2^-24 when m = 1), so it rounds to at most 1 - 2^-24, the
//     float below 1: its floor is 0.  !(d < t) keeps a NaN threshold on
//     the division, as in scan_plain; a zero or NaN diff counts nothing.
//   - at most one of the reference's two terms is non-zero, and a zero
//     term only adds +0, which turns a -0 base into +0 and changes nothing
//     else.  The product of two floats is exact in float64, so one float64
//     FMA rounds as the reference's multiply-add evaluated in float64 does,
//     before its one rounding to float32.
// dpth and dnth are pth and nth in float64.
__device__ __forceinline__ int scan_step(float l, float& b, float pth, float nth, double dpth,
                                         double dnth, bool shot) {
  const float diff = l - b;
  const bool up = diff > 0.0f;
  const float a = up ? diff : -diff;
  const float thr = up ? pth : nth;
  float q = 0.0f;
  if ((up || diff < 0.0f) && !(a < thr)) q = floorf(a / thr);
  const float sq = up ? q : -q;
  const float bb =
      q != 0.0f ? (float)__fma_rn((double)sq, up ? dpth : dnth, (double)b) : b + 0.0f;
  b = shot ? l : bb;
  return (int)sq;
}

template <bool kLeak, bool kShot>
__global__ void __launch_bounds__(kScanMaxTile + 32, 1)
scan_persistent(const __grid_constant__ ScanPlan plan, const int4* __restrict__ tiles,
                const float* __restrict__ lp, const float* __restrict__ leak,
                const uint8_t* __restrict__ shot, const float* __restrict__ pos,
                const float* __restrict__ neg, const float* __restrict__ base_in,
                float* __restrict__ base_out, int16_t* __restrict__ count_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kScanRing;
  unsigned char* stages = smem + kScanBarBytes;
  const int consumers = (plan.threads >> 5) - 1;  // warps; the last one loads
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kScanRing; ++i) {
      mbar_init(smem_u32(full + i), 1);
      mbar_init(smem_u32(empty + i), consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int npix = plan.npix, n_frames = plan.n_frames;
  const int stage_bytes = kScanGroup * plan.frame_bytes;
  const int k0 = plan.block_tiles[blockIdx.x], k1 = plan.block_tiles[blockIdx.x + 1];
  const uint32_t full0 = smem_u32(full), empty0 = smem_u32(empty);
  uint32_t stage = 0, phase = 0;

  if (warp == consumers) {  // the producer
    if (lane != 0) return;
    const uintptr_t g_lp = (uintptr_t)lp & ~(uintptr_t)15;
    const uintptr_t g_leak = (uintptr_t)leak & ~(uintptr_t)15;
    const uintptr_t g_shot = (uintptr_t)shot & ~(uintptr_t)15;
    const uint32_t st0 = smem_u32(stages);
    for (int k = k0; k < k1; ++k) {
      const int4 t = tiles[k];
      const int len = t.y - t.x;
      // each stream's slice of frame f, in bytes from its granule
      long long r_lp = plan.offset[0] + 4ll * t.x, r_leak = plan.offset[1] + 4ll * t.x,
                r_shot = plan.offset[2] + (long long)t.x;
      for (int f0 = 0; f0 < n_frames; f0 += kScanGroup) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1u);
        const uint32_t bar = full0 + 8 * stage;
        uint32_t st = st0 + stage * stage_bytes;
#pragma unroll
        for (int g = 0; g < kScanGroup; ++g) {
          const int f = f0 + g;
          if (f < n_frames) {
            const bool in = f >= t.z && f <= t.w;
            const Bulk b_lp = copy_range(r_lp, 4 * len, in, plan.lo[0], plan.hi[0]);
            Bulk b_leak = {0, 0, 0}, b_shot = {0, 0, 0};
            if (kLeak) b_leak = copy_range(r_leak, 4 * len, in, plan.lo[1], plan.hi[1]);
            if (kShot) b_shot = copy_range(r_shot, len, in, plan.lo[2], plan.hi[2]);
            mbar_expect_tx(bar, b_lp.size + b_leak.size + b_shot.size);
            if (b_lp.size)
              bulk_load(st + plan.region[0] + b_lp.dst, g_lp + b_lp.src, b_lp.size, bar);
            if (kLeak && b_leak.size)
              bulk_load(st + plan.region[1] + b_leak.dst, g_leak + b_leak.src, b_leak.size, bar);
            if (kShot && b_shot.size)
              bulk_load(st + plan.region[2] + b_shot.dst, g_shot + b_shot.src, b_shot.size, bar);
            r_lp += 4ll * npix;
            r_leak += 4ll * npix;
            r_shot += npix;
            st += plan.frame_bytes;
          }
        }
        mbar_arrive(bar);  // the stage's one arrival, after all its byte counts
        if (++stage == (uint32_t)kScanRing) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }

  // the consumers: thread c owns pixel t0 + c of each tile
  const int c = threadIdx.x;
  float nb = 0.0f, npt = 0.0f, nnt = 0.0f;  // the next tile's state
  if (k0 < k1) {
    const int4 t = tiles[k0];
    if (c < t.y - t.x) {
      nb = base_in[t.x + c];
      npt = pos[t.x + c];
      nnt = neg[t.x + c];
    }
  }
  const unsigned char* st = stages;
  for (int k = k0; k < k1; ++k) {
    const int4 t = tiles[k];
    const int t0 = t.x;
    const bool own = c < t.y - t.x;
    float b = nb;
    const float pth = npt, nth = nnt;
    const double dpth = pth, dnth = nth;
    if (k + 1 < k1) {  // loads while this tile runs
      const int4 u = tiles[k + 1];
      if (c < u.y - u.x) {
        nb = base_in[u.x + c];
        npt = pos[u.x + c];
        nnt = neg[u.x + c];
      }
    }
    // each slice's offset in its granule: the pointer's at frame 0 (t0 is
    // a multiple of 16 pixels), then moving by step per frame
    uint32_t m_lp = plan.offset[0], m_leak = plan.offset[1], m_shot = plan.offset[2];
    int16_t* out = count_out + t0 + c;
    for (int f0 = 0; f0 < n_frames; f0 += kScanGroup) {
      mbar_wait(full0 + 8 * stage, phase);
      const unsigned char* fr = st;  // this frame's part of the stage
#pragma unroll
      for (int g = 0; g < kScanGroup; ++g) {
        const int f = f0 + g;
        if (f < n_frames) {
          if (own) {
            const unsigned char* s_lp = fr + plan.region[0] + m_lp + 4 * c;
            const unsigned char* s_leak = fr + plan.region[1] + m_leak + 4 * c;
            const unsigned char* s_shot = fr + plan.region[2] + m_shot + c;
            float l, lk = 0.0f;
            bool sh = false;
            if (f >= t.z && f <= t.w) {
              l = *reinterpret_cast<const float*>(s_lp);
              if (kLeak) lk = *reinterpret_cast<const float*>(s_leak);
              if (kShot) sh = *s_shot != 0;
            } else {
              const long long x = (long long)f * npix + t0 + c;
              l = staged(s_lp, lp, x, plan.first[0], plan.end[0]);
              if (kLeak) lk = staged(s_leak, leak, x, plan.first[1], plan.end[1]);
              if (kShot) sh = staged(s_shot, shot, x, plan.first[2], plan.end[2]) != 0;
            }
            if (kLeak) b = b - lk;
            *out = (int16_t)scan_step(l, b, pth, nth, dpth, dnth, kShot && sh);
          }
          m_lp = (m_lp + plan.step[0]) & 15u;
          m_leak = (m_leak + plan.step[1]) & 15u;
          m_shot = (m_shot + plan.step[2]) & 15u;
          out += npix;
          fr += plan.frame_bytes;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);
      st += stage_bytes;
      if (++stage == (uint32_t)kScanRing) {
        stage = 0;
        phase ^= 1u;
        st = stages;
      }
    }
    if (own) base_out[t0 + c] = b;
  }
}

typedef void (*ScanKernel)(const ScanPlan, const int4*, const float*, const float*,
                           const uint8_t*, const float*, const float*, const float*, float*,
                           int16_t*);

}  // namespace

// sizeof(ScanPlan), which the wrapper checks against its ctypes twin.
extern "C" int v2e_scan_plan_bytes() { return (int)sizeof(ScanPlan); }

// Runs K2 over the plan's frames: one launch on `stream`, no sync.  leak
// and shot may be null (no leak, no shot noise); the plan must be made for
// these pointers (each present stream's offset, none for an absent one) and
// tiles is its tile table on the device.  Reads base, writes new_base and
// counts.  Returns the CUDA error of the shared memory request or the
// launch (never a fallback), or cudaErrorInvalidValue for a plan that does
// not fit the kernel or the pointers.
extern "C" int v2e_scan(const ScanPlan* plan, const int* tiles, const float* lp,
                        const float* leak, const uint8_t* shot, const float* pos,
                        const float* neg, const float* base, float* new_base,
                        int16_t* counts, void* stream) {
  const ScanPlan& p = *plan;
  if (p.npix <= 0 || p.n_frames <= 0) return 0;
  const void* ptrs[kScanStreams] = {lp, leak, shot};
  bool ok = p.blocks >= 1 && p.blocks <= kScanMaxBlocks && p.tile >= 1 &&
            p.tile <= kScanMaxTile && p.threads % 32 == 0 && p.threads >= p.tile + 32 &&
            p.threads <= kScanMaxTile + 32 && p.frame_bytes % 16 == 0 &&
            p.smem_bytes == kScanBarBytes + kScanRing * kScanGroup * p.frame_bytes &&
            p.block_tiles[0] == 0 && tiles != nullptr && lp != nullptr;
  for (int s = 0; s < kScanStreams; ++s)
    ok = ok && (ptrs[s] != nullptr) == (p.region[s] >= 0) &&
         (ptrs[s] == nullptr || (int)((uintptr_t)ptrs[s] & 15) == p.offset[s]);
  if (!ok) return (int)cudaErrorInvalidValue;
  static const ScanKernel kernels[4] = {scan_persistent<false, false>,
                                        scan_persistent<false, true>,
                                        scan_persistent<true, false>, scan_persistent<true, true>};
  const ScanKernel kern = kernels[2 * (leak != nullptr) + (shot != nullptr)];
  const cudaError_t e = cudaFuncSetAttribute(
      (const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refusal, not a sticky fault: clear it for later launches
    return (int)e;
  }
  kern<<<p.blocks, p.threads, p.smem_bytes, (cudaStream_t)stream>>>(
      p, reinterpret_cast<const int4*>(tiles), lp, leak, shot, pos, neg, base, new_base,
      counts);
  return (int)cudaGetLastError();
}
