// K5: 3x3 stride-1 'same' convolution + bias + LeakyReLU on NHWC input,
// accumulated in float32.
//
// Replaces v2e_tpu/ops/pallas/conv3.py:201 (conv3x3_lane, its _kernel).
// The plain PyTorch version is
// v2e_tpu_torch/ops/kernels/conv3.py::conv3x3_lane_plain.
//
// What it computes, for x [N,H,W,Ci] (bf16 or f32), the weights w cast to
// x's type and a float32 bias b [Co]:
//   acc[n,h,w,o] = sum_{ky,kx,i} x[n,h+ky-1,w+kx-1,i] * w[ky,kx,i,o]
//                  (float32; taps outside the image are zero)
//   y = acc + b[o];  y = max(y, slope * y) when act;  out = y cast once
// to x's type.  That is the TPU kernel's epilogue: bias and activation in
// float32, one rounding at the end (the dense UNet form rounds the
// convolution, the bias add and the activation separately).
//
// bf16 form (the main path), a persistent, pipelined implicit GEMM for
// sm_90a: M = output pixels, N = Co, K = 9*Ci.
// * Weights resident.  One block per SM (grid = min(work, SMs x resident
//   blocks)) copies the packed weights [co_block][tap][Ci/8][CoT][8] into
//   shared memory once (up4: 147,456 B, up5: 36,864 B), in the K-major
//   core-matrix layout wgmma reads (no bank conflicts).  Co <= 32 is packed
//   as CoT = 32 columns, wider Co in blocks of 64.  A layer whose weights
//   do not fit beside the rings streams each step's slice [tap][KC/8][CoT]
//   [8] with the input (correct, not fast).
// * Two independent warpgroups.  Each walks its own work items (image,
//   8-row x 8*MT-column tile, co_block): 8 x 16 pixels for Co = 64 (MT = 2)
//   and 8 x 32 for Co = 32 (MT = 4), round robin over the grid, with its
//   own ring and its own named barrier, so one's loads and epilogue
//   overlap the other's products.
// * Input ring.  A stage is the tile with its one-pixel halo, (8+2) x
//   (8*MT+2) positions, for KC = 32 (or 16) input channels, laid out
//   [KC/8][row][column][8]: one position's 8 channels are one 16-byte row
//   of a core matrix.  Loads are 16-byte cp.async copies, zero filled
//   outside the image (the 'same' padding) and past Ci, issued stages - 1
//   steps ahead in a ring of 2-8 stages.
// * Tensor cores.  wgmma.mma_async m64nCoTk16, bf16 in, float32
//   accumulators in registers.  An m64 tile is 8 output rows x 8 columns:
//   its A operand is 8 core matrices, one per staged row (stride byte
//   offset = a staged row), so the operand of tap (ky, kx) is the staged
//   tile shifted by ky rows and kx positions: a change of the descriptor's
//   start address, no im2col copy.  Per step 9 taps x KC/16 x MT wgmmas,
//   then wait_group 0: the other warpgroup's products keep the tensor
//   cores busy meanwhile.  Only this descriptor form was built; feeding A
//   from registers with ldmatrix would need a copy per tap shift.
// * Epilogue.  Per 8 pixels x CoT channels a warp adds the float32 bias,
//   applies the activation and casts once to bf16 in registers, writes
//   the block with stmatrix into its own XOR-swizzled scratch and copies
//   it out with 16-byte stores: 8 neighbouring pixels of one image row,
//   contiguous NHWC.
// Why these choices (each measured faster on an H100 80GB HBM3 at
// chip_smoke.py's [k5] shapes): tiles of flat image rows (one zero border
// column, any 64 consecutive outputs an m64 operand) staged 2.3x each tile
// for their halo rows, and took 1.23 / 1.87 ms at up4 / up5 with one
// block-wide pipeline; the 8 x 8 m64 blocks stage 1.3-1.4x.  An epilogue
// of register shuffles left the tensor cores idle for longer than the
// stmatrix one.  Two warpgroups in turns at the tensor cores (ping-pong)
// were slower than independent ones: one warpgroup's steps alone do not
// keep the tensor cores busy.
//
// Shared memory: weights (if resident) + 2 rings x stages x (10 x (8*MT+2)
// x KC x 2 B) + 8 warps x 8 x CoT x 2 B of epilogue scratch, chosen at
// launch within the 227 KB a block may have (cudaFuncSetAttribute; a
// request the card refuses is returned as an error, never a fallback).
//
// Bound on the card: tensor-core FLOPs 2*9*Ci*Co per pixel, and bytes (x
// read once, y written once).  up4 (128->64) is bound by operations, up5
// (64->32) by bytes; chip_smoke.py computes both for the shapes the main
// path launches.  The halo re-read from L2 is 10 x 18 / (8 x 16) = 1.4x of
// the input at up4 and 10 x 34 / (8 x 32) = 1.33x at up5.
//
// f32 form (tests and the plain-precision UNet, not the main path): one
// block of 8 warps per 8x16 output tile and 64 output channels; each
// thread owns one pixel and 32 channels and runs float32 FMAs on the CUDA
// cores over Ci slices of 8 staged in shared memory; weights [9][CiP][CoP].
//
// Rounding: built with --fmad=false; the f32 form uses explicit fmaf.  The
// order of the float32 sums differs from the plain version's (cuDNN or the
// CPU's conv), so the result agrees to float32 rounding before the final
// cast: within one bf16 ulp of the output for bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- bf16 form

constexpr int kWG = 2;                 // warpgroups per block
constexpr int kConvThreads = 128 * kWG;
constexpr int kMaxStages = 8;

struct ConvGeom {
  int N, H, W, Ci, Co, CiP;  // Ci, Co multiples of 8; CiP of 16
  int co_blocks;
  int tiles_x, tiles_y;      // output tiles per image row and column
  int KC, nchunks;           // channels per stage, CiP / KC
  int stages, resident, stage_bytes, weight_bytes;
  int items;                 // N * tiles_y * tiles_x * co_blocks
  float slope;
  int act;
};

// The output tile of one warpgroup: MT m64 tiles side by side, each 8 rows x
// 8 columns (one 8-pixel core matrix per row): 8 x 16 pixels for Co = 64
// (MT = 2), 8 x 32 for Co = 32 (MT = 4).  It is staged with its halo.
template <int CoT, int MT>
struct TileShape {
  static constexpr int TH = 8;              // output rows
  static constexpr int TW = 8 * MT;         // output columns
  static constexpr int SW = TW + 2;         // staged row, with the halo
  static constexpr int SP = (TH + 2) * SW;  // staged positions
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait(int pending) {
  // pending = stages - 2, a small constant per launch
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
  }
}

// no-swizzle shared memory matrix descriptor: start address, leading byte
// offset (between core matrices along K), stride byte offset (between
// 8-row core matrices along M or N)
__device__ __forceinline__ uint64_t mat_desc(uint32_t addr, uint32_t lbo,
                                             uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

// d = A*B + (acc ? d : 0)
template <int CoT>
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t da, uint64_t db,
                                           int acc);

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float* d, uint64_t da,
                                               uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float* d, uint64_t da,
                                               uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

// keeps the accumulators in place across the asynchronous wgmma (no copy
// of them may be scheduled between issue and wait)
template <int N>
__device__ __forceinline__ void fence_operands(float* d) {
#pragma unroll
  for (int j = 0; j < N; ++j) asm volatile("" : "+f"(d[j])::"memory");
}

__device__ __forceinline__ float act_f32(float acc, float bias, float slope,
                                         int act) {
  float v = acc + bias;
  return act ? fmaxf(v, slope * v) : v;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

struct Item {
  int n, h0, w0, co0, cb;
};

template <int CoT, int MT>
__device__ __forceinline__ Item item_at(const ConvGeom& g, int it) {
  using TS = TileShape<CoT, MT>;
  Item r;
  r.cb = it % g.co_blocks;
  it /= g.co_blocks;
  const int tx = it % g.tiles_x;
  it /= g.tiles_x;
  const int ty = it % g.tiles_y;
  r.n = it / g.tiles_y;
  r.h0 = ty * TS::TH;
  r.w0 = tx * TS::TW;
  r.co0 = r.cb * CoT;
  return r;
}

// cp.async of one step's stage: the tile with its halo, (TH+2) x (TW+2)
// positions, for input channels [chunk*KC, chunk*KC + KC), laid out
// [KC/8][row][column][8]; and the weight slice when streamed
template <int CoT, int MT, int KC>
__device__ __forceinline__ void issue_stage(
    const ConvGeom& g, const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ wpk, uint32_t stage, const Item& t,
    int chunk) {
  using TS = TileShape<CoT, MT>;
  constexpr int kc8 = KC / 8;
  const int ci_base = chunk * KC;
  for (int e = threadIdx.x & 127; e < TS::SP * kc8; e += 128) {
    const int pos = e / kc8, c8 = e - pos * kc8;
    const int r = pos / TS::SW, c = pos - r * TS::SW;
    const int h = t.h0 - 1 + r, w = t.w0 - 1 + c, ci = ci_base + c8 * 8;
    const bool ok = (unsigned)h < (unsigned)g.H && (unsigned)w < (unsigned)g.W &&
                    ci < g.Ci;
    const __nv_bfloat16* src =
        ok ? x + (((size_t)t.n * g.H + h) * g.W + w) * g.Ci + ci : x;
    cp_async16(stage + (uint32_t)(c8 * TS::SP + pos) * 16u, src, ok);
  }
  if (!g.resident) {
    const uint32_t wst = stage + (uint32_t)TS::SP * KC * 2u;
    constexpr int per_tap = kc8 * CoT;
    const int cip8 = g.CiP >> 3;
    for (int e = threadIdx.x & 127; e < 9 * per_tap; e += 128) {
      const int tap = e / per_tap, rem = e - tap * per_tap;
      const __nv_bfloat16* src =
          wpk + ((size_t)((t.cb * 9 + tap) * cip8 + chunk * kc8) * CoT + rem) * 8;
      cp_async16(wst + (uint32_t)e * 16u, src, true);
    }
  }
}

__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0, uint32_t r1,
                                            uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// 16-byte chunk i of pixel row r in a warp's epilogue scratch, XOR-swizzled
// so that neither stmatrix nor the read-back has bank conflicts
template <int CoT>
__device__ __forceinline__ uint32_t scratch_at(uint32_t base, int r, int i) {
  constexpr int CH = CoT / 8;
  const int sw = CH == 8 ? r : (r >> 1) & 3;
  return base + (uint32_t)(r * CoT * 2 + ((i ^ sw) << 4));
}

// Epilogue of one work item.  In m64 tile m of the warpgroup, accumulator
// row 16*warp + lane/4 + 8*hr is pixel (row 2*warp + hr,
// column lane/4) of the tile's 8 x 8 block, and the thread holds its
// channels 8j + 2q and 8j + 2q + 1 for j < CoT/8: for each j, the
// fragment layout of one 8x8 matrix of stmatrix.  Per (m, hr) a warp adds
// the float32 bias, applies the activation, casts once to bf16, writes the
// 8 pixels x CoT channels to its scratch with stmatrix and copies them out
// as 16-byte stores: the 8 pixels are neighbours in one image row.
template <int CoT, int MT>
__device__ __forceinline__ void store_item(const float (&acc)[MT][CoT / 2],
                                           const Item& t, const ConvGeom& g,
                                           const float* __restrict__ b,
                                           __nv_bfloat16* __restrict__ y,
                                           uint32_t scratch) {
  using TS = TileShape<CoT, MT>;
  constexpr int CH = CoT / 8;  // 16-byte chunks per pixel
  const int tid = threadIdx.x;
  const int warp = (tid >> 5) & 3, lane = tid & 31, q = lane & 3;
  float bias[2 * CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int co = t.co0 + 8 * j + 2 * q;
    bias[2 * j] = co < g.Co ? b[co] : 0.0f;
    bias[2 * j + 1] = co + 1 < g.Co ? b[co + 1] : 0.0f;
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      uint32_t u[CH];
#pragma unroll
      for (int j = 0; j < CH; ++j)
        u[j] = pack_bf16x2(act_f32(acc[m][4 * j + 2 * hr], bias[2 * j], g.slope, g.act),
                           act_f32(acc[m][4 * j + 2 * hr + 1], bias[2 * j + 1], g.slope,
                                   g.act));
#pragma unroll
      for (int jb = 0; jb < CH; jb += 4)
        stmatrix_x4(scratch_at<CoT>(scratch, lane & 7, jb + (lane >> 3)), u[jb], u[jb + 1],
                    u[jb + 2], u[jb + 3]);
      __syncwarp();
      const int h = t.h0 + 2 * warp + hr;
      const int w0 = t.w0 + 8 * m;
#pragma unroll
      for (int c = lane; c < 8 * CH; c += 32) {
        const int r = c / CH, i = c - r * CH;
        const uint4 v = lds128(scratch_at<CoT>(scratch, r, i));
        const int co = t.co0 + 8 * i;
        if (h < g.H && w0 + r < g.W && co < g.Co)
          *reinterpret_cast<uint4*>(y + (((size_t)t.n * g.H + h) * g.W + w0 + r) * g.Co + co) = v;
      }
      __syncwarp();
    }
  }
}

// The persistent bf16 kernel.  Warpgroup w of block b walks work items
// 2b + w, then every 2 x gridDim.x-th, and for each the Ci chunks: one step
// each.  Per step: wait for the step's stage, the warpgroup's barrier,
// issue the cp.async loads of step s + stages - 1 into the stage that step
// s - 1 used, issue the step's wgmmas and wait for them.  After an item's
// last step its products are stored.
template <int CoT, int MT, int KC>
__global__ void __launch_bounds__(kConvThreads, 1)
conv3x3_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ wpk,
                     const float* __restrict__ b,
                     __nv_bfloat16* __restrict__ y, const ConvGeom g) {
  using TS = TileShape<CoT, MT>;
  constexpr int NACC = CoT / 2;  // float32 accumulators per m64 tile
  constexpr int kc8 = KC / 8;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sbase = smem_addr(smem);
  const int wg = threadIdx.x >> 7;

  // resident weights: copied once by the whole block
  if (g.resident) {
    for (int e = threadIdx.x; e < g.weight_bytes / 16; e += kConvThreads)
      cp_async16(sbase + (uint32_t)e * 16u, wpk + (size_t)e * 8, true);
    cp_async_commit();
    cp_async_wait(0);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  // from here on the two warpgroups are independent: each walks its own
  // work items through its own ring, with its own named barrier, so that
  // one's epilogue overlaps the other's products
  const int worker = (int)blockIdx.x * kWG + wg;
  const int nworkers = (int)gridDim.x * kWG;
  if (worker >= g.items) return;
  const int my_items = (g.items - 1 - worker) / nworkers + 1;
  const int steps = my_items * g.nchunks;
  const int lead = g.stages - 1;  // steps a stage is loaded ahead
  const uint32_t ring = sbase + (uint32_t)g.weight_bytes +
                        (uint32_t)(wg * g.stages * g.stage_bytes);

  // the load cursor runs `lead` steps ahead of the compute loop
  int ld_step = 0, ld_item = 0, ld_chunk = 0, ld_buf = 0;
  Item ld_t = item_at<CoT, MT>(g, worker);
  auto load_next = [&]() {
    if (ld_step < steps) {
      issue_stage<CoT, MT, KC>(g, x, wpk, ring + (uint32_t)(ld_buf * g.stage_bytes),
                               ld_t, ld_chunk);
      ld_buf = ld_buf + 1 == g.stages ? 0 : ld_buf + 1;
      if (++ld_chunk == g.nchunks) {
        ld_chunk = 0;
        if (++ld_item < my_items) ld_t = item_at<CoT, MT>(g, worker + ld_item * nworkers);
      }
      ++ld_step;
    }
    cp_async_commit();
  };
  for (int s = 0; s < lead; ++s) load_next();

  float acc[MT][NACC] = {};
  // A: 8 staged rows (SBO) of 8 positions, the two 8-channel halves of a
  // k16 step LBO apart; B: CoT rows of 8 channels, K-major
  constexpr uint32_t a_sbo = TS::SW * 16u;
  constexpr uint32_t a_lbo = TS::SP * 16u;
  constexpr uint32_t b_lbo = CoT * 16u;
  const int cip8 = g.CiP >> 3;
  const uint32_t wtap = g.resident ? (uint32_t)(cip8 * CoT) * 16u
                                   : (uint32_t)(kc8 * CoT) * 16u;
  const uint32_t scratch = sbase + (uint32_t)g.weight_bytes +
                           (uint32_t)(kWG * g.stages * g.stage_bytes) +
                           (uint32_t)((threadIdx.x >> 5) * 8 * CoT * 2);
  int buf = 0;

  for (int i = 0; i < my_items; ++i) {
    const Item t = item_at<CoT, MT>(g, worker + i * nworkers);
    for (int chunk = 0; chunk < g.nchunks; ++chunk) {
      cp_async_wait(g.stages - 2);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      load_next();
      const uint32_t stage = ring + (uint32_t)(buf * g.stage_bytes);
      buf = buf + 1 == g.stages ? 0 : buf + 1;
      const uint32_t wbase =
          g.resident ? sbase + (uint32_t)((t.cb * 9 * cip8 + chunk * kc8) * CoT) * 16u
                     : stage + (uint32_t)TS::SP * KC * 2u;
#pragma unroll
      for (int m = 0; m < MT; ++m) fence_operands<NACC>(acc[m]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap - ky * 3;
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk) {
          const uint64_t db =
              mat_desc(wbase + tap * wtap + (uint32_t)(2 * kk * CoT) * 16u, b_lbo, 128u);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const uint32_t aaddr = stage + (uint32_t)(ky * TS::SW + kx + 8 * m) * 16u +
                                   (uint32_t)(2 * kk) * a_lbo;
            wgmma_bf16<CoT>(acc[m], mat_desc(aaddr, a_lbo, a_sbo), db,
                            (chunk | tap | kk) != 0);
          }
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the other warpgroup's products keep the tensor cores busy while
      // this one waits for its own
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) fence_operands<NACC>(acc[m]);
    store_item<CoT, MT>(acc, t, g, b, y, scratch);
  }
  cp_async_wait(0);
}

// ----------------------------------------------------------------- f32 form

constexpr int kTH = 8;        // output rows per block, one warp each
constexpr int kTW = 16;       // output columns per block
constexpr int kIH = kTH + 2;  // staged input rows and columns, with the halo
constexpr int kIW = kTW + 2;
constexpr int kCoBlk = 64;    // output channels per block
constexpr int kThreads = kTH * 32;

// Ci in slices of 8; the staged pixel stride is padded to 9 floats so that
// the 32 pixels a warp reads fall in 32 different banks
constexpr int kKC32 = 8;
constexpr int kKP32 = 9;

struct SmemF32 {
  float x[kIH * kIW * kKP32];
  float w[9 * kKC32 * kCoBlk];
};

__device__ __forceinline__ float epilogue(float acc, float bias, float slope,
                                          int act) {
  return act_f32(acc, bias, slope, act);
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

template <int CoT, int MT>
void* wgmma_kernel(int kc) {
  return kc == 32 ? (void*)conv3x3_wgmma_kernel<CoT, MT, 32>
                  : (void*)conv3x3_wgmma_kernel<CoT, MT, 16>;
}

// The bf16 form's launch plan for this layer on the current device:
// channels per stage, ring depth (2-8 stages per warpgroup), weights
// resident or streamed.  Prefers resident weights, then rings of at least
// 3 stages (2 loaded ahead), then larger KC (fewer steps), then deeper
// rings.
template <int CoT, int MT>
cudaError_t plan_bf16(ConvGeom* g, int* smem_bytes, int* blocks) {
  using TS = TileShape<CoT, MT>;
  int dev = 0, smem_max = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int wres = g->co_blocks * 9 * g->CiP * CoT * 2;
  const int epi = kConvThreads / 32 * 8 * CoT * 2;  // a warp: 8 pixels x CoT
  int best = -1;
  for (int resident = 1; resident >= 0 && best < 0; --resident) {
    // each warpgroup has its own ring
    const int avail = (smem_max - epi - (resident ? wres : 0)) / kWG;
    for (int kc = 32; kc >= 16; kc -= 16) {
      if (g->CiP % kc) continue;
      const int stage_bytes = TS::SP * kc * 2 + (resident ? 0 : 9 * kc * CoT * 2);
      int stages = avail > 0 ? avail / stage_bytes : 0;
      stages = stages > kMaxStages ? kMaxStages : stages;
      if (stages < 2) continue;
      const int score = (stages >= 3 ? 1000 : 0) + kc * 10 + stages;
      if (score > best) {
        best = score;
        g->resident = resident;
        g->KC = kc;
        g->stages = stages;
        g->stage_bytes = stage_bytes;
      }
    }
  }
  if (best < 0) return cudaErrorInvalidConfiguration;
  g->tiles_x = (g->W + TS::TW - 1) / TS::TW;
  g->tiles_y = (g->H + TS::TH - 1) / TS::TH;
  g->nchunks = g->CiP / g->KC;
  g->weight_bytes = g->resident ? wres : 0;
  const long long items = (long long)g->N * g->tiles_y * g->tiles_x * g->co_blocks;
  if (items * g->nchunks >= (1LL << 31)) return cudaErrorInvalidValue;
  g->items = (int)items;
  *smem_bytes = g->weight_bytes + kWG * g->stages * g->stage_bytes + epi;
  e = cudaFuncSetAttribute(wgmma_kernel<CoT, MT>(g->KC),
                           cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_bytes);
  if (e != cudaSuccess) return e;
  int occ = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, wgmma_kernel<CoT, MT>(g->KC),
                                                    kConvThreads, *smem_bytes);
  if (e != cudaSuccess) return e;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  const long long resident_blocks = (long long)occ * sms;
  const long long need = (items + kWG - 1) / kWG;
  *blocks = (int)(need < resident_blocks ? need : resident_blocks);
  return cudaSuccess;
}

template <int CoT, int MT>
cudaError_t launch_bf16(ConvGeom g, const void* x, const void* w, const float* b,
                        void* y, cudaStream_t st) {
  int smem = 0, blocks = 0;
  cudaError_t e = plan_bf16<CoT, MT>(&g, &smem, &blocks);
  if (e != cudaSuccess) return e;
  const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
  const __nv_bfloat16* wb = (const __nv_bfloat16*)w;
  if (g.KC == 32)
    conv3x3_wgmma_kernel<CoT, MT, 32><<<blocks, kConvThreads, smem, st>>>(
        xb, wb, b, (__nv_bfloat16*)y, g);
  else
    conv3x3_wgmma_kernel<CoT, MT, 16><<<blocks, kConvThreads, smem, st>>>(
        xb, wb, b, (__nv_bfloat16*)y, g);
  return cudaGetLastError();
}

}  // namespace

// x, y: [N,H,W,Ci] and [N,H,W,Co] contiguous, bf16 (is_bf16 = 1) or f32.
// b: f32 [Co].  act = 0 skips the activation.  One launch on `stream`, no
// sync.  Returns a CUDA error code (a launch the card refuses, e.g. for its
// shared memory, is returned, never replaced by another path).
// bf16: w9 is [co_blocks][9][CiP/8][CoT][8] (ops/kernels/conv3.py::
//   pack_conv3_weights), CoT = 32 when Co <= 32 else 64, CoP = co_blocks *
//   CoT; Ci and Co multiples of 8, CiP = Ci rounded up to 16, x 16-byte
//   aligned, and vec = 1 (the wrapper pads and aligns).
// f32: w9 is [9][CiP][CoP], zero past Ci and Co, CiP a multiple of 16 and
//   CoP of 64; vec is ignored.
extern "C" int v2e_conv3x3(const void* x, const void* w9, const float* b,
                           void* y, int N, int H, int W, int Ci, int Co,
                           int CiP, int CoP, float slope, int act, int is_bf16,
                           int vec, void* stream) {
  if (N == 0 || H == 0 || W == 0 || Co == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    const int CoT = Co <= 32 ? 32 : 64;
    if (!vec || Ci % 8 || Co % 8 || CiP % 16 || CiP < Ci || CoP % CoT ||
        CoP < Co || ((uintptr_t)x & 15) || ((uintptr_t)w9 & 15) || ((uintptr_t)y & 15))
      return (int)cudaErrorInvalidValue;
    ConvGeom g = {};
    g.N = N; g.H = H; g.W = W; g.Ci = Ci; g.Co = Co; g.CiP = CiP;
    g.co_blocks = CoP / CoT;
    g.slope = slope;
    g.act = act;
    cudaError_t e = CoT == 32 ? launch_bf16<32, 4>(g, x, w9, b, y, st)
                              : launch_bf16<64, 2>(g, x, w9, b, y, st);
    return (int)e;
  }
  const int co_blocks = (Co + kCoBlk - 1) / kCoBlk;
  dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, N * co_blocks);
  conv3x3_f32_kernel<<<grid, kThreads, 0, st>>>(
      (const float*)x, (const float*)w9, b, (float*)y, H, W, Ci, Co, CiP, CoP,
      co_blocks, slope, act);
  return (int)cudaGetLastError();
}
