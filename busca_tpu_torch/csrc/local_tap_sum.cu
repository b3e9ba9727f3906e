// Kernel K2: the local multi-scale weighted-tap sum of TransCenter's decoder
// (LocalMultiScaleAttention), for Hopper (sm_90a).
//
//   out[p, c] = sum_{l < L, t < 9} w[p, c / head_dim, l*9 + t]
//                                  * V~_l[p + dil_l * delta_t, c]
//
// with zeros outside the query grid and a float32 accumulator.  Level l is
// given at its own resolution [h_l, w_l, C]; V~_l is it upsampled bilinearly
// to the query grid [H4, W4] (PyTorch's align_corners=False rule, as
// F.interpolate and jax.image.resize compute it), and a level already of the
// query size is read as it is.  weights are [H4, W4, heads, L*9]
// (level-major, taps dy-outer / dx-inner over (-1, 0, 1)), out [H4, W4, C];
// contiguous, and all float32 or all bf16 (busca_tpu's kernel takes either,
// lma_pallas.py:131-134): the kernel is a template over the element type,
// instantiated for float and __nv_bfloat16.
//
// Replaces the Pallas TPU kernel busca_tpu/ops/lma_pallas.py::_kernel
// (reached through lma_pallas.local_tap_sum) together with the bilinear
// upsampling of the level maps in front of it
// (busca_tpu/models/transcenter.py, LocalMultiScaleAttention).  It computes
// the function, not the TPU blocks: no host-side dx-shifted copies, no DMA
// row windows, no 0/1 head-to-lane matmul (Mosaic workarounds).
//
// Bound: each output element is a 36-term sum with weights of its own
// pixel, so there is no product for the tensor cores.  At the MOT17 shape
// (160x272, levels 160x272, 80x136, 40x68, 20x34, C = 256, 8 heads) the
// function reads the levels once (59.2 MB), the weights once (50.1 MB) and
// writes the output once (44.6 MB): 153.9 MB, 0.0459 ms at 3.35 TB/s.
// The float32 work, counted as the plain version does it: each upsampled
// level is interpolated once per element, x-lerps at h_l x W4 and y-lerps
// at H4 x W4, 3 operations each (0.13 GFLOP over the three upsampled
// levels), and every tap inside the grid takes a multiply and an add
// (0.78 GFLOP): 0.91 GFLOP, 0.0136 ms at 67 TFLOP/s.  Bytes bound it.
//
// Design.  A block owns a 16x16 tile of output pixels and a slice of SQ
// float4 channel groups that lies in one head (SQ = 4, 16 channels, at
// C = 256, head_dim 32; SQ = 2 at head_dim 8); the slice is the fastest
// grid index, so the blocks of one tile run together and share its reads
// in L2.  A thread computes one pixel's slice and keeps its SQ accumulators
// in registers across the levels.
// - At the start the block issues every copy with cp.async, one group per
//   level: the tile's weights of its head (a pixel's L*9 in a row) and each
//   level's footprint, the level pixels its taps read.  The weights go in
//   16-byte pieces when a pixel's row is a whole number of them (L a
//   multiple of 4, as the decoder's 4 levels are), else in 4-byte words:
//   the stacked local_tap_sum takes any L <= 8, like
//   lma_pallas.local_tap_sum.  The source index is monotone, so the
//   footprint follows from the first and the last tap row and column:
//   ragged ratios and the map's edges need no special case.
// - Level by level the block waits for that level's group.  For an
//   upsampled level it first writes the x-lerps of the footprint rows at
//   the tile's full-resolution tap columns, once per block instead of once
//   per tap; a tap then reads two of them and does its y-lerp.  Where the
//   3 taps of a column read 4 consecutive rows (a whole-number ratio, away
//   from the grid's edge), each row is read once: at the MOT17 shape that
//   takes the kernel from 0.2376 to 0.2283 ms on an H100 (PERF.md section
//   6).  A level at the query size is read directly.
// - The taps have no branches, so that their reads issue together: a tap
//   outside the grid reads the pixel's own row or column in place of the
//   one outside, and takes weight 0.
// At the MOT17 shape a block takes 88,576 bytes of shared memory (weights
// 36,864; footprints 18x18, 12x12, 8x8 and 6x6 pixels of 64 bytes, 36,352;
// x-lerps 12x20 pixels, 15,360), so two blocks share an SM; the launch
// bounds hold a thread to 128 registers to match (ptxas for sm_90a, CUDA
// 12.8, at SQ = 4: 128 registers, a 16-byte stack frame, 48 bytes of spill
// stores and 32 of spill loads; at SQ = 2: 128, 12 and 12).  A
// footprint that does not fit beside the others in 96 KB is read tap by
// tap from global memory.  Only the stacked path meets it: there every
// level is at the query size, and dilations 4 and 8 widen a level's
// footprint to 24x24 and 32x32 pixels.  The decoder's call stages every
// level.
//
// bf16: a group is 8 channels in the same 16 bytes, so a thread's slice
// takes 2 groups (1 at head_dim 8) for the same 16 channels, and the
// footprints half the shared memory.  Values are widened to float32 on
// load; the weights are widened by the threads into the same float32
// shared rows (no cp.async).  Simple first: at 8 float32 values a group, a
// thread's 9 taps take twice the registers of the float32 instantiation.
//
// Rounding: build with -fmad=false, so that every product is rounded before
// its add, as in the plain torch version (ops/lma.py::
// local_tap_sum_levels_plain: separable lerps, x then y, then
// local_tap_sum_plain):
//   v = l0y * (l0x * v00 + l1x * v01) + l1y * (l0x * v10 + l1x * v11),
//   acc = acc + v * w,
// in the reference's term order (levels, then dy, then dx), so the two agree
// bit for bit.  In bf16 each lerp is rounded to bf16 (x-lerp, then y-lerp,
// __float2bfloat16_rn), with jax.image.resize's weights in bf16 (l0 and l1
// rounded, (1, 0) where the source index clamps at the map's far edge), the
// products and the sum stay float32, and the output is rounded to bf16.
// A tap outside the grid adds v * 0, where v is the value of one of the
// pixel's taps inside the grid; the plain version adds 0 * w.
// For finite values both add zero (at most the sign of a zero sum
// differs).  An inf or NaN in a level reaches the out-of-grid tap only if
// an in-grid tap of the same pixel adds it too, so the kernel's output is
// non-finite exactly where the plain version's is.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kTileY = 16, kTileX = 16;
constexpr int kThreads = kTileY * kTileX;  // one pixel of the tile each
constexpr int kMaxSmemBytes = 96 * 1024;   // two blocks per SM at least

// A group: one 16-byte load of a level map, N consecutive channels (4
// floats or 8 bf16), held as float32 values in registers.  round() is the
// element type's rounding of a float32 result.
template <typename T>
struct Group;

template <>
struct Group<float> {
  static constexpr int N = 4;
  float v[N];
  __device__ __forceinline__ static float round(float x) { return x; }
  __device__ __forceinline__ static Group from(float4 a) {
    Group g;
    g.v[0] = a.x;
    g.v[1] = a.y;
    g.v[2] = a.z;
    g.v[3] = a.w;
    return g;
  }
  __device__ __forceinline__ static Group load(const float4* p) {
    return from(*p);
  }
  __device__ __forceinline__ static Group ldg(const float* p) {
    return from(__ldg(reinterpret_cast<const float4*>(p)));
  }
  __device__ __forceinline__ void store(void* p) const {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Group<__nv_bfloat16> {
  static constexpr int N = 8;
  float v[N];
  __device__ __forceinline__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  // a bf16 is the high half of its float32: widening is exact
  __device__ __forceinline__ static Group from(uint4 a) {
    const unsigned words[4] = {a.x, a.y, a.z, a.w};
    Group g;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      g.v[2 * i] = __uint_as_float(words[i] << 16);
      g.v[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
    return g;
  }
  __device__ __forceinline__ static Group load(const float4* p) {
    return from(*reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ static Group ldg(const __nv_bfloat16* p) {
    return from(__ldg(reinterpret_cast<const uint4*>(p)));
  }
  // rounds to nearest even: the plain version's .to(torch.bfloat16)
  __device__ __forceinline__ void store(void* p) const {
    unsigned words[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      words[i] = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i]))
          | ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1]))
             << 16);
    }
    *reinterpret_cast<uint4*>(p) =
        make_uint4(words[0], words[1], words[2], words[3]);
  }
};

template <typename T>
struct Levels {
  const T* v[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int dil[kMaxLevels];
  // Per level, set by the launcher: the most pixels a tile's footprint can
  // take (0 = not staged: read tap by tap from global memory) and its
  // offset in the shared buffer, in 16-byte units.
  int fp[kMaxLevels];
  int off[kMaxLevels];
};

// One axis of a bilinear tap, by PyTorch's align_corners=False rule
// (ATen/native/UpSample.h: area_pixel_compute_source_index and
// guard_index_and_lambda).  For bf16 the weights are jax.image.resize's in
// bf16: (1, 0) where i1 is clamped to i0, and both rounded to bf16.
struct Lerp {
  int i0, i1;
  float l0, l1;
};

template <typename T>
__device__ __forceinline__ Lerp lerp_index(int dst, int n, float scale) {
  float src = scale * ((float)dst + 0.5f) - 0.5f;
  src = src < 0.0f ? 0.0f : src;
  Lerp r;
  r.i0 = (int)src;
  r.i1 = r.i0 + (r.i0 < n - 1 ? 1 : 0);
  r.l1 = src - (float)r.i0;
  if constexpr (std::is_same<T, float>::value) {
    r.l0 = 1.0f - r.l1;
  } else {
    if (r.i1 == r.i0) r.l1 = 0.0f;
    r.l0 = Group<T>::round(1.0f - r.l1);
    r.l1 = Group<T>::round(r.l1);
  }
  return r;
}

// la * a + lb * b in float32, rounded to the element type
template <typename T>
__device__ __forceinline__ Group<T> lerp(const Group<T>& a, float la,
                                         const Group<T>& b, float lb) {
  Group<T> r;
#pragma unroll
  for (int i = 0; i < Group<T>::N; ++i) {
    r.v[i] = Group<T>::round(la * a.v[i] + lb * b.v[i]);
  }
  return r;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(float4* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` (0..7) of this thread's groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// A tile's footprint in one level: the level rows [r_lo, r_lo + rows) and
// columns [j_lo, j_lo + jcols) that its taps read (for an upsampled level,
// through their lerps), and the full-resolution tap columns
// [xx_lo, xx_lo + cols).  The source index is monotone, so the first and
// the last tap row and column give it.
struct Footprint {
  int r_lo, rows, j_lo, jcols, xx_lo, cols;
};

__device__ __forceinline__ Footprint footprint(int y0, int x0, int y_last,
                                               int x_last, int d, int h,
                                               int w, int h4, int w4,
                                               bool direct, float sy,
                                               float sx) {
  const int yy_lo = max(y0 - d, 0), yy_hi = min(y_last + d, h4 - 1);
  const int xx_lo = max(x0 - d, 0), xx_hi = min(x_last + d, w4 - 1);
  Footprint f;
  f.xx_lo = xx_lo;
  f.cols = xx_hi - xx_lo + 1;
  if (direct) {
    f.r_lo = yy_lo;
    f.rows = yy_hi - yy_lo + 1;
    f.j_lo = xx_lo;
    f.jcols = f.cols;
  } else {  // the indices do not depend on the element type
    f.r_lo = lerp_index<float>(yy_lo, h, sy).i0;
    f.rows = lerp_index<float>(yy_hi, h, sy).i1 - f.r_lo + 1;
    f.j_lo = lerp_index<float>(xx_lo, w, sx).i0;
    f.jcols = lerp_index<float>(xx_hi, w, sx).i1 - f.j_lo + 1;
  }
  return f;
}

// Block (slice, tile x, tile y): the slice is the fastest grid index, so the
// blocks of one tile run together and share its reads in L2.  Shared
// memory: the tile's weights of the slice's head, [256][L*9] floats; each
// staged level's footprint, [SQ][rows][jcols] groups; one buffer of
// x-lerps, [SQ][rows][cols] groups (a group is 16 bytes of T).
template <typename T, int SQ>
__global__ void __launch_bounds__(kThreads, 2)
    local_tap_sum_kernel(Levels<T> lv, const T* __restrict__ weights,
                         T* __restrict__ out, int levels, int h4, int w4,
                         int c, int heads, int xbuf_off, bool w16) {
  using G = Group<T>;
  extern __shared__ float4 smem[];
  const int taps = levels * 9;
  float* wsm = reinterpret_cast<float*>(smem);
  float4* xbuf = smem + xbuf_off;
  const int c0 = blockIdx.x * SQ * G::N;  // the slice's first channel
  const int x0 = blockIdx.y * kTileX, y0 = blockIdx.z * kTileY;
  const int head = c0 / (c / heads);  // the slice lies in one head
  const int tid = threadIdx.x;
  const int y = y0 + tid / kTileX, x = x0 + tid % kTileX;
  const bool inside = y < h4 && x < w4;
  const int y_last = min(y0 + kTileY, h4) - 1;
  const int x_last = min(x0 + kTileX, w4) - 1;

  // Start every copy at once, one group per level (the weights go with
  // level 0): the tile's weights of the head, a pixel's taps in a row,
  // consecutive threads on consecutive words (in 16-byte pieces when a row
  // is a whole number of them); then each staged level's footprint, the
  // threads of a pixel reading its slice together.  bf16 weights are read
  // and widened to float32 by the threads.
  if constexpr (std::is_same<T, float>::value) {
    const int piece = w16 ? 4 : 1, pieces = taps / piece;
    int p = tid / pieces, t = tid - p * pieces;
    const int step_p = kThreads / pieces, step_t = kThreads - step_p * pieces;
    for (int i = tid; i < pieces * kThreads; i += kThreads) {
      const int py = y0 + p / kTileX, px = x0 + p % kTileX;
      if (py < h4 && px < w4) {
        float* dst = wsm + p * taps + t * piece;
        const float* src =
            weights + (((size_t)py * w4 + px) * heads + head) * taps
            + t * piece;
        if (w16) {
          cp_async16(reinterpret_cast<float4*>(dst), src);
        } else {
          cp_async4(dst, src);
        }
      }
      p += step_p;
      t += step_t;
      if (t >= pieces) {
        t -= pieces;
        ++p;
      }
    }
  } else {
    for (int i = tid; i < taps * kThreads; i += kThreads) {
      const int p = i / taps, t = i - p * taps;
      const int py = y0 + p / kTileX, px = x0 + p % kTileX;
      if (py < h4 && px < w4) {
        wsm[i] = __bfloat162float(
            weights[(((size_t)py * w4 + px) * heads + head) * taps + t]);
      }
    }
  }
  for (int l = 0; l < levels; ++l) {
    const int h = lv.h[l], w = lv.w[l];
    const bool direct = h == h4 && w == w4;
    const Footprint f = footprint(y0, x0, y_last, x_last, lv.dil[l], h, w,
                                  h4, w4, direct, (float)h / (float)h4,
                                  (float)w / (float)w4);
    if (f.rows * f.jcols <= lv.fp[l]) {  // block-uniform
      // thread: one group q of every (kThreads / SQ)-th pixel
      const T* vl = lv.v[l] + c0 + (tid % SQ) * G::N;
      float4* raw = smem + lv.off[l] + (tid % SQ) * f.rows * f.jcols;
      const int step = kThreads / SQ;
      const int step_r = step / f.jcols, step_j = step - step_r * f.jcols;
      int r = (tid / SQ) / f.jcols, j = (tid / SQ) - r * f.jcols;
      for (; r < f.rows; r += step_r, j += step_j) {
        if (j >= f.jcols) {
          j -= f.jcols;
          if (++r >= f.rows) break;
        }
        cp_async16(raw + r * f.jcols + j,
                   vl + ((size_t)(f.r_lo + r) * w + f.j_lo + j) * c);
      }
    }
    cp_async_commit();
  }

  G acc[SQ];
#pragma unroll
  for (int q = 0; q < SQ; ++q) {
#pragma unroll
    for (int i = 0; i < G::N; ++i) acc[q].v[i] = 0.0f;
  }

  for (int l = 0; l < levels; ++l) {
    const int d = lv.dil[l], h = lv.h[l], w = lv.w[l];
    const T* vl = lv.v[l] + c0;
    const bool direct = h == h4 && w == w4;
    const float sy = (float)h / (float)h4;
    const float sx = (float)w / (float)w4;
    const Footprint f = footprint(y0, x0, y_last, x_last, d, h, w, h4, w4,
                                  direct, sy, sx);
    const bool staged = f.rows * f.jcols <= lv.fp[l];  // block-uniform
    const float4* raw = smem + lv.off[l];
    cp_async_wait(levels - 1 - l);  // this level's group is in
    __syncthreads();  // ... for every thread; the last level's taps are done
    // the taps read `buf`: the footprint itself for a level at the query
    // size, its x-lerps at the tap columns for an upsampled level
    const float4* buf = raw;
    if (staged && !direct) {
      const int lines = f.rows * SQ;  // [SQ][rows] lines of cols x-lerps
      const int step_r = kThreads / f.cols;
      const int step_c = kThreads - step_r * f.cols;
      int qr = tid / f.cols, col = tid - qr * f.cols;
      for (; qr < lines; qr += step_r, col += step_c) {
        if (col >= f.cols) {
          col -= f.cols;
          if (++qr >= lines) break;
        }
        const Lerp rx = lerp_index<T>(f.xx_lo + col, w, sx);
        const float4* row = raw + qr * f.jcols - f.j_lo;
        lerp<T>(G::load(row + rx.i0), rx.l0, G::load(row + rx.i1), rx.l1)
            .store(xbuf + qr * f.cols + col);
      }
      __syncthreads();
      buf = xbuf;
    }
    if (!inside) continue;
    const int plane = f.rows * f.cols;
    // The level's 9 weights, y-lerps and columns.  Taps have no branches,
    // so that their loads issue together: a tap outside the grid takes the
    // pixel's own row or column in place of the one outside, so it reads
    // the value of a tap inside the grid, and adds it with weight 0.
    float wt[9];
    Lerp ry[3];
    int xc[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int yy = y + (k - 1) * d, xx = x + (k - 1) * d;
      const bool y_in = yy >= 0 && yy < h4;
      const int yc = y_in ? yy : y;
      xc[k] = xx >= 0 && xx < w4 ? xx : x;
      ry[k] = direct ? Lerp{yc, yc, 1.0f, 0.0f} : lerp_index<T>(yc, h, sy);
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int xt = x + (dx - 1) * d;
        wt[k * 3 + dx] = y_in && xt >= 0 && xt < w4
            ? wsm[tid * taps + l * 9 + k * 3 + dx] : 0.0f;
      }
    }
    // the three taps' y-lerps read four consecutive rows (a whole-number
    // ratio, away from the grid's edge): read each once
    const bool regular = ry[1].i0 == ry[0].i0 + 1 &&
                         ry[2].i0 == ry[0].i0 + 2 && ry[2].i1 == ry[2].i0 + 1;
#pragma unroll
    for (int q = 0; q < SQ; ++q) {
      G v[9];
      if (staged) {
        const float4* bq = buf + q * plane - f.xx_lo;
        if (direct) {
#pragma unroll
          for (int t = 0; t < 9; ++t) {
            v[t] = G::load(bq + (ry[t / 3].i0 - f.r_lo) * f.cols + xc[t % 3]);
          }
        } else if (regular) {
          const float4* b = bq + (ry[0].i0 - f.r_lo) * f.cols;
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            G rows[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              rows[k] = G::load(b + k * f.cols + xc[dx]);
            }
#pragma unroll
            for (int dy = 0; dy < 3; ++dy) {
              v[dy * 3 + dx] = lerp<T>(rows[dy], ry[dy].l0, rows[dy + 1],
                                       ry[dy].l1);
            }
          }
        } else {
#pragma unroll
          for (int t = 0; t < 9; ++t) {
            const Lerp& r = ry[t / 3];
            v[t] = lerp<T>(G::load(bq + (r.i0 - f.r_lo) * f.cols + xc[t % 3]),
                           r.l0,
                           G::load(bq + (r.i1 - f.r_lo) * f.cols + xc[t % 3]),
                           r.l1);
          }
        }
      } else {
        const T* vq = vl + q * G::N;
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const Lerp& r = ry[t / 3];
          if (direct) {
            v[t] = G::ldg(vq + ((size_t)r.i0 * w + xc[t % 3]) * c);
          } else {
            const Lerp rx = lerp_index<T>(xc[t % 3], w, sx);
            const T* g0 = vq + (size_t)r.i0 * w * c;
            const T* g1 = vq + (size_t)r.i1 * w * c;
            v[t] = lerp<T>(lerp<T>(G::ldg(g0 + (size_t)rx.i0 * c), rx.l0,
                                   G::ldg(g0 + (size_t)rx.i1 * c), rx.l1),
                           r.l0,
                           lerp<T>(G::ldg(g1 + (size_t)rx.i0 * c), rx.l0,
                                   G::ldg(g1 + (size_t)rx.i1 * c), rx.l1),
                           r.l1);
          }
        }
      }
      // the reference's term order: dy, then dx
#pragma unroll
      for (int t = 0; t < 9; ++t) {
#pragma unroll
        for (int i = 0; i < G::N; ++i) {
          acc[q].v[i] = acc[q].v[i] + v[t].v[i] * wt[t];
        }
      }
    }
  }
  if (inside) {
    T* o = out + ((size_t)y * w4 + x) * c + c0;
#pragma unroll
    for (int q = 0; q < SQ; ++q) acc[q].store(o + q * G::N);
  }
}

template <typename T, int SQ>
cudaError_t launch_sq(Levels<T> lv, const T* weights, T* out, int levels,
                      int h4, int w4, int c, int heads, cudaStream_t stream) {
  // Stage each level whose footprint bound fits.  A tile's taps reach
  // ny <= 16 + 2*dil rows and nx <= 16 + 2*dil columns; through the lerps
  // an upsampled level's footprint takes at most floor((ny - 1) * h / h4)
  // + 3 of its rows (the source index is monotone), and likewise columns.
  const int wsm = (levels * 9 * kThreads + 3) / 4;  // 16-byte units
  int used = wsm, xbuf = 0;
  for (int l = 0; l < levels; ++l) {
    const int d = lv.dil[l], h = lv.h[l], w = lv.w[l];
    const int ny = min(kTileY + 2 * d, h4), nx = min(kTileX + 2 * d, w4);
    const bool direct = h == h4 && w == w4;
    const int rows =
        direct ? ny : min(h, (int)((long long)(ny - 1) * h / h4) + 3);
    const int jcols =
        direct ? nx : min(w, (int)((long long)(nx - 1) * w / w4) + 3);
    const int need = rows * jcols * SQ;
    const int xneed = direct ? 0 : rows * nx * SQ;
    lv.fp[l] = 0;
    lv.off[l] = used;
    if ((used + need + max(xbuf, xneed)) * 16 <= kMaxSmemBytes) {
      lv.fp[l] = rows * jcols;
      used += need;
      xbuf = max(xbuf, xneed);
    }
  }
  const int smem = (used + xbuf) * 16;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        local_tap_sum_kernel<T, SQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((c / Group<T>::N) / SQ, (w4 + kTileX - 1) / kTileX,
                  (h4 + kTileY - 1) / kTileY);
  // float32 weights go in 16-byte pieces when a pixel's row of taps allows
  const bool w16 = std::is_same<T, float>::value && levels % 4 == 0 &&
                   (size_t)weights % 16 == 0;
  local_tap_sum_kernel<T, SQ><<<grid, kThreads, smem, stream>>>(
      lv, weights, out, levels, h4, w4, c, heads, used, w16);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* const* values, const int* level_hw, const int* dils,
           int levels, const void* weights, int h4, int w4, int c, int heads,
           void* out, void* stream) {
  if (levels <= 0 || levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  if (h4 <= 0 || w4 <= 0 || c <= 0) return 0;
  Levels<T> lv = {};
  for (int l = 0; l < levels; ++l) {
    lv.v[l] = static_cast<const T*>(values[l]);
    lv.h[l] = level_hw[2 * l];
    lv.w[l] = level_hw[2 * l + 1];
    lv.dil[l] = dils[l];
  }
  const T* wts = static_cast<const T*>(weights);
  T* o = static_cast<T*>(out);
  const cudaStream_t s = (cudaStream_t)stream;
  // the slice lies in one head: in float32 4 groups of 4 channels where
  // the head has a multiple of 16 (32 in the MOT17 decoder), else 2 (8 in
  // the tiny one); in bf16 2 groups of 8, else 1
  const int head_groups = c / heads / Group<T>::N;
  cudaError_t err;
  if constexpr (std::is_same<T, float>::value) {
    if (head_groups % 2) return (int)cudaErrorInvalidValue;
    err = head_groups % 4 == 0
              ? launch_sq<T, 4>(lv, wts, o, levels, h4, w4, c, heads, s)
              : launch_sq<T, 2>(lv, wts, o, levels, h4, w4, c, heads, s);
  } else {
    if (head_groups < 1) return (int)cudaErrorInvalidValue;
    err = head_groups % 2 == 0
              ? launch_sq<T, 2>(lv, wts, o, levels, h4, w4, c, heads, s)
              : launch_sq<T, 1>(lv, wts, o, levels, h4, w4, c, heads, s);
  }
  return (int)err;
}

}  // namespace

// Plain C entry points (bound with ctypes), one per element type: float32
// and bf16 (__nv_bfloat16) values, weights and output.  `values` is a host
// array of `levels` device pointers, `level_hw` a host array of (h_l, w_l)
// pairs and `dils` a host array of `levels` ints.  The wrapper
// (busca_tpu_torch/ops/lma_cuda.py) checks dtypes, shapes, 1 <= h_l <= h4
// and 1 <= w_l <= w4, (C / heads) % 8 == 0, 16-byte alignment and
// levels <= 8.  Each launches on `stream` and returns the cudaError_t of
// the launch (0 = success); it does not synchronize.
extern "C" int local_tap_sum_launch(const void* const* values,
                                    const int* level_hw, const int* dils,
                                    int levels, const void* weights, int h4,
                                    int w4, int c, int heads, void* out,
                                    void* stream) {
  return launch<float>(values, level_hw, dils, levels, weights, h4, w4, c,
                       heads, out, stream);
}

extern "C" int local_tap_sum_bf16_launch(const void* const* values,
                                         const int* level_hw, const int* dils,
                                         int levels, const void* weights,
                                         int h4, int w4, int c, int heads,
                                         void* out, void* stream) {
  return launch<__nv_bfloat16>(values, level_hw, dils, levels, weights, h4,
                               w4, c, heads, out, stream);
}
