// Kernel K1: fused crop + mean-pad + INTER_LINEAR resize (+ normalize, flip)
// for a batch of ltrb boxes of one uint8 HWC frame, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel busca_tpu/ops/crop_pallas.py:50
// (_crop_kernel, reached through _crop_pallas / crop_resize_pallas), and
// computes the same function as busca_tpu_torch/ops/crop.py::
// crop_resize_normalize_plain.  It computes the function, not the TPU blocks:
// no int8 bitcast, no 64-row windows, no [Wp, OW] one-hot matmul, no VMEM
// budget, and no integral image.
//
// The op is two launches on one stream, and nothing else runs around them:
// - Kernel P (crop_resize_pad_sum_kernel), grid (kPadSplits, N): the exact
//   integer sum of the clipped region of each box whose cutout leaves the
//   frame.  Only those boxes use their pad value.  For a cutout inside the
//   frame the one tap outside its clip is x0 + 1 == x2 (or y0 + 1 == y2),
//   reached only at ax == x2 - 1 exactly, where fx == 0: the pad is
//   multiplied by an exact 0 (tests/test_torch_crop.py pins this on the
//   plain version).  So a block of an inside or invalid box returns at once,
//   and the letterbox (box [0, 0, W, H]) sums nothing.  A block sums the
//   box's rows y = cy1 + blockIdx.x + k * kPadSplits in aligned 16-byte
//   loads (masked at a row's ends), with dp4a into 32-bit per-thread sums
//   and a 64-bit warp-shuffle reduction, and writes one partial to
//   scratch[n, blockIdx.x].  All integer: the total is exact and does not
//   depend on the order (a 4K frame of 255s under one box sums to 6.35e9,
//   above 2**32).
// - Kernel R (crop_resize_kernel), grid (ceil(OH * ceil(OW/4) / 128), N),
//   128 threads: the resample.  A block of a padded box first reduces the
//   box's kPadSplits partials in one warp and forms the pad value as the
//   plain version does: mean = (float)total / ((float)cnt * 3.0f), truncated
//   under quantize; other boxes pad with 0.  A thread computes 4 consecutive
//   output pixels of one row: the box geometry and the y taps once, then per
//   pixel the x taps, the blend, rounding and clipping under quantize, zeros
//   for invalid boxes, the GHOST normalization and the BGR->RGB flip.
//
// Both kernels derive each box's integers from the float32 boxes with the
// plain version's rule (ops/crop.py::box_params): x1 = floor(b0), y1 =
// floor(b1), x2 = ceil(b2), y2 = ceil(b3), the clip bounds clamped to
// [0, W] and [0, H], cnt = max(cy2 - cy1, 0) * max(cx2 - cx1, 0), valid =
// hc > 0 && wc > 0 && cnt > 0.  As there, the integers are 64-bit until the
// clip, the extents and the validity are formed, and x1, y1, wc, hc are then
// wrapped to 32 bits (floor -> int64 -> int32), so that any float32 box gives
// the plain version's geometry: a lost track's Kalman box 5.4e10 pixels wide
// crops to its pad mean on both.  A tap position is clamped to [-2, W] (to
// [-2, H] in y) before its 32-bit tests, which keeps every inside/outside
// decision and cannot overflow.
//
// Bound: the op moves bytes and does little arithmetic.  At the smoke shape
// (N = 64 boxes of one 1080x1920 frame, 384x128 crops) it writes
// 64*384*128*3*4 B = 37.7 MB and reads the frame pixels the boxes cover,
// 42.3 MB in all: 0.0126 ms at 3.35 TB/s; the letterbox (1080x1920 ->
// 612x1088) moves 14.2 MB, 0.0042 ms (chip_smoke.py::bound_ms).  The writes
// dominate the bytes.  What the design does:
// - a thread's 12 float32 values go out as three 16-byte stores (when
//   OW % 4 == 0, as 384x128 and 612x1088 are; a ragged row tail stores
//   scalars in the same kernel);
// - the box's integers and the y taps are computed once per thread, for 4
//   pixels;
// - a tap pair (x0, x0 + 1) inside the clip is 6 contiguous bytes, read as
//   two or three aligned 4-byte words and split with byte permutes; bytes
//   become floats as (2**23 + b) - 2**23, full-rate adds in place of the
//   quarter-rate int-to-float conversion.  On an H100 this takes the
//   letterbox from 0.0113 to 0.0102 ms on the device and leaves 64 crops at
//   0.035 ms, against one __ldg per tap byte (PERF.md section 6); a tap at
//   the clip's edge is still read on its own;
// - the frame (6.2 MB at 1080p) stays in the 50 MB L2 across the boxes.
// Staging a warp's stores in shared memory, so that each store is a whole
// 512-byte run, did not make R faster (PERF.md section 6) and was cut.
// What holds R above the bound is the frame's reads and the per-pixel work,
// not the stores: tools/k1_ablations.py times copies built with
// -D K1_NO_READS=1 and -D K1_NO_STORES=1 (the op is built with neither).
//
// Rounding: build with -fmad=false, so that no multiply-add is contracted and
// every float32 operation rounds as in the plain torch version
// (ops/crop.py::crop_resize_plain): sampling, blend, rounding and
// normalization repeat its operation order, and the scale is hc * (1/OH) as
// torch on CUDA and XLA divide by a constant.  The result equals the plain
// version bit for bit.  Division and rintf are IEEE (round half to even).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPadSplits = 32;   // blocks of kernel P per box
constexpr int kSumThreads = 256;
constexpr int kThreads = 128;    // kernel R
constexpr int kPx = 4;           // output pixels of one row per thread
static_assert(kPx == 4, "the stores take a thread's 12 floats as 3 float4");

// Ablation switches (see the note above); 0 in the op.
#ifndef K1_NO_READS
#define K1_NO_READS 0
#endif
#ifndef K1_NO_STORES
#define K1_NO_STORES 0
#endif

struct Box {
  int x1, y1, wc, hc, cx1, cx2, cy1, cy2;
  long long cnt;
  bool valid;
  bool padded;  // valid, and the cutout leaves the frame: the pad is used
};

// The low 32 bits of v as an int (the plain version's int64 -> int32).
__device__ __forceinline__ int wrap32(long long v) {
  return (int)(unsigned)(unsigned long long)v;
}

// v - u in 64 bits, wrapping as the plain version's int64 tensors do.
__device__ __forceinline__ long long sub64(long long v, long long u) {
  return (long long)((unsigned long long)v - (unsigned long long)u);
}

__device__ __forceinline__ int clip64(long long v, int hi) {
  return (int)min(max(v, 0LL), (long long)hi);
}

// A tap's integer position, clamped to [-2, n]: positions below -1 or
// above n - 1 are outside every clip [c1, c2) within [0, n] either way.
__device__ __forceinline__ int tap_position(float f, int n) {
  return (int)min(max((long long)f, -2LL), (long long)n);
}

__device__ __forceinline__ Box box_geometry(const float* __restrict__ boxes,
                                            int n, int h, int w) {
  const float* b = boxes + 4 * (size_t)n;
  const long long x1 = (long long)floorf(__ldg(b + 0));
  const long long y1 = (long long)floorf(__ldg(b + 1));
  const long long x2 = (long long)ceilf(__ldg(b + 2));
  const long long y2 = (long long)ceilf(__ldg(b + 3));
  const long long wc = sub64(x2, x1), hc = sub64(y2, y1);
  Box g;
  g.x1 = wrap32(x1);
  g.y1 = wrap32(y1);
  g.wc = wrap32(wc);
  g.hc = wrap32(hc);
  g.cx1 = clip64(x1, w);
  g.cx2 = clip64(x2, w);
  g.cy1 = clip64(y1, h);
  g.cy2 = clip64(y2, h);
  g.cnt = (long long)max(g.cy2 - g.cy1, 0) * max(g.cx2 - g.cx1, 0);
  g.valid = hc > 0 && wc > 0 && g.cnt > 0;
  g.padded = g.valid && !(x1 >= 0 && y1 >= 0 && x2 <= w && y2 <= h);
  return g;
}

// v with the bytes at addresses outside [lo, hi) zeroed (v sits at a).
__device__ __forceinline__ unsigned keep_bytes(unsigned v, uintptr_t a,
                                               uintptr_t lo, uintptr_t hi) {
  const long long from = min(max((long long)lo - (long long)a, 0LL), 4LL);
  const long long to = min(max((long long)hi - (long long)a, 0LL), 4LL);
  const unsigned long long m =
      ((1ull << (8 * to)) - 1) & ~((1ull << (8 * from)) - 1);
  return v & (unsigned)m;
}

__global__ void __launch_bounds__(kSumThreads) crop_resize_pad_sum_kernel(
    const uint8_t* __restrict__ frame, int h, int w,
    const float* __restrict__ boxes, unsigned long long* __restrict__ partial) {
  const int n = blockIdx.y;
  const Box g = box_geometry(boxes, n, h, w);
  if (!g.padded) return;  // kernel R reads this box's partials only if padded

  // this block's rows y = cy1 + blockIdx.x + k * kPadSplits, k < rows; a
  // row's span touches at most `chunks` aligned 16-byte chunks; the (row,
  // chunk) items are spread over the threads so that loads of many rows are
  // in flight together
  const int span = (g.cx2 - g.cx1) * 3;
  const int chunks = (span + 15) / 16 + 1;
  const int left = g.cy2 - g.cy1 - (int)blockIdx.x;
  const int rows = left > 0 ? (left + kPadSplits - 1) / kPadSplits : 0;
  const int items = rows * chunks;
  const unsigned ones = 0x01010101u;
  // a thread adds about (h / 32) * (3 * w / 16) / 256 chunks of at most
  // 16 * 255, ~0.093 * h * w in all: 32 bits hold that below ~4.6e10 pixels
  unsigned sum = 0;
#pragma unroll 4
  for (int i = threadIdx.x; i < items; i += kSumThreads) {
    const int k = i / chunks;
    const int c = i - k * chunks;
    const int y = g.cy1 + (int)blockIdx.x + k * kPadSplits;
    const uintptr_t lo =
        (uintptr_t)frame + ((size_t)y * w + g.cx1) * 3;
    const uintptr_t hi = lo + span;
    // an aligned chunk that holds a byte of the frame lies in its allocation
    const uintptr_t a = (lo & ~(uintptr_t)15) + 16 * (uintptr_t)c;
    if (a < hi) {
      uint4 v = __ldg(reinterpret_cast<const uint4*>(a));
      if (a < lo || a + 16 > hi) {
        v.x = keep_bytes(v.x, a, lo, hi);
        v.y = keep_bytes(v.y, a + 4, lo, hi);
        v.z = keep_bytes(v.z, a + 8, lo, hi);
        v.w = keep_bytes(v.w, a + 12, lo, hi);
      }
      sum = __dp4a(v.x, ones, sum);
      sum = __dp4a(v.y, ones, sum);
      sum = __dp4a(v.z, ones, sum);
      sum = __dp4a(v.w, ones, sum);
    }
  }
  unsigned long long acc = sum;
#pragma unroll
  for (int off = 16; off; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  __shared__ unsigned long long warp_sum[kSumThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
#pragma unroll
    for (int i = 0; i < kSumThreads / 32; ++i) total += warp_sum[i];
    partial[(size_t)n * kPadSplits + blockIdx.x] = total;
  }
}

// byte k of word as a float, exactly: the bits of 2**23 + b, minus 2**23
__device__ __forceinline__ float byte_float(unsigned word, unsigned k) {
  return __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7440u + k)) -
         8388608.0f;
}

__global__ void __launch_bounds__(kThreads) crop_resize_kernel(
    const uint8_t* __restrict__ frame, int h, int w,
    const float* __restrict__ boxes,
    const unsigned long long* __restrict__ partial,
    float* __restrict__ out, int oh, int ow,
    int quantize, int normalize, int flip,
    float m0, float m1, float m2, float s0, float s1, float s2) {
  const int n = blockIdx.y;
  const Box g = box_geometry(boxes, n, h, w);

  __shared__ float pad_shared;
  float pad = 0.0f;
  if (g.padded) {  // the same for every thread of the block
    if (threadIdx.x < 32) {
      unsigned long long t = 0;
      for (int s = threadIdx.x; s < kPadSplits; s += 32)
        t += partial[(size_t)n * kPadSplits + s];
#pragma unroll
      for (int off = 16; off; off >>= 1)
        t += __shfl_down_sync(0xffffffffu, t, off);
      if (threadIdx.x == 0) {
        const float mean = (float)t / ((float)g.cnt * 3.0f);
        pad_shared = quantize ? truncf(mean) : mean;
      }
    }
    __syncthreads();
    pad = pad_shared;
  }

  const int per_row = (ow + kPx - 1) / kPx;  // thread groups per output row
  const int groups = oh * per_row;
  const int grp = blockIdx.x * kThreads + threadIdx.x;
  const bool active = grp < groups;
  const int r = grp / per_row;
  const int c0 = (grp - r * per_row) * kPx;

  float v[kPx][3];
#pragma unroll
  for (int j = 0; j < kPx; ++j) v[j][0] = v[j][1] = v[j][2] = 0.0f;

  if (active && g.valid) {
    // cv2 INTER_LINEAR half-pixel source coordinate, edge-clamped, in
    // absolute frame coordinates (the op order of the plain _axis_taps);
    // hc / oh as a multiplication by the float32 reciprocal
    const float hf = (float)g.hc, wf = (float)g.wc;
    float sy = ((float)r + 0.5f) * (hf * (1.0f / (float)oh)) - 0.5f;
    sy = fminf(fmaxf(sy, 0.0f), fmaxf(hf - 1.0f, 0.0f));
    const float ay = (float)g.y1 + sy;
    const float y0f = floorf(ay);
    const int y0 = tap_position(y0f, h);
    const float fy = ay - y0f, gy = 1.0f - fy;
    bool in_y[2];
    const uint8_t* row[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      in_y[i] = y0 + i >= g.cy1 && y0 + i < g.cy2;
      row[i] = frame + (size_t)min(max(y0 + i, 0), h - 1) * w * 3;
    }

    const float xscale = wf * (1.0f / (float)ow);
    const float xmax = fmaxf(wf - 1.0f, 0.0f), x1f = (float)g.x1;
    int x0[kPx];
    float fx[kPx];
#pragma unroll
    for (int j = 0; j < kPx; ++j) {
      float sx = ((float)(c0 + j) + 0.5f) * xscale - 0.5f;
      sx = fminf(fmaxf(sx, 0.0f), xmax);
      const float ax = x1f + sx;
      const float x0f = floorf(ax);
      x0[j] = tap_position(x0f, w);
      fx[j] = ax - x0f;
    }

    // A tap pair inside the clip is 6 contiguous bytes: read them as
    // aligned words (predicated, all pairs at once), split them below.
    bool pair[2][kPx];
    unsigned lo[2][kPx], hi[2][kPx];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < kPx; ++j) {
        pair[i][j] = !K1_NO_READS && in_y[i] && x0[j] >= g.cx1 &&
                     x0[j] + 1 < g.cx2;
        unsigned w0 = 0, w1 = 0, w2 = 0, o = 0;
        if (pair[i][j]) {
          const uintptr_t p = (uintptr_t)(row[i] + 3 * (size_t)x0[j]);
          o = (unsigned)(p & 3);
          const unsigned* wp = reinterpret_cast<const unsigned*>(p - o);
          w0 = __ldg(wp);
          w1 = __ldg(wp + 1);
          if (o > 2) w2 = __ldg(wp + 2);
        }
        const unsigned sel = 0x3210u + 0x1111u * o;  // bytes o .. o + 3
        lo[i][j] = __byte_perm(w0, w1, sel);
        hi[i][j] = __byte_perm(w1, w2, sel);
      }
    }

#pragma unroll
    for (int j = 0; j < kPx; ++j) {
      if (c0 + j >= ow) break;  // ragged row tail
      float tap[2][2][3];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (pair[i][j]) {
          tap[i][0][0] = byte_float(lo[i][j], 0);
          tap[i][0][1] = byte_float(lo[i][j], 1);
          tap[i][0][2] = byte_float(lo[i][j], 2);
          tap[i][1][0] = byte_float(lo[i][j], 3);
          tap[i][1][1] = byte_float(hi[i][j], 0);
          tap[i][1][2] = byte_float(hi[i][j], 1);
        } else {  // the clip's edge: each tap on its own, pad outside
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int xx = x0[j] + e;
            const bool inside =
                !K1_NO_READS && in_y[i] && xx >= g.cx1 && xx < g.cx2;
            const uint8_t* px = row[i] + 3 * (size_t)min(max(xx, 0), w - 1);
#pragma unroll
            for (int ch = 0; ch < 3; ++ch)
              tap[i][e][ch] = inside ? (float)__ldg(px + ch) : pad;
          }
        }
      }
      const float gx = 1.0f - fx[j];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        // ((v00*(1-fy))*(1-fx) + (v01*(1-fy))*fx) + (v10*fy)*(1-fx) + ...
        float o = tap[0][0][ch] * gy * gx;
        o = o + tap[0][1][ch] * gy * fx[j];
        o = o + tap[1][0][ch] * fy * gx;
        o = o + tap[1][1][ch] * fy * fx[j];
        if (quantize) o = fminf(fmaxf(rintf(o), 0.0f), 255.0f);
        v[j][ch] = o;
      }
    }
  }

  // epilogue: output channel k takes input channel flip ? 2 - k : k
  const float mean_in[3] = {m0, m1, m2}, std_in[3] = {s0, s1, s2};
  float res[kPx * 3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float mk = flip ? mean_in[2 - k] : mean_in[k];
    const float sk = flip ? std_in[2 - k] : std_in[k];
#pragma unroll
    for (int j = 0; j < kPx; ++j) {
      float o = flip ? v[j][2 - k] : v[j][k];
      if (normalize) o = (o / 255.0f - mk) / sk;
      res[3 * j + k] = o;
    }
  }

#if K1_NO_STORES
#pragma unroll
  for (int i = 0; i < 3 * kPx; ++i) asm volatile("" ::"f"(res[i]));
  return;
#endif
  if (!active) return;
  if (ow % kPx == 0 && ((uintptr_t)out & 15) == 0) {
    // the box's output is flat: group grp holds pixels 4 grp .. 4 grp + 3
    float4* dst = reinterpret_cast<float4*>(out + (size_t)n * oh * ow * 3);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      dst[(size_t)grp * 3 + k] = make_float4(res[4 * k], res[4 * k + 1],
                                             res[4 * k + 2], res[4 * k + 3]);
  } else {
    float* dst = out + (((size_t)n * oh + r) * ow + c0) * 3;
#pragma unroll
    for (int j = 0; j < kPx; ++j) {
      if (c0 + j >= ow) break;
#pragma unroll
      for (int k = 0; k < 3; ++k) dst[3 * j + k] = res[3 * j + k];
    }
  }
}

}  // namespace

// The number of int64 scratch words crop_resize_launch needs per box.
extern "C" int crop_resize_scratch_per_box() { return kPadSplits; }

// Plain C entry point (bound with ctypes).  boxes: float32 [n, 4] ltrb;
// scratch: crop_resize_scratch_per_box() * n words, allocated by the caller;
// out: float32 [n, oh, ow, 3].  Launches kernels P and R on `stream`,
// does not synchronize, and returns the cudaError_t of the launches (0 =
// success).
extern "C" int crop_resize_launch(
    const uint8_t* frame, int h, int w, const float* boxes, int n,
    unsigned long long* scratch, float* out, int oh, int ow,
    int quantize, int normalize, int flip,
    float m0, float m1, float m2, float s0, float s1, float s2,
    void* stream) {
  if (n <= 0 || oh <= 0 || ow <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  crop_resize_pad_sum_kernel<<<dim3(kPadSplits, n), kSumThreads, 0, st>>>(
      frame, h, w, boxes, scratch);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int groups = oh * ((ow + kPx - 1) / kPx);
  crop_resize_kernel<<<dim3((groups + kThreads - 1) / kThreads, n), kThreads, 0, st>>>(
      frame, h, w, boxes, scratch, out, oh, ow, quantize, normalize, flip,
      m0, m1, m2, s0, s1, s2);
  return (int)cudaGetLastError();
}
