// Kernel K2: the local multi-scale weighted-tap sum of TransCenter's decoder
// (LocalMultiScaleAttention), for Hopper (sm_90a).
//
//   out[p, c] = sum_{l < L, t < 9} w[p, c / head_dim, l*9 + t]
//                                  * V_l[p + dil_l * delta_t, c]
//
// with zeros outside the map and a float32 accumulator.  values are
// [L, H4, W4, C], weights [H4, W4, heads, L*9] (level-major, taps dy-outer /
// dx-inner over (-1, 0, 1)), out [H4, W4, C]; all float32, contiguous.
//
// Replaces the Pallas TPU kernel busca_tpu/ops/lma_pallas.py::_kernel
// (reached through lma_pallas.local_tap_sum), and computes the same function
// as lma_pallas.local_tap_sum_reference.  It computes the function, not the
// TPU blocks: no host-side dx-shifted copies of the values, no DMA row
// windows, no 0/1 head-to-lane matmul.  Those were Mosaic workarounds.
//
// Design: one thread computes 4 consecutive channels of one output pixel
// (float4 loads and one float4 store); at C = 256 a pixel takes 64 threads,
// and a block of 256 threads covers 4 neighbouring pixels of a row.  The
// thread walks the L*9 taps in the reference's order, reads its head's
// weight (the threads of one head read the same word: an L1 broadcast),
// skips a tap outside the map (the reference adds 0*w there), and
// accumulates acc = acc + v*w.
//
// Bound: bytes.  At the MOT17 shape (L=4, 160x272, C=256, 8 heads) the
// function reads the values once (178.3 MB) and the weights once (50.1 MB)
// and writes the output once (44.6 MB): 273.0 MB, 0.0815 ms at 3.35 TB/s.
// Its 36 multiply-adds per output element are 0.80 GFLOP, 0.012 ms at the
// float32 rate.  Each value element is read by up to 9 taps of its level; the
// neighbouring taps hit L1/L2, so the device-memory traffic stays near the
// bound only while a row band of the four level maps fits in cache.
//
// Rounding: build with -fmad=false, so that v*w is rounded before the add,
// as in the plain torch version (ops/lma.py::local_tap_sum_plain); with the
// same term order the two agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;

struct Dils {
  int d[kMaxLevels];
};

__global__ void local_tap_sum_kernel(
    const float* __restrict__ values, const float* __restrict__ weights,
    float* __restrict__ out, int levels, int h4, int w4, int c, int heads,
    Dils dils) {
  const int quads = c >> 2;  // float4 groups per pixel
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)h4 * w4 * quads;
  if (tid >= total) return;
  const int q = (int)(tid % quads);
  const long long pix = tid / quads;
  const int y = (int)(pix / w4);
  const int x = (int)(pix - (long long)y * w4);
  const int c0 = q << 2;
  const int head = c0 / (c / heads);
  const int taps = levels * 9;
  const float* wrow = weights + (pix * heads + head) * taps;
  const size_t plane = (size_t)h4 * w4 * c;

  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int l = 0; l < levels; ++l) {
    const int dil = dils.d[l];
    const float* vl = values + (size_t)l * plane;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int yy = y + (t / 3 - 1) * dil;
      const int xx = x + (t % 3 - 1) * dil;
      if (yy < 0 || yy >= h4 || xx < 0 || xx >= w4) continue;
      const float wt = __ldg(wrow + l * 9 + t);
      const float4 v = __ldg(reinterpret_cast<const float4*>(
          vl + ((size_t)yy * w4 + xx) * c + c0));
      acc.x = acc.x + v.x * wt;
      acc.y = acc.y + v.y * wt;
      acc.z = acc.z + v.z * wt;
      acc.w = acc.w + v.w * wt;
    }
  }
  *reinterpret_cast<float4*>(out + pix * c + c0) = acc;
}

}  // namespace

// Plain C entry point (bound with ctypes).  `dils` is a host array of
// `levels` ints.  The wrapper (busca_tpu_torch/ops/lma_cuda.py) checks
// shapes, C % 4 == 0, (C / heads) % 4 == 0, 16-byte alignment and
// levels <= 8.  Launches on `stream` and returns the cudaError_t of the
// launch (0 = success); it does not synchronize.
extern "C" int local_tap_sum_launch(
    const float* values, const float* weights, const int* dils, int levels,
    int h4, int w4, int c, int heads, float* out, void* stream) {
  if (levels <= 0 || levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  if (h4 <= 0 || w4 <= 0 || c <= 0) return 0;
  Dils d = {};
  for (int l = 0; l < levels; ++l) d.d[l] = dils[l];
  const int threads = 256;
  const long long total = (long long)h4 * w4 * (c / 4);
  const long long blocks = (total + threads - 1) / threads;
  local_tap_sum_kernel<<<(unsigned int)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
      values, weights, out, levels, h4, w4, c, heads, d);
  return (int)cudaGetLastError();
}
