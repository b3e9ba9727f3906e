// Kernel K1: fused crop + mean-pad + INTER_LINEAR resize (+ normalize, flip)
// for a batch of boxes of one uint8 HWC frame, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel busca_tpu/ops/crop_pallas.py::_crop_kernel
// (reached through _crop_pallas / crop_resize_pallas), and computes the same
// function as busca_tpu/ops/crop.py::crop_resize_normalize.  It computes the
// function, not the TPU blocks: no int8 bitcast, no 64-row windows, no
// [Wp, OW] one-hot matmul, no VMEM budget.
//
// Design: one thread per output pixel of one box, grid (ceil(OH*OW/256), N).
// The wrapper (busca_tpu_torch/ops/crop_cuda.py) computes each box's integer
// geometry and pad value with torch from the exact int64 integral image
// (iparams[N, 9] = x1, y1, wc, hc, cx1, cx2, cy1, cy2, valid; pad[N]).  A
// thread reads its box's parameters and the four bilinear taps of the frame
// through __ldg, blends, rounds and clips under quantize, zeroes invalid
// boxes, then applies the GHOST normalization and the BGR->RGB flip in the
// epilogue and writes float32 NHWC.
//
// Bound: the op moves bytes, it does little arithmetic.  At the smoke shape
// (N=64 boxes of one 1080x1920 frame, 384x128 crops) it writes
// 64*384*128*3*4 B = 37.7 MB and reads at most the 6.2 MB frame (which sits
// in the 50 MB L2), about 44 MB: ~13 us at 3.35 TB/s.  The writes dominate;
// each warp writes 32 consecutive pixels of one output row.
//
// Rounding: build with -fmad=false, so that no multiply-add is contracted and
// every float32 operation rounds as in the plain torch version
// (ops/crop.py::crop_resize_plain); the uint8 rounding then matches bit for
// bit.  Division and rintf are IEEE (round half to even) by default.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void crop_resize_kernel(
    const uint8_t* __restrict__ frame, int h, int w,
    const int* __restrict__ iparams, const float* __restrict__ pad,
    float* __restrict__ out, int oh, int ow,
    int quantize, int normalize, int flip,
    float m0, float m1, float m2, float s0, float s1, float s2) {
  const int n = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= oh * ow) return;
  const int r = p / ow;
  const int c = p - r * ow;

  const int* ip = iparams + 9 * n;
  const int x1 = __ldg(ip + 0), y1 = __ldg(ip + 1);
  const int wc = __ldg(ip + 2), hc = __ldg(ip + 3);
  const int cx1 = __ldg(ip + 4), cx2 = __ldg(ip + 5);
  const int cy1 = __ldg(ip + 6), cy2 = __ldg(ip + 7);
  const int valid = __ldg(ip + 8);
  const float pad_val = __ldg(pad + n);

  float v[3] = {0.0f, 0.0f, 0.0f};
  if (valid) {
    // cv2 INTER_LINEAR half-pixel source coordinate, edge-clamped, in
    // absolute frame coordinates (same op order as _axis_taps).
    // hc / oh as XLA evaluates a division by a constant: times the float32
    // reciprocal (the plain version and busca_tpu round the same way)
    const float hf = (float)hc, wf = (float)wc;
    float sy = ((float)r + 0.5f) * (hf * (1.0f / (float)oh)) - 0.5f;
    float sx = ((float)c + 0.5f) * (wf * (1.0f / (float)ow)) - 0.5f;
    sy = fminf(fmaxf(sy, 0.0f), fmaxf(hf - 1.0f, 0.0f));
    sx = fminf(fmaxf(sx, 0.0f), fmaxf(wf - 1.0f, 0.0f));
    const float ay = (float)y1 + sy;
    const float ax = (float)x1 + sx;
    const float y0f = floorf(ay), x0f = floorf(ax);
    const int y0 = (int)y0f, x0 = (int)x0f;
    const float fy = ay - y0f, fx = ax - x0f;

    const int yy[2] = {y0, y0 + 1};
    const int xx[2] = {x0, x0 + 1};
    float tap[2][2][3];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool in_y = yy[i] >= cy1 && yy[i] < cy2;
      const int ys = min(max(yy[i], 0), h - 1);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool inside = in_y && xx[j] >= cx1 && xx[j] < cx2;
        const int xs = min(max(xx[j], 0), w - 1);
        const uint8_t* px = frame + ((size_t)ys * w + xs) * 3;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          tap[i][j][ch] = inside ? (float)__ldg(px + ch) : pad_val;
      }
    }
    const float gy = 1.0f - fy, gx = 1.0f - fx;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      // ((v00*(1-fy))*(1-fx) + (v01*(1-fy))*fx) + (v10*fy)*(1-fx) + ...
      float o = tap[0][0][ch] * gy * gx;
      o = o + tap[0][1][ch] * gy * fx;
      o = o + tap[1][0][ch] * fy * gx;
      o = o + tap[1][1][ch] * fy * fx;
      if (quantize) o = fminf(fmaxf(rintf(o), 0.0f), 255.0f);
      v[ch] = o;
    }
  }

  float* dst = out + (((size_t)n * oh + r) * ow + c) * 3;
  const float mean[3] = {m0, m1, m2};
  const float stdv[3] = {s0, s1, s2};
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float o = v[ch];
    if (normalize) o = (o / 255.0f - mean[ch]) / stdv[ch];
    dst[flip ? 2 - ch : ch] = o;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream` and returns
// the cudaError_t of the launch (0 = success); it does not synchronize.
extern "C" int crop_resize_launch(
    const uint8_t* frame, int h, int w, const int* iparams, const float* pad,
    int n, float* out, int oh, int ow, int quantize, int normalize, int flip,
    float m0, float m1, float m2, float s0, float s1, float s2,
    void* stream) {
  if (n <= 0 || oh <= 0 || ow <= 0) return 0;
  const int threads = 256;
  dim3 grid((oh * ow + threads - 1) / threads, n);
  crop_resize_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      frame, h, w, iparams, pad, out, oh, ow, quantize, normalize, flip,
      m0, m1, m2, s0, s1, s2);
  return (int)cudaGetLastError();
}
