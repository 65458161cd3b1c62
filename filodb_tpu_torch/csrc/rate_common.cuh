// Shared by the rate-family kernels (fused_rate.cu: K1, K3; fused_drops.cu:
// K2): the Prometheus extrapolation of one (series, window) cell and the
// window rows they read.  Each source includes it into its own anonymous
// namespace.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

// Prometheus extrapolated rate/increase/delta (ref: RateFunctions.scala
// 37-76) in the TPU kernel's f32 operation order, in two parts: what the
// window's sample times and count decide (rate_window), and what the
// row's values add (rate_finish).  A kernel that holds one window over
// many rows computes the first part once and reuses whatever of it a row
// shares.
struct RateWin {
  float dur_start;  // (t1 - ws) * 0.001
  float dur_end;    // (we - t2) * 0.001
  float sampled;    // max((t2 - t1) * 0.001, 1e-9)
  float threshold;  // avg_between * 1.1, avg_between = sampled / (n - 1)
  float half;       // avg_between / 2
  float span;       // max(we - ws, 1)
};

// threshold and half from avg_between = sampled / (n - 1)
__device__ __forceinline__ void rate_spacing(RateWin& k, float n) {
  const float avg_between = k.sampled / (n - 1.0f);
  k.threshold = avg_between * 1.1f;
  k.half = avg_between / 2.0f;
}

__device__ __forceinline__ RateWin rate_window(float t1, float t2, float n,
                                               float ws, float we) {
  RateWin k;
  // ms to s as a multiply by the f32 reciprocal, as the reference's
  // compiled `/ 1000.0` is (the plain version, ops/fused._extrapolate)
  k.dur_start = (t1 - ws) * 0.001f;
  k.dur_end = (we - t2) * 0.001f;
  const float sampled = (t2 - t1) * 0.001f;
  k.sampled = (sampled < 1e-9f) ? 1e-9f : sampled;  // max, NaN propagates
  rate_spacing(k, n);
  const float span = we - ws;
  k.span = (span < 1.0f) ? 1.0f : span;
  return k;
}

__device__ __forceinline__ float rate_finish(const RateWin& k, float v1,
                                             float v2, float vb,
                                             int is_counter, int is_rate) {
  float dur_start = k.dur_start;
  const float delta = v2 - v1;
  if (is_counter) {
    const float va = v1 + vb;  // absolute first value
    const float den = (delta == 0.0f) ? INFINITY : delta;
    const float dur_zero = k.sampled * (va / den);
    if (delta > 0.0f && va >= 0.0f && dur_zero < dur_start) {
      dur_start = dur_zero;
    }
  }
  float extrap = k.sampled + ((dur_start < k.threshold) ? dur_start : k.half);
  extrap = extrap + ((k.dur_end < k.threshold) ? k.dur_end : k.half);
  float out = delta * (extrap / k.sampled);
  if (is_rate) out = out / k.span * 1000.0f;
  return out;
}

__device__ __forceinline__ float rate_one(float v1, float v2, float t1,
                                          float t2, float n, float ws,
                                          float we, float vb, int is_counter,
                                          int is_rate) {
  return rate_finish(rate_window(t1, t2, n, ws, we), v1, v2, vb, is_counter,
                     is_rate);
}

struct WindowRows {
  const int* idx1;
  const int* idx2;
  const float* t1;
  const float* t2;
  const float* n;
  const float* ws;
  const float* we;
  const float* tsrow;
};

}  // namespace
