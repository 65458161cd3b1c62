// Shared by the rate-family kernels (fused_rate.cu: K1, K3; fused_drops.cu:
// K2): the Prometheus extrapolation of one (series, window) cell, the
// ragged boundary search, and the window rows they read.  Each source
// includes it into its own anonymous namespace.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

// Prometheus extrapolated rate/increase/delta (ref: RateFunctions.scala
// 37-76) in the TPU kernel's f32 operation order.
__device__ __forceinline__ float rate_one(float v1, float v2, float t1,
                                          float t2, float n, float ws,
                                          float we, float vb, int is_counter,
                                          int is_rate) {
  float dur_start = (t1 - ws) / 1000.0f;
  float dur_end = (we - t2) / 1000.0f;
  float sampled = (t2 - t1) / 1000.0f;
  sampled = (sampled < 1e-9f) ? 1e-9f : sampled;  // max, NaN propagates
  float avg_between = sampled / (n - 1.0f);
  float delta = v2 - v1;
  if (is_counter) {
    float va = v1 + vb;  // absolute first value
    float den = (delta == 0.0f) ? INFINITY : delta;
    float dur_zero = sampled * (va / den);
    if (delta > 0.0f && va >= 0.0f && dur_zero < dur_start) {
      dur_start = dur_zero;
    }
  }
  float threshold = avg_between * 1.1f;
  float half = avg_between / 2.0f;
  float extrap = sampled + ((dur_start < threshold) ? dur_start : half);
  extrap = extrap + ((dur_end < threshold) ? dur_end : half);
  float out = delta * (extrap / sampled);
  if (is_rate) {
    float span = we - ws;
    span = (span < 1.0f) ? 1.0f : span;
    out = out / span * 1000.0f;
  }
  return out;
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

// The rate over a row's first and last VALID (non-NaN) sample inside
// the window slots i1..i2, and whether it has at least two (the
// reference's fill scans select the same samples).  `row` may point to
// device or shared memory.
__device__ __forceinline__ bool ragged_rate(const float* row, int i1, int i2,
                                            const float* tsrow, float ws,
                                            float we, float vb,
                                            int is_counter, int is_rate,
                                            float* rate) {
  int nv = 0, j1 = -1, j2 = -1;
  for (int j = i1; j <= i2; ++j) {
    const float x = row[j];
    if (x == x) {
      if (j1 < 0) j1 = j;
      j2 = j;
      ++nv;
    }
  }
  if (nv < 2) return false;
  *rate = rate_one(row[j1], row[j2], tsrow[j1], tsrow[j2], (float)nv, ws,
                   we, vb, is_counter, is_rate);
  return true;
}

}  // namespace
