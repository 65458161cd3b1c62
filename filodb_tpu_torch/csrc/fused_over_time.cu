// Fused last_over_time (K4) and sum/avg/count_over_time (K5) over one
// shared scrape grid, dense and ragged, in group-sum mode and in
// per-series mode (K6), for NVIDIA Hopper (sm_90a).
//
// Replaces: filodb_tpu/ops/pallas_fused.py::_kernel, the last_over_time
// branch (:478-509, gather form) and the over_time band branch
// (:510-542), each followed by the _epilogue (:652) in group mode
// (:666-684) or per-series mode (:661-665).
//
// What each (series, window) cell computes, with m = min(n1, 1) and n1
// the window's true slot count (0 for an empty window):
//   last, dense:   v[idx2] * m + vb * m
//   last, ragged:  ((v[idx2] valid ? v[idx2] : 0) + vb) * p, with the
//                  presence p = valid(v[idx2]) * m: a NaN in the newest
//                  slot is a staleness marker (absent), not a hole to skip
//   sum:           s + vb * n        s = the window's slots idx1..idx2
//   avg:           s / max(n, 1) + vb            added in slot order
//   count:         n
// Dense: n = n1.  Ragged: NaN slots are zeroed and n counts the valid
// ones; presence is n > 0 (sum, avg — avg is multiplied by it, so no
// base leaks into absent cells) or slot-based n1 > 0 (count).
//
// Bound on the H100: memory.  The windows of a 5 m range on a 1 m grid
// overlap five times, so every row's span of slots is read once from
// DRAM and about five times from L1/L2: about S x 690 x 4 B, 2.9 GB at
// 1,048,576 series x 720 samples, 0.86 ms at 3.35 TB/s.  K5 issues ~30
// loads per (series, window), fifteen times K4's, but neighbouring
// threads read overlapping spans of one row, so most of them hit L1.
//
// Design.  Group mode has the same layout and the same deterministic
// order as the rate kernels (fused_rate.cu): one block per CSR chunk of
// at most 256 rows, one thread per window, rows walked in chunk order
// and summed without atomics, then group_reduce adds each group's chunk
// partials in chunk order (a second plane carries the ragged presence).
// Per-series mode runs one thread per (series, window) cell,
// neighbouring threads on neighbouring windows of one row.  A window's
// slots are added in ascending order starting from +0.0; the plain torch
// version in ops/fused.py does the same adds (its +0.0 adds for slots
// past idx2 leave the bits unchanged), so, built with --fmad=false, the
// two agree to the last bit.  FP32 throughout, no tensor cores.  What is
// left for later: staging a row's span in shared memory once for all
// its windows, instead of ~30 loads per cell.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fused_common.cuh"

namespace {

enum Kind { kLast = 0, kSum = 1, kAvg = 2, kCount = 3 };

struct SlotRows {
  const int* idx1;
  const int* idx2;
  const float* n1;
};

// One (series, window) cell: its value and its presence (1 when dense).
__device__ __forceinline__ void cell(const float* row, float vb, int i1,
                                     int i2, float n1, int kind, int ragged,
                                     float* out, float* pres) {
  if (kind == kLast) {
    const float m = fminf(n1, 1.0f);
    const float x = row[i2];
    if (!ragged) {
      *out = x * m + vb * m;
      *pres = 1.0f;
      return;
    }
    const bool ok = x == x;
    const float p = (ok ? 1.0f : 0.0f) * m;
    *out = ((ok ? x : 0.0f) + vb) * p;
    *pres = p;
    return;
  }
  float s = 0.0f, c = 0.0f;
  if (n1 > 0.0f) {
#pragma unroll 4
    for (int j = i1; j <= i2; ++j) {
      const float x = row[j];
      if (ragged) {
        if (x == x) {
          s += x;
          c += 1.0f;
        }
      } else {
        s += x;
      }
    }
  }
  const float n = ragged ? c : n1;
  float o;
  if (kind == kSum) {
    o = s + vb * n;
  } else if (kind == kAvg) {
    o = s / fmaxf(n, 1.0f) + vb;
  } else {
    o = n;
  }
  float p = 1.0f;
  if (ragged) {
    if (kind == kCount) {
      p = (n1 > 0.0f) ? 1.0f : 0.0f;
    } else {
      p = (c > 0.0f) ? 1.0f : 0.0f;
      if (kind == kAvg) o = o * p;
    }
  }
  *out = o;
  *pres = p;
}

__global__ void slot_chunks(const float* __restrict__ vals, long long stride,
                            const float* __restrict__ vbase,
                            const int* __restrict__ order,
                            const int* __restrict__ chunk_lo,
                            const int* __restrict__ chunk_hi, SlotRows sr,
                            int W, int kind, int ragged, long long n_chunks,
                            float* __restrict__ partial) {
  const int c = blockIdx.x;
  const int lo = chunk_lo[c];
  const int hi = chunk_hi[c];
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    const int i1 = sr.idx1[w];
    const int i2 = sr.idx2[w];
    const float n1 = sr.n1[w];
    float acc = 0.0f, pacc = 0.0f;
    for (int i = lo; i < hi; ++i) {
      const long long r = order[i];
      float o, p;
      cell(vals + r * stride, vbase[r], i1, i2, n1, kind, ragged, &o, &p);
      acc += o;
      pacc += p;
    }
    partial[(long long)c * W + w] = acc;
    if (ragged) partial[(n_chunks + c) * W + w] = pacc;
  }
}

__global__ void slot_series(const float* __restrict__ vals, long long stride,
                            const float* __restrict__ vbase,
                            long long num_rows, SlotRows sr, int W, int kind,
                            int ragged, float* __restrict__ out,
                            float* __restrict__ pres) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= num_rows * W) return;
  const long long r = t / W;
  const int w = (int)(t - r * W);
  float o, p;
  cell(vals + r * stride, vbase[r], sr.idx1[w], sr.idx2[w], sr.n1[w], kind,
       ragged, &o, &p);
  out[t] = o;
  if (ragged) pres[t] = p;
}

}  // namespace

extern "C" {

// K4 (kind 0) and K5 (kinds 1-3: sum, avg, count), group mode.  vals
// [rows, stride] f32, vbase [rows] f32, order [N] int32 CSR rows,
// chunk_lo/chunk_hi [n_chunks] int32, gco [Gp + 1] int32, idx1/idx2 [W]
// int32, n1 [W] f32, partial [planes, n_chunks, W] f32 scratch, out
// [planes, Gp, W] f32 with planes = 2 when ragged (plane 1 the presence
// sums), else 1.  Returns cudaGetLastError().
int fused_over_time_launch(const float* vals, long long stride,
                           const float* vbase, const int* order,
                           const int* chunk_lo, const int* chunk_hi,
                           long long n_chunks, const int* gco, int Gp,
                           const int* idx1, const int* idx2, const float* n1,
                           int W, int kind, int ragged, float* partial,
                           float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  SlotRows sr{idx1, idx2, n1};
  if (n_chunks > 0) {
    slot_chunks<<<(unsigned)n_chunks, block_for(W), 0, s>>>(
        vals, stride, vbase, order, chunk_lo, chunk_hi, sr, W, kind, ragged,
        n_chunks, partial);
    int err = (int)cudaGetLastError();
    if (err) return err;
  }
  return launch_reduce(partial, n_chunks, gco, Gp, W, ragged ? 2 : 1, out,
                       s);
}

// K6 over K4/K5: out [num_rows, W] f32 and, when ragged, pres
// [num_rows, W] f32 (pres may be null when dense).
int fused_over_time_series_launch(const float* vals, long long stride,
                                  const float* vbase, long long num_rows,
                                  const int* idx1, const int* idx2,
                                  const float* n1, int W, int kind,
                                  int ragged, float* out, float* pres,
                                  void* stream) {
  SlotRows sr{idx1, idx2, n1};
  const long long cells = num_rows * W;
  if (cells == 0) return 0;
  slot_series<<<series_blocks(cells), 256, 0, (cudaStream_t)stream>>>(
      vals, stride, vbase, num_rows, sr, W, kind, ragged, out, pres);
  return (int)cudaGetLastError();
}

}  // extern "C"
