// Fused windowed rate + group sum over one shared scrape grid (K1 dense,
// K3 ragged) for NVIDIA Hopper (sm_90a).
//
// Replaces: filodb_tpu/ops/pallas_fused.py::_kernel, the rate-family
// branches with gather selections and no in-kernel drops — the dense
// gather branch (:595-609, _gather_cols :443) and the ragged branch
// (:544-593 without with_drops), each followed by the extrapolation
// (:626-646) and the _epilogue (:652) in both modes: group sums
// (:666-684) and per-series output (K6, :661-665).
//
// Bound on the H100: memory.  Per (series, window) the kernel reads two
// values (K1) or the window's slots (K3) and does ~30 f32 operations.
// The bytes are the part of each row the windows span: about S x 690
// x 4 B, 2.9 GB at 1,048,576 series x 720 samples with 5 m windows on a
// 1 m grid, so about 0.86 ms at 3.35 TB/s; the operations (~3.5 G f32)
// take about 0.05 ms at 67 TFLOP/s.
//
// Design.  The group sum must give the same bits on every run, so there
// are no float atomics.  The wrapper hands a stable CSR order of rows by
// group (ascending row inside a group) cut into chunks of at most 256
// rows.  dense_chunks / ragged_chunks: one block per chunk, one thread
// per window (looping over windows when W exceeds the block); the thread
// walks the chunk's rows in order, reads the row's boundary slots
// straight from device memory (neighbouring threads read neighbouring
// windows of the same row, so a warp's loads fall in a few sectors of
// one row), computes the rate and adds it to its sum.  group_reduce then
// adds each group's chunk partials in chunk order.  Rows are unrolled by
// four so each thread keeps eight loads in flight before its ordered
// adds.  Build with --fmad=false: the plain torch version in
// ops/fused.py computes the same operations unfused, so the two agree
// to the last bit of each per-series rate.  FP32 throughout, no tensor
// cores.  What is left for later: reading each row once for all its
// windows (shared-memory staging or TMA), and one pass with no partials.
//
// Per-series mode (K6, the min/max aggregates): dense_series /
// ragged_series run one thread per (series, window) cell, neighbouring
// threads on neighbouring windows of one row, and store the rate (and
// the presence, ragged) at out[row, w]; ops/agg.map_phase finishes the
// groups in torch.  The bytes are the same row spans plus the [S, W]
// output written once.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fused_common.cuh"
#include "rate_common.cuh"

namespace {

__global__ void dense_chunks(const float* __restrict__ vals,
                             long long stride,
                             const float* __restrict__ vbase,
                             const int* __restrict__ order,
                             const int* __restrict__ chunk_lo,
                             const int* __restrict__ chunk_hi,
                             WindowRows wr, int W, int is_counter,
                             int is_rate, float* __restrict__ partial) {
  const int c = blockIdx.x;
  const int lo = chunk_lo[c];
  const int hi = chunk_hi[c];
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    const int i1 = wr.idx1[w];
    const int i2 = wr.idx2[w];
    const float t1 = wr.t1[w], t2 = wr.t2[w], n = wr.n[w];
    const float ws = wr.ws[w], we = wr.we[w];
    float acc = 0.0f;
    int i = lo;
    for (; i + 4 <= hi; i += 4) {
      float a[4], b[4], vb[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long r = order[i + u];
        const float* row = vals + r * stride;
        a[u] = row[i1];
        b[u] = row[i2];
        vb[u] = vbase[r];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        acc += rate_one(a[u], b[u], t1, t2, n, ws, we, vb[u], is_counter,
                        is_rate);
      }
    }
    for (; i < hi; ++i) {
      const long long r = order[i];
      const float* row = vals + r * stride;
      acc += rate_one(row[i1], row[i2], t1, t2, n, ws, we, vbase[r],
                      is_counter, is_rate);
    }
    partial[(long long)c * W + w] = acc;
  }
}

__global__ void ragged_chunks(const float* __restrict__ vals,
                              long long stride,
                              const float* __restrict__ vbase,
                              const int* __restrict__ order,
                              const int* __restrict__ chunk_lo,
                              const int* __restrict__ chunk_hi,
                              WindowRows wr, int W, int is_counter,
                              int is_rate, long long n_chunks,
                              float* __restrict__ partial) {
  const int c = blockIdx.x;
  const int lo = chunk_lo[c];
  const int hi = chunk_hi[c];
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    const int i1 = wr.idx1[w];
    const int i2 = wr.idx2[w];
    const float ws = wr.ws[w], we = wr.we[w];
    float acc = 0.0f;
    float cnt = 0.0f;
    for (int i = lo; i < hi; ++i) {
      const long long r = order[i];
      float rate;
      if (ragged_rate(vals + r * stride, i1, i2, wr.tsrow, ws, we, vbase[r],
                      is_counter, is_rate, &rate)) {
        acc += rate;
        cnt += 1.0f;
      }
    }
    partial[(long long)c * W + w] = acc;
    partial[(n_chunks + c) * W + w] = cnt;
  }
}

// K6 over K1: out[r, w] for rows 0..num_rows-1
__global__ void dense_series(const float* __restrict__ vals,
                             long long stride,
                             const float* __restrict__ vbase,
                             long long num_rows, WindowRows wr, int W,
                             int is_counter, int is_rate,
                             float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= num_rows * W) return;
  const long long r = t / W;
  const int w = (int)(t - r * W);
  const float* row = vals + r * stride;
  out[t] = rate_one(row[wr.idx1[w]], row[wr.idx2[w]], wr.t1[w], wr.t2[w],
                    wr.n[w], wr.ws[w], wr.we[w], vbase[r], is_counter,
                    is_rate);
}

// K6 over K3: out[r, w] (0 where absent) and pres[r, w]
__global__ void ragged_series(const float* __restrict__ vals,
                              long long stride,
                              const float* __restrict__ vbase,
                              long long num_rows, WindowRows wr, int W,
                              int is_counter, int is_rate,
                              float* __restrict__ out,
                              float* __restrict__ pres) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= num_rows * W) return;
  const long long r = t / W;
  const int w = (int)(t - r * W);
  float rate = 0.0f;
  const bool ok = ragged_rate(vals + r * stride, wr.idx1[w], wr.idx2[w],
                              wr.tsrow, wr.ws[w], wr.we[w], vbase[r],
                              is_counter, is_rate, &rate);
  out[t] = ok ? rate : 0.0f;
  pres[t] = ok ? 1.0f : 0.0f;
}

}  // namespace

extern "C" {

// K1.  vals [rows, stride] f32, vbase [rows] f32, order [N] int32 CSR
// rows, chunk_lo/chunk_hi [n_chunks] int32, gco [Gp + 1] int32, the
// window rows [W] (idx int32, the rest f32), partial [n_chunks, W] f32
// scratch, out [Gp, W] f32.  Returns cudaGetLastError().
int fused_rate_dense_launch(const float* vals, long long stride,
                            const float* vbase, const int* order,
                            const int* chunk_lo, const int* chunk_hi,
                            long long n_chunks, const int* gco, int Gp,
                            const int* idx1, const int* idx2,
                            const float* t1, const float* t2, const float* n,
                            const float* ws, const float* we, int W,
                            int is_counter, int is_rate, float* partial,
                            float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  WindowRows wr{idx1, idx2, t1, t2, n, ws, we, nullptr};
  if (n_chunks > 0) {
    dense_chunks<<<(unsigned)n_chunks, block_for(W), 0, s>>>(
        vals, stride, vbase, order, chunk_lo, chunk_hi, wr, W, is_counter,
        is_rate, partial);
    int err = (int)cudaGetLastError();
    if (err) return err;
  }
  return launch_reduce(partial, n_chunks, gco, Gp, W, 1, out, s);
}

// K3.  As K1, plus tsrow [stride] f32 (the shared grid's ts offsets);
// partial is [2, n_chunks, W] and out [2, Gp, W]: plane 0 the rate sums,
// plane 1 the presence counts (windows with at least two valid samples).
int fused_rate_ragged_launch(const float* vals, long long stride,
                             const float* vbase, const int* order,
                             const int* chunk_lo, const int* chunk_hi,
                             long long n_chunks, const int* gco, int Gp,
                             const int* idx1, const int* idx2,
                             const float* ws, const float* we,
                             const float* tsrow, int W, int is_counter,
                             int is_rate, float* partial, float* out,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  WindowRows wr{idx1, idx2, nullptr, nullptr, nullptr, ws, we, tsrow};
  if (n_chunks > 0) {
    ragged_chunks<<<(unsigned)n_chunks, block_for(W), 0, s>>>(
        vals, stride, vbase, order, chunk_lo, chunk_hi, wr, W, is_counter,
        is_rate, n_chunks, partial);
    int err = (int)cudaGetLastError();
    if (err) return err;
  }
  return launch_reduce(partial, n_chunks, gco, Gp, W, 2, out, s);
}

// K6 over K1.  out [num_rows, W] f32; the other operands as K1.
int fused_rate_dense_series_launch(const float* vals, long long stride,
                                   const float* vbase, long long num_rows,
                                   const int* idx1, const int* idx2,
                                   const float* t1, const float* t2,
                                   const float* n, const float* ws,
                                   const float* we, int W, int is_counter,
                                   int is_rate, float* out, void* stream) {
  WindowRows wr{idx1, idx2, t1, t2, n, ws, we, nullptr};
  const long long cells = num_rows * W;
  if (cells == 0) return 0;
  dense_series<<<series_blocks(cells), 256, 0, (cudaStream_t)stream>>>(
      vals, stride, vbase, num_rows, wr, W, is_counter, is_rate, out);
  return (int)cudaGetLastError();
}

// K6 over K3.  out and pres [num_rows, W] f32; the other operands as K3.
int fused_rate_ragged_series_launch(const float* vals, long long stride,
                                    const float* vbase, long long num_rows,
                                    const int* idx1, const int* idx2,
                                    const float* ws, const float* we,
                                    const float* tsrow, int W,
                                    int is_counter, int is_rate, float* out,
                                    float* pres, void* stream) {
  WindowRows wr{idx1, idx2, nullptr, nullptr, nullptr, ws, we, tsrow};
  const long long cells = num_rows * W;
  if (cells == 0) return 0;
  ragged_series<<<series_blocks(cells), 256, 0, (cudaStream_t)stream>>>(
      vals, stride, vbase, num_rows, wr, W, is_counter, is_rate, out, pres);
  return (int)cudaGetLastError();
}

}  // extern "C"
