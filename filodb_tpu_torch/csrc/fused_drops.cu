// Fused windowed rate with in-kernel counter reset correction (K2) over
// one shared scrape grid, dense and ragged, in group-sum mode and in
// per-series mode (K6 over K2), for NVIDIA Hopper (sm_90a).
//
// Replaces: filodb_tpu/ops/pallas_fused.py::_kernel with with_drops=True
// — the dense gather form (:598-605), the dense matmul form (:613-623,
// where K7 adds d @ l1 and d @ l2) and the ragged form (:554-562) — each
// followed by the extrapolation (:626-646) and the _epilogue (:652) in
// group mode (:666-684) or per-series mode (:661-665).
//
// What it computes.  Per row, the drops d[j] = prev + vb where the sample
// v[j] is below the previous sample prev (ragged: the previous VALID
// sample, carried across NaN holes), else 0, with d = 0 where there is no
// previous sample; the corrected row c[j] = v[j] + (d[0] + ... + d[j]);
// then the rate family on c exactly as K1 (dense: c at the plan's
// idx1/idx2) or K3 (ragged: the first and last valid sample of c inside
// the window, presence when there are at least two).
//
// Bound on the H100: memory.  The correction at a window's first slot
// depends on every slot before it, so each row is read from slot 0 to the
// last window's last slot (`span`, 720 slots on the main path's grid):
// 3.0 GB at 1,048,576 series, 0.90 ms at 3.35 TB/s.  The operations are a
// compare, a select and an add per slot (three passes over the row in
// shared memory) plus the ~26 of the rate epilogue per window.
//
// Design.  One warp per row.  The warp copies the row's first span slots
// into shared memory with coalesced loads.  Lane l owns the contiguous
// slots [l*L, (l+1)*L), L = ceil(span / 32): it sums its drops in slot
// order, takes the exclusive prefix of the 32 lane totals in lane order
// (shuffles), and rewrites its slots in place with v + (prefix + its
// drops so far).  So the prefix is computed once per row for all its
// windows, and the windows then read the corrected row from shared
// memory.  The association is fixed — per-lane sequential sums from +0,
// the lanes' prefix in lane order — and the plain torch version in
// ops/fused.py (_drop_corrected) repeats it, so, built with --fmad=false,
// kernel and plain agree to the last bit.  Ragged rows carry the previous
// valid value across lanes too: each lane first finds its last valid
// value, and lane l starts from that of the nearest earlier lane that has
// one (a lane of NaN only passes the carry through).
//
// Group mode: one block per CSR chunk (at most 256 rows of one group),
// one warp per row, the block's warps staging rows_per_block rows at a
// time; thread w then adds those rows' rates for window w in row order,
// so each chunk partial has K1's order, and group_reduce
// (fused_common.cuh) adds each group's chunk partials in chunk order.
// Per-series mode: one warp per row writes out[row, w] (and the presence,
// ragged).  FP32 throughout, no tensor cores, no atomics.  What is left
// for later: TMA copies of the row into shared memory overlapped with the
// previous row's windows, and all 256 threads busy in the window phase.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fused_common.cuh"
#include "rate_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRowsPerBlock = 8;
constexpr long long kMaxSmem = 232448;  // bytes a block may use on sm_90

// The drop at one sample, advancing the previous-sample state: dense rows
// take every sample as the next `prev`, ragged rows only valid ones.  A
// NaN sample compares false, so it never drops.
template <bool RAGGED>
__device__ __forceinline__ float next_drop(float x, float vb, float& prev,
                                           bool& has) {
  const float d = (has && x < prev) ? prev + vb : 0.0f;
  if (!RAGGED || x == x) {
    prev = x;
    has = true;
  }
  return d;
}

// Copy row[0, span) into s and rewrite it as the reset-corrected row.
// Called by all 32 lanes of one warp; s holds span floats.
template <bool RAGGED>
__device__ void stage_corrected(const float* __restrict__ row, int span,
                                float vb, float* s) {
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int j = lane; j < span; j += 32) s[j] = row[j];
  __syncwarp();
  const int L = (span + 31) / 32;
  const int lo = min(lane * L, span);
  const int hi = min(lo + L, span);
  // the previous (valid) sample before this lane's first slot
  float carry = 0.0f;
  bool has = false;
  if (RAGGED) {
    float last = 0.0f;
    int found = 0;
    for (int j = lo; j < hi; ++j) {
      const float x = s[j];
      if (x == x) {
        last = x;
        found = 1;
      }
    }
    for (int k = 0; k < 31; ++k) {
      const float lk = __shfl_sync(kFull, last, k);
      const int fk = __shfl_sync(kFull, found, k);
      if (k < lane && fk) {
        carry = lk;
        has = true;
      }
    }
  } else if (lo > 0) {
    carry = s[lo - 1];
    has = true;
  }
  // pass 1: this lane's drop total, in slot order
  float total = 0.0f;
  {
    float prev = carry;
    bool h = has;
    for (int j = lo; j < hi; ++j) total += next_drop<RAGGED>(s[j], vb, prev, h);
  }
  // the lanes before this one, in lane order
  float run = 0.0f;
  for (int k = 0; k < 31; ++k) {
    const float tk = __shfl_sync(kFull, total, k);
    if (k < lane) run += tk;
  }
  __syncwarp();  // every lane has read its carry before any slot changes
  // pass 2: c[j] = v[j] + (prefix + d[lo] + ... + d[j]), in place
  {
    float prev = carry;
    bool h = has;
    for (int j = lo; j < hi; ++j) {
      const float x = s[j];
      run += next_drop<RAGGED>(x, vb, prev, h);
      s[j] = x + run;
    }
  }
  __syncwarp();
}

template <bool RAGGED>
__global__ void drops_chunks(const float* __restrict__ vals, long long stride,
                             const float* __restrict__ vbase,
                             const int* __restrict__ order,
                             const int* __restrict__ chunk_lo,
                             const int* __restrict__ chunk_hi, WindowRows wr,
                             int W, int span, int is_counter, int is_rate,
                             long long n_chunks, float* __restrict__ partial) {
  extern __shared__ float sh[];
  const int rpb = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x;
  const int lo = chunk_lo[c];
  const int hi = chunk_hi[c];
  float* mine = sh + (long long)warp * span;
  for (int w0 = 0; w0 < W; w0 += blockDim.x) {
    const int w = w0 + threadIdx.x;
    const bool live = w < W;
    const int i1 = live ? wr.idx1[w] : 0;
    const int i2 = live ? wr.idx2[w] : 0;
    const float ws = live ? wr.ws[w] : 0.0f;
    const float we = live ? wr.we[w] : 0.0f;
    float t1 = 0.0f, t2 = 0.0f, n = 0.0f;
    if (!RAGGED && live) {
      t1 = wr.t1[w];
      t2 = wr.t2[w];
      n = wr.n[w];
    }
    float acc = 0.0f;
    float cnt = 0.0f;
    for (int b = lo; b < hi; b += rpb) {
      __syncthreads();  // the previous rows' readers are done
      if (b + warp < hi) {
        const long long r = order[b + warp];
        stage_corrected<RAGGED>(vals + r * stride, span, vbase[r], mine);
      }
      __syncthreads();
      if (!live) continue;
      const int nb = min(rpb, hi - b);
      for (int k = 0; k < nb; ++k) {
        const float* row = sh + (long long)k * span;
        const float vb = vbase[order[b + k]];
        if (RAGGED) {
          float rate;
          if (ragged_rate(row, i1, i2, wr.tsrow, ws, we, vb, is_counter,
                          is_rate, &rate)) {
            acc += rate;
            cnt += 1.0f;
          }
        } else {
          acc += rate_one(row[i1], row[i2], t1, t2, n, ws, we, vb,
                          is_counter, is_rate);
        }
      }
    }
    if (live) {
      partial[(long long)c * W + w] = acc;
      if (RAGGED) partial[(n_chunks + c) * W + w] = cnt;
    }
  }
}

// K6 over K2: out[r, w] (and pres[r, w], ragged) for rows 0..num_rows-1
template <bool RAGGED>
__global__ void drops_series(const float* __restrict__ vals, long long stride,
                             const float* __restrict__ vbase,
                             long long num_rows, WindowRows wr, int W,
                             int span, int is_counter, int is_rate,
                             float* __restrict__ out,
                             float* __restrict__ pres) {
  extern __shared__ float sh[];
  const int rpb = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * rpb + warp;
  if (r >= num_rows) return;  // the whole warp: no block-wide sync below
  float* mine = sh + (long long)warp * span;
  const float vb = vbase[r];
  stage_corrected<RAGGED>(vals + r * stride, span, vb, mine);
  for (int w = lane; w < W; w += 32) {
    const long long t = r * W + w;
    if (RAGGED) {
      float rate = 0.0f;
      const bool ok = ragged_rate(mine, wr.idx1[w], wr.idx2[w], wr.tsrow,
                                  wr.ws[w], wr.we[w], vb, is_counter,
                                  is_rate, &rate);
      out[t] = ok ? rate : 0.0f;
      pres[t] = ok ? 1.0f : 0.0f;
    } else {
      out[t] = rate_one(mine[wr.idx1[w]], mine[wr.idx2[w]], wr.t1[w],
                        wr.t2[w], wr.n[w], wr.ws[w], wr.we[w], vb,
                        is_counter, is_rate);
    }
  }
}

// Rows staged per block: up to 8, fewer when span slots of 8 rows exceed
// the shared memory a block may use; 0 when one row does not fit.
int rows_per_block(int span) {
  const long long r = kMaxSmem / ((long long)span * 4);
  return r > kMaxRowsPerBlock ? kMaxRowsPerBlock : (int)r;
}

template <typename Kernel>
int prepare(Kernel kernel, int span, int* rpb, size_t* smem) {
  if (span < 1) return (int)cudaErrorInvalidValue;
  *rpb = rows_per_block(span);
  if (*rpb < 1) return (int)cudaErrorInvalidValue;
  *smem = (size_t)(*rpb) * span * sizeof(float);
  if (*smem > 48 * 1024) {
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  }
  return 0;
}

template <bool RAGGED>
int launch_chunks(const float* vals, long long stride, const float* vbase,
                  const int* order, const int* chunk_lo, const int* chunk_hi,
                  long long n_chunks, const int* gco, int Gp, WindowRows wr,
                  int W, int span, int is_counter, int is_rate,
                  float* partial, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_chunks > 0) {
    int rpb;
    size_t smem;
    int err = prepare(drops_chunks<RAGGED>, span, &rpb, &smem);
    if (err) return err;
    drops_chunks<RAGGED><<<(unsigned)n_chunks, rpb * 32, smem, s>>>(
        vals, stride, vbase, order, chunk_lo, chunk_hi, wr, W, span,
        is_counter, is_rate, n_chunks, partial);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return launch_reduce(partial, n_chunks, gco, Gp, W, RAGGED ? 2 : 1, out, s);
}

template <bool RAGGED>
int launch_series(const float* vals, long long stride, const float* vbase,
                  long long num_rows, WindowRows wr, int W, int span,
                  int is_counter, int is_rate, float* out, float* pres,
                  void* stream) {
  if (num_rows == 0) return 0;
  int rpb;
  size_t smem;
  int err = prepare(drops_series<RAGGED>, span, &rpb, &smem);
  if (err) return err;
  const long long blocks = (num_rows + rpb - 1) / rpb;
  drops_series<RAGGED><<<(unsigned)blocks, rpb * 32, smem,
                         (cudaStream_t)stream>>>(
      vals, stride, vbase, num_rows, wr, W, span, is_counter, is_rate, out,
      pres);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K2 dense, group mode.  vals [rows, stride] f32, vbase [rows] f32, order
// [N] int32 CSR rows, chunk_lo/chunk_hi [n_chunks] int32, gco [Gp + 1]
// int32, the window rows [W] (idx int32, the rest f32; tsrow [stride] is
// not read), span = the slots read from each row (max idx2 + 1, at most
// stride), partial [n_chunks, W] f32 scratch, out [Gp, W] f32.  Returns
// cudaGetLastError() (cudaErrorInvalidValue when one row's span does not
// fit in shared memory).
int fused_rate_drops_dense_launch(
    const float* vals, long long stride, const float* vbase,
    const int* order, const int* chunk_lo, const int* chunk_hi,
    long long n_chunks, const int* gco, int Gp, const int* idx1,
    const int* idx2, const float* t1, const float* t2, const float* n,
    const float* ws, const float* we, const float* tsrow, int W, int span,
    int is_counter, int is_rate, float* partial, float* out, void* stream) {
  WindowRows wr{idx1, idx2, t1, t2, n, ws, we, tsrow};
  return launch_chunks<false>(vals, stride, vbase, order, chunk_lo, chunk_hi,
                              n_chunks, gco, Gp, wr, W, span, is_counter,
                              is_rate, partial, out, stream);
}

// K2 ragged, group mode.  As the dense entry point (t1, t2 and n are not
// read); partial is [2, n_chunks, W] and out [2, Gp, W]: plane 0 the rate
// sums, plane 1 the presence counts (windows with two valid samples).
int fused_rate_drops_ragged_launch(
    const float* vals, long long stride, const float* vbase,
    const int* order, const int* chunk_lo, const int* chunk_hi,
    long long n_chunks, const int* gco, int Gp, const int* idx1,
    const int* idx2, const float* t1, const float* t2, const float* n,
    const float* ws, const float* we, const float* tsrow, int W, int span,
    int is_counter, int is_rate, float* partial, float* out, void* stream) {
  WindowRows wr{idx1, idx2, t1, t2, n, ws, we, tsrow};
  return launch_chunks<true>(vals, stride, vbase, order, chunk_lo, chunk_hi,
                             n_chunks, gco, Gp, wr, W, span, is_counter,
                             is_rate, partial, out, stream);
}

// K6 over K2 dense.  out [num_rows, W] f32 (pres is not written); the
// other operands as the group-mode entry points.
int fused_rate_drops_dense_series_launch(
    const float* vals, long long stride, const float* vbase,
    long long num_rows, const int* idx1, const int* idx2, const float* t1,
    const float* t2, const float* n, const float* ws, const float* we,
    const float* tsrow, int W, int span, int is_counter, int is_rate,
    float* out, float* pres, void* stream) {
  WindowRows wr{idx1, idx2, t1, t2, n, ws, we, tsrow};
  return launch_series<false>(vals, stride, vbase, num_rows, wr, W, span,
                              is_counter, is_rate, out, pres, stream);
}

// K6 over K2 ragged.  out and pres [num_rows, W] f32.
int fused_rate_drops_ragged_series_launch(
    const float* vals, long long stride, const float* vbase,
    long long num_rows, const int* idx1, const int* idx2, const float* t1,
    const float* t2, const float* n, const float* ws, const float* we,
    const float* tsrow, int W, int span, int is_counter, int is_rate,
    float* out, float* pres, void* stream) {
  WindowRows wr{idx1, idx2, t1, t2, n, ws, we, tsrow};
  return launch_series<true>(vals, stride, vbase, num_rows, wr, W, span,
                             is_counter, is_rate, out, pres, stream);
}

}  // extern "C"
