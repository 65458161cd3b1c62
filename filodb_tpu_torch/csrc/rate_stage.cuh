// Staged rows for the rate kernels that read a whole row range: K2 (the
// in-kernel reset correction, fused_drops.cu) and K3 (ragged rate,
// fused_rate.cu), in group mode and in per-series mode (K6).  Each source
// includes it into its own anonymous namespace.
//
// - Staging: a warp copies its row's slots [a, e) into shared memory with
//   16-byte cp.async copies (a, e multiples of 4: the wrappers refuse a
//   row stride that is not a multiple of 4 slots or a base pointer that is
//   not 16-byte aligned).  A block stages 4 rows at a time in a ring of
//   two batches, so the next batch's copies are in flight while this
//   batch computes.
// - Index tables, one int4 per 32-slot tile of a staged row: the tile's
//   valid (non-NaN) mask, the valid slots before the tile, the last valid
//   slot before it and the first valid slot after it (a lane builds its
//   tile's mask from eight 16-byte reads; popc, clz and ffs with shuffle
//   scans across lanes give the rest).  A ragged window [i1, i2] then costs
//   two table reads and a popc, ffs and clz each: nv = cnt(i2 + 1) -
//   cnt(i1), j1 = nxt(i1), j2 = prv(i2) — the samples and count the
//   slot-by-slot scan selects.  At 16 B per 32 slots the tables take an
//   eighth of the staged row.
// - Threads over windows: a block of 128 threads (4 warps) matches the
//   main path's 110 windows; thread t takes window w0 + t for every staged
//   row, with the window's plan rows and the window part of its rate in
//   registers, so in group mode it adds each row's cell straight into its
//   sum in row order.  Chosen over 256 threads computing a shared (row,
//   window) tile, which measured slower on the H100 (more index math and
//   plan reads per cell, fewer blocks an SM; PERF.md §6).  At wider W a
//   block covers 128 windows a pass; at narrower W the threads past W
//   idle.
// - Tiles: when a row's staged range does not fit, the windows are walked
//   in order in tiles whose slots do (every window's slots in one tile),
//   with tables local to the tile.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fused_common.cuh"
#include "rate_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 4;             // rows staged at a time, one warp each
constexpr long long kMaxSmem = 232448;   // bytes a block may use on sm_90
constexpr int kTileSlots = 8192;         // K3's slot tile when a row does not fit
constexpr int kNone = 0x3fffffff;        // "no valid slot after this tile"
// What a launcher returns when a row's staged range does not fit in shared
// memory (CUDA's error codes are never negative); the wrappers raise
// ValueError for it.
constexpr int kNoFit = -1;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Warp: start copying row[a, e) into dst[0, e - a).
__device__ __forceinline__ void stage_row(float* dst, const float* row, int a,
                                         int e) {
  const int lane = threadIdx.x & 31;
  const float4* src = reinterpret_cast<const float4*>(row + a);
  float4* d = reinterpret_cast<float4*>(dst);
  const int n = (e - a) >> 2;
  for (int i = lane; i < n; i += 32) cp_async16(d + i, src + i);
}

// Warp: rewrite the staged s[0, span) as the reset-corrected row,
// c[j] = v[j] + (d[0] + ... + d[j]).  Lane l owns the slots [l*L, (l+1)*L),
// L = ceil(span / 32): it sums its drops in slot order from +0, the lanes'
// totals are prefixed in lane order, and each slot adds its lane's prefix
// plus its own drops so far — the association ops/fused._drop_corrected
// repeats.  Only drops are added: a zero drop would leave a sum that
// starts at +0 bit-identical (it is never -0).  A ragged lane starts from
// the last valid sample before its first slot, which the row's tables
// (tab, built on the raw row) give in O(1): the nearest earlier lane's
// last valid sample.
template <bool RAGGED>
__device__ void correct_row(float* s, int span, float vb, const int4* tab) {
  const int lane = threadIdx.x & 31;
  const int L = (span + 31) / 32;
  const int lo = min(lane * L, span);
  const int hi = min(lo + L, span);
  // the previous (valid) sample before this lane's first slot; NaN when
  // there is none, which no sample is below
  float carry = __int_as_float(0x7fc00000);
  if (lo > 0) {
    int j = lo - 1;
    if (RAGGED) {
      const int4 t = tab[j >> 5];
      const unsigned upto = (unsigned)t.x & ((2u << (j & 31)) - 1u);
      j = upto ? (j & ~31) + 31 - __clz(upto) : t.z;
    }
    if (j >= 0) carry = s[j];
  }
  // Pass 1: the lane's drops summed in slot order
  float total = 0.0f;
  {
    float prev = carry;
#pragma unroll 4
    for (int j = lo; j < hi; ++j) {
      const float x = s[j];
      if (x < prev) total += prev + vb;
      if (!RAGGED || x == x) prev = x;
    }
  }
  float run = 0.0f;  // the lanes before this one, in lane order
  for (int k = 0; k < 31; ++k) {
    const float tk = __shfl_sync(kFull, total, k);
    if (k < lane) run += tk;
  }
  __syncwarp();  // every lane has read its carry before any slot changes
  // Pass 2: c[j] = v[j] + (prefix + the lane's drops through j)
  {
    float prev = carry;
#pragma unroll 4
    for (int j = lo; j < hi; ++j) {
      const float x = s[j];
      if (x < prev) run += prev + vb;
      if (!RAGGED || x == x) prev = x;
      s[j] = x + run;
    }
  }
  __syncwarp();
}

// Warp: the index tables of the staged s[0, n), one int4 per 32-slot tile
// t: {valid mask, valid slots before the tile, last valid slot before it
// (-1: none), first valid slot after it (kNone: none)}.  Tiles are read 32
// at a time (a ballot each); lane l then owns tile g + l and the lanes'
// prefix count and max, and in a second pass from the end their suffix
// min, are shuffle scans carried across groups of 32 tiles.
__device__ void build_tables(const float* s, int n, int4* tab) {
  const int lane = threadIdx.x & 31;
  const int nt = (n + 31) >> 5;
  int cnt_carry = 0, last_carry = -1;
  for (int g = 0; g < nt; g += 32) {
    const int t = g + lane;
    unsigned mine = 0;
    if (t < nt) {
      // the tile's 8 float4s, lane-rotated so that each group of 8 lanes
      // reads 8 distinct 16-byte bank groups
      const float4* q = reinterpret_cast<const float4*>(s + (t << 5));
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int cc = (c + lane) & 7;
        const float4 v = q[cc];
        const unsigned bits = (unsigned)(v.x == v.x) |
                              ((unsigned)(v.y == v.y) << 1) |
                              ((unsigned)(v.z == v.z) << 2) |
                              ((unsigned)(v.w == v.w) << 3);
        mine |= bits << (cc * 4);
      }
      const int left = n - (t << 5);  // slots of the row in this tile
      if (left < 32) mine &= (1u << left) - 1u;
    }
    const int pc = __popc(mine);
    int incl = pc;
    int lmax = mine ? (t << 5) + 31 - __clz(mine) : -1;
    for (int d = 1; d < 32; d <<= 1) {
      const int a = __shfl_up_sync(kFull, incl, d);
      const int b = __shfl_up_sync(kFull, lmax, d);
      if (lane >= d) {
        incl += a;
        lmax = max(lmax, b);
      }
    }
    const int prev_max = __shfl_up_sync(kFull, lmax, 1);
    if (t < nt) {
      tab[t] = make_int4((int)mine, cnt_carry + incl - pc,
                         max(last_carry, lane ? prev_max : -1), kNone);
    }
    cnt_carry += __shfl_sync(kFull, incl, 31);
    last_carry = max(last_carry, __shfl_sync(kFull, lmax, 31));
  }
  __syncwarp();
  int first_carry = kNone;
  for (int g = ((nt - 1) >> 5) << 5; g >= 0; g -= 32) {
    const int t = g + lane;
    const unsigned mine = t < nt ? (unsigned)tab[t].x : 0u;
    int fmin = mine ? (t << 5) + __ffs(mine) - 1 : kNone;
    for (int d = 1; d < 32; d <<= 1) {
      const int b = __shfl_down_sync(kFull, fmin, d);
      if (lane + d < 32) fmin = min(fmin, b);
    }
    const int next_min = __shfl_down_sync(kFull, fmin, 1);
    if (t < nt) tab[t].w = min(first_carry, lane < 31 ? next_min : kNone);
    first_carry = min(first_carry, __shfl_sync(kFull, fmin, 0));
  }
  __syncwarp();
}

// The O(1) ragged window over staged slots i1..i2 (i1 < i2): returns the
// valid count, with *j1 the first valid slot >= i1 and *j2 the last valid
// slot <= i2 (meaningful when the count is at least 1).
__device__ __forceinline__ int ragged_window(const int4* tab, int i1, int i2,
                                            int* j1, int* j2) {
  const int4 a = tab[i1 >> 5];
  const int4 b = tab[i2 >> 5];
  const unsigned before1 = (1u << (i1 & 31)) - 1u;  // tile slots before i1
  const unsigned thru2 = (2u << (i2 & 31)) - 1u;    // tile slots up to i2
  const unsigned from1 = (unsigned)a.x & ~before1;
  const unsigned upto2 = (unsigned)b.x & thru2;
  *j1 = from1 ? (i1 & ~31) + __ffs(from1) - 1 : a.w;
  *j2 = upto2 ? (i2 & ~31) + 31 - __clz(upto2) : b.z;
  return (b.y + __popc(upto2)) - (a.y + __popc((unsigned)a.x & before1));
}

// One window of the plan, held in registers by the thread that computes
// it over many rows, with the window part of its rate: from the plan's
// t1, t2 and n (dense), or from the ts of its first and last slot and its
// slot count (ragged: a row with no NaN in the window).
struct Window {
  int i1, i2;
  float ws, we;
  RateWin k;
};

__device__ __forceinline__ Window load_window(const WindowRows& wr, int w,
                                              bool ragged) {
  Window x;
  x.i1 = wr.idx1[w];
  x.i2 = wr.idx2[w];
  x.ws = wr.ws[w];
  x.we = wr.we[w];
  if (!ragged) {
    x.k = rate_window(wr.t1[w], wr.t2[w], wr.n[w], x.ws, x.we);
  } else if (x.i2 > x.i1) {  // else absent in every row: k is not read
    x.k = rate_window(wr.tsrow[x.i1], wr.tsrow[x.i2],
                      (float)(x.i2 - x.i1 + 1), x.ws, x.we);
  } else {
    x.k = RateWin{};
  }
  return x;
}

// One (row, window) cell over a staged row s whose slot 0 is row slot a
// (ts: the grid's ts offsets from row slot a): the rate (0 where absent)
// and, ragged, the presence (two valid samples).  A ragged row whose
// first or last valid sample in the window is not at the window's edge,
// or that holds a NaN inside it, recomputes just the terms that change —
// the same operations on the same operands as rate_one, so the same bits.
template <bool RAGGED>
__device__ __forceinline__ float rate_cell(const float* s, const int4* tab,
                                           int a, const Window& x,
                                           const float* ts, float vb,
                                           int is_counter, int is_rate,
                                           float* pres) {
  if (!RAGGED) {
    *pres = 1.0f;
    return rate_finish(x.k, s[x.i1 - a], s[x.i2 - a], vb, is_counter,
                       is_rate);
  }
  if (x.i2 > x.i1) {  // a window of one slot or none is absent
    int j1, j2;
    const int nv = ragged_window(tab, x.i1 - a, x.i2 - a, &j1, &j2);
    if (nv >= 2) {
      *pres = 1.0f;
      RateWin k = x.k;
      const bool moved1 = j1 != x.i1 - a;
      const bool moved2 = j2 != x.i2 - a;
      if (moved1) k.dur_start = (ts[j1] - x.ws) * 0.001f;
      if (moved2) k.dur_end = (x.we - ts[j2]) * 0.001f;
      if (moved1 || moved2) {
        const float sampled = (ts[j2] - ts[j1]) * 0.001f;
        k.sampled = (sampled < 1e-9f) ? 1e-9f : sampled;
      }
      if (moved1 || moved2 || nv != x.i2 - x.i1 + 1) {
        rate_spacing(k, (float)nv);
      }
      return rate_finish(k, s[j1], s[j2], vb, is_counter, is_rate);
    }
  }
  *pres = 0.0f;
  return 0.0f;
}

// The next tile of windows from w0 (before wend): out = {a, e, w1}, the
// slots [a, e) (multiples of 4, at most cap) holding the slots of every
// window in [w0, w1).  Windows of fewer than two slots read nothing.  A
// window wider than a tile (the wrappers refuse those) is passed over.
__device__ void next_tile(const WindowRows& wr, int w0, int wend, int cap,
                          int* out) {
  int a = -1, e = 0, w = w0;
  for (; w < wend; ++w) {
    const int i1 = wr.idx1[w];
    const int i2 = wr.idx2[w];
    if (i2 <= i1) continue;
    const int a2 = a < 0 ? (i1 & ~3) : a;
    const int e2 = max(e, (i2 + 4) & ~3);
    if (i1 < a2 || e2 - a2 > cap) break;
    a = a2;
    e = e2;
  }
  if (w == w0) ++w;
  out[0] = a < 0 ? 0 : a;
  out[1] = a < 0 ? 0 : e;
  out[2] = w;
}

// The launch shape of a staged kernel (stage_fit picks rows and stages).
struct StagePlan {
  int lo, hi;  // slots [lo, hi) staged from every row (multiples of 4)
  int cap;     // slots of one row buffer (a multiple of 32)
  int span;    // K2: slots 0..span-1 the reset correction covers
  int rows;    // R: rows staged at a time, one warp each (blockDim 32 R,
               // which is also the windows a pass: thread t takes w0 + t)
  int stages;  // 2: the next rows' copies fly while these compute
  int single;  // hi - lo <= cap: one tile holds every window's slots
  int ts_smem; // the ragged cells read the grid's ts from shared memory
};

constexpr int kSeriesChunk = 256;  // rows one per-series block walks

// The blocks of 128 threads an SM each kernel's launch bounds ask for,
// which caps its registers: 8 (64 registers) for dense K2, 7 (72) for K3
// and the ragged per-series kernels, 6 (80) for ragged K2 in group mode,
// whose correction, tables and cells hold the most state — each the
// fastest of 6, 7 and 8 when timed on an H100.  Fewer registers
// spill; more leave too few warps to hide the shared-memory and division
// latencies.
constexpr int min_blocks(bool drops, bool ragged, bool series) {
  return !ragged ? 8 : (drops && !series) ? 6 : 7;
}

// One block per chunk of rows: a CSR chunk (group mode: at most 256 rows
// of one group, in the order the plain version sums them) or 256
// consecutive rows (per-series mode).  Rows are staged R at a time, one
// warp a row, in a ring of two batches; each warp indexes (ragged) and
// corrects (K2) its row.  Then thread t computes window wc0 + t for every
// row of the batch, with the window's plan rows in registers: per series
// it stores out[r, w] (and pres[r, w]), neighbouring threads on
// neighbouring windows; in group mode it adds the cell straight into its
// running sum, in row order — K1's order, from +0 — so the chunk partial
// has the plain version's bits; group_reduce (fused_common.cuh) adds each
// group's chunk partials in chunk order.
template <bool DROPS, bool RAGGED, bool SERIES>
__global__ void __launch_bounds__(32 * kMaxWarps,
                                  min_blocks(DROPS, RAGGED, SERIES))
    staged_rows(const float* __restrict__ vals, long long stride,
                const float* __restrict__ vbase,
                const int* __restrict__ order,
                const int* __restrict__ chunk_lo,
                const int* __restrict__ chunk_hi, long long num_rows,
                WindowRows wr, int W, StagePlan sp, int is_counter,
                int is_rate, long long n_chunks, float* __restrict__ out,
                float* __restrict__ pres) {
  extern __shared__ __align__(16) float smem[];
  const int R = sp.rows, cap = sp.cap;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* buf = smem;
  int4* tab = reinterpret_cast<int4*>(buf + (long long)sp.stages * R * cap);
  float* svb = reinterpret_cast<float*>(tab + (RAGGED ? R * (cap >> 5) : 0));
  int* tinfo = reinterpret_cast<int*>(svb + (R > 1 ? sp.stages * R : 0));
  float* tss = reinterpret_cast<float*>(tinfo + 4);  // sp.ts_smem
  // the grid's ts offsets of slots [a, e) in shared memory when there is
  // room (read by the ragged cells), else read from device memory
  auto fill_ts = [&](int a, int e) {
    if (!RAGGED || !sp.ts_smem) return;
    for (int j = threadIdx.x; j < e - a; j += blockDim.x) tss[j] = wr.tsrow[a + j];
  };
  const long long c = blockIdx.x;
  const long long r0 = SERIES ? c * kSeriesChunk : chunk_lo[c];
  const long long r1 =
      SERIES ? min(num_rows, r0 + kSeriesChunk) : (long long)chunk_hi[c];
  const int nb = (int)((r1 - r0 + R - 1) / R);
  auto row_id = [&](long long i) -> long long {
    return SERIES ? i : (long long)order[i];
  };
  auto sync = [&]() {
    if (R > 1) __syncthreads(); else __syncwarp();
  };

  for (int wc0 = 0; wc0 < W; wc0 += (int)blockDim.x) {
    const int w = wc0 + (int)threadIdx.x;
    const bool mine = w < W;
    Window x{};
    if (mine) x = load_window(wr, w, RAGGED);
    float acc = 0.0f, cnt = 0.0f;
    // warp `warp` starts copying its row of batch b, slots [a, e), into
    // stage st (every thread commits a group, empty or not)
    auto issue = [&](int b, int st, int a, int e) {
      const long long i = r0 + (long long)b * R + warp;
      if (i < r1) {
        const long long r = row_id(i);
        stage_row(buf + ((long long)st * R + warp) * cap, vals + r * stride,
                  a, e);
        if (R > 1 && lane == 0) svb[st * R + warp] = vbase[r];
      }
      cp_async_commit();
    };
    // batch b, landed in stage st: each warp indexes and corrects its row,
    // then the cells of this thread's window if it lies in [w0, w1)
    auto compute = [&](int b, int st, int a, int e, int w0, int w1) {
      const int nrow = (int)min((long long)R, r1 - r0 - (long long)b * R);
      if (warp < nrow) {
        float* s = buf + ((long long)st * R + warp) * cap;
        int4* t = tab + warp * (cap >> 5);
        if (RAGGED) build_tables(s, e - a, t);
        if (DROPS) {
          correct_row<RAGGED>(
              s, sp.span, vbase[row_id(r0 + (long long)b * R + warp)], t);
        }
      }
      sync();
      if (!mine || w < w0 || w >= w1) return;
      for (int k = 0; k < nrow; ++k) {
        const long long i = r0 + (long long)b * R + k;
        const float vb = R > 1 ? svb[st * R + k] : vbase[row_id(i)];
        float p;
        const float v = rate_cell<RAGGED>(
            buf + ((long long)st * R + k) * cap, tab + k * (cap >> 5), a, x,
            sp.ts_smem ? tss : wr.tsrow + a, vb, is_counter, is_rate, &p);
        if (SERIES) {
          const long long o = i * W + w;
          out[o] = v;
          if (RAGGED) pres[o] = p;
        } else {
          acc += v;
          cnt += p;
        }
      }
    };
    if (sp.single) {
      fill_ts(sp.lo, sp.hi);
      if (sp.stages == 2) issue(0, 0, sp.lo, sp.hi);
      for (int b = 0; b < nb; ++b) {
        const int st = sp.stages == 2 ? (b & 1) : 0;
        if (sp.stages == 1) {
          issue(b, 0, sp.lo, sp.hi);
          cp_async_wait<0>();
        } else if (b + 1 < nb) {
          issue(b + 1, st ^ 1, sp.lo, sp.hi);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncwarp();
        compute(b, st, sp.lo, sp.hi, wc0, W);
        sync();  // every reader of the stage is done
      }
    } else {
      for (int b = 0; b < nb; ++b) {
        for (int w0 = wc0; w0 < min(W, wc0 + (int)blockDim.x);) {
          if (threadIdx.x == 0) {
            next_tile(wr, w0, min(W, wc0 + (int)blockDim.x), cap, tinfo);
          }
          __syncthreads();
          const int a = tinfo[0], e = tinfo[1], w1 = tinfo[2];
          fill_ts(a, e);
          issue(b, 0, a, e);
          cp_async_wait<0>();
          __syncwarp();
          compute(b, 0, a, e, w0, w1);
          __syncthreads();  // the tile's readers are done
          w0 = w1;
        }
      }
    }
    if (!SERIES && mine) {
      out[c * W + w] = acc;
      if (RAGGED) out[(n_chunks + c) * W + w] = cnt;
    }
  }
}

// ------------------------------------------------------------ host side

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared memory of a staged launch, in the order the kernel lays it out.
long long stage_smem(const StagePlan& p, bool ragged) {
  long long b = (long long)p.stages * p.rows * p.cap * 4;
  if (ragged) b += (long long)p.rows * (p.cap / 32) * 16;
  if (p.rows > 1) b += (long long)p.stages * p.rows * 4;
  if (!p.single) b += 16;
  if (p.ts_smem) b += 16 + (long long)p.cap * 4;
  return b;
}

// The most rows a block stages with two stages, else with one; false when
// not even one row fits.
bool stage_fit(StagePlan* p, bool ragged) {
  for (int ts = ragged ? 1 : 0; ts >= 0; --ts) {
    for (int stages = 2; stages >= 1; --stages) {
      for (int rows = kMaxWarps; rows >= 1; --rows) {
        p->ts_smem = ts;
        p->stages = stages;
        p->rows = rows;
        if (stage_smem(*p, ragged) <= kMaxSmem) return true;
      }
    }
  }
  return false;
}

// K2: every row from slot 0 through the last window (span), one tile.
bool plan_drops(int span, bool ragged, StagePlan* p) {
  if (span < 1) return false;
  p->lo = 0;
  p->hi = round_up(span, 4);
  p->cap = round_up(p->hi, 32);
  p->span = span;
  p->single = 1;
  return stage_fit(p, ragged);
}

// K3: slots [lo, hi) of every row, one tile when two stages of at least
// one row fit, else tiles of kTileSlots (or the widest window's slots).
bool plan_ragged(int lo, int hi, int width, StagePlan* p) {
  if (lo < 0 || hi < lo || (lo & 3) || (hi & 3)) return false;
  p->lo = lo;
  p->hi = hi;
  p->span = 0;
  p->cap = max(32, round_up(hi - lo, 32));
  p->single = 1;
  StagePlan one = *p;
  if (stage_fit(&one, true) && one.stages == 2) {
    *p = one;
    return true;
  }
  p->cap = max(kTileSlots, round_up(width + 6, 32));
  p->single = p->cap >= hi - lo;
  return stage_fit(p, true);
}

template <typename Kernel>
int allow_smem(Kernel kernel, long long smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Group mode: one block per chunk, then group_reduce over the partials.
template <bool DROPS, bool RAGGED>
int launch_staged_chunks(const float* vals, long long stride,
                         const float* vbase, const int* order,
                         const int* chunk_lo, const int* chunk_hi,
                         long long n_chunks, const int* gco, int Gp,
                         WindowRows wr, int W, StagePlan p, int is_counter,
                         int is_rate, float* partial, float* out,
                         cudaStream_t s) {
  if (n_chunks > 0) {
    const long long smem = stage_smem(p, RAGGED);
    auto kernel = staged_rows<DROPS, RAGGED, false>;
    int err = allow_smem(kernel, smem);
    if (err) return err;
    kernel<<<(unsigned)n_chunks, p.rows * 32, smem, s>>>(
        vals, stride, vbase, order, chunk_lo, chunk_hi, 0, wr, W, p,
        is_counter, is_rate, n_chunks, partial, nullptr);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return launch_reduce(partial, n_chunks, gco, Gp, W, RAGGED ? 2 : 1, out, s);
}

// Per-series mode: one block per kSeriesChunk consecutive rows.
template <bool DROPS, bool RAGGED>
int launch_staged_series(const float* vals, long long stride,
                         const float* vbase, long long num_rows,
                         WindowRows wr, int W, StagePlan p, int is_counter,
                         int is_rate, float* out, float* pres,
                         cudaStream_t s) {
  if (num_rows == 0) return 0;
  const long long smem = stage_smem(p, RAGGED);
  auto kernel = staged_rows<DROPS, RAGGED, true>;
  int err = allow_smem(kernel, smem);
  if (err) return err;
  const long long blocks = (num_rows + kSeriesChunk - 1) / kSeriesChunk;
  kernel<<<(unsigned)blocks, p.rows * 32, smem, s>>>(
      vals, stride, vbase, nullptr, nullptr, nullptr, num_rows, wr, W, p,
      is_counter, is_rate, blocks, out, pres);
  return (int)cudaGetLastError();
}

}  // namespace
