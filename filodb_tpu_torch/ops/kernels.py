"""Build and bind the port's CUDA kernels (csrc/*.cu).

Each source is compiled at first use by nvcc into a plain-C shared
library under filodb_tpu_torch/build/ (git-ignored), named by the hash
of the source and the shared headers (csrc/*.cuh) so an edited source
rebuilds, and loaded with ctypes.  Nothing is built or loaded when this
module is imported.

The launch functions below are the only places the kernels are launched:
they check device, dtype, shape and contiguity, allocate the outputs and
scratch with torch, launch on torch.cuda.current_stream(), raise on a
non-zero cudaGetLastError(), and add one to their entry in LAUNCHES.

Each nvcc build is journaled as a compile in the device telemetry
(utils/devicetelem.record_compile: the source's name and its nvcc wall
seconds); every `library()` call that finds its library already loaded
or built counts as a cache hit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = {"fused_rate": CSRC / "fused_rate.cu",
           "fused_over_time": CSRC / "fused_over_time.cu",
           "fused_drops": CSRC / "fused_drops.cu",
           "probe_select": CSRC / "probe_select.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC"]

LAUNCHES: Dict[str, int] = {
    name + suffix: 0
    for name in ("fused_rate_dense", "fused_rate_ragged", "fused_last_dense",
                 "fused_last_ragged", "fused_over_time_dense",
                 "fused_over_time_ragged", "fused_rate_drops_dense",
                 "fused_rate_drops_ragged")
    for suffix in ("", "_series")}
LAUNCHES.update({name: 0 for name in ("probe_gather", "probe_two_gathers",
                                      "probe_onehot_matmul")})
"""Kernel launches per wrapper since process start (or the last reset).
`<kernel>` is the group-sum mode (K1, K3, K4, K5, and K2 as
`fused_rate_drops_*`), `<kernel>_series` the per-series mode (K6) of the
same kernel; `probe_*` are the three strategies of the column-selection
probe (K8, csrc/probe_select.cu)."""

NO_FIT = -1
"""What a staged launcher (K2, K3) returns when a row's staged slots do
not fit in one block's shared memory: K2's span (with its index tables
when ragged) or K3's widest window; csrc/rate_stage.cuh decides it
(kNoFit), and the wrappers raise ValueError for it."""

# kind codes of csrc/fused_over_time.cu
_SLOT_KIND = {"last_over_time": 0, "sum_over_time": 1, "avg_over_time": 2,
              "count_over_time": 3}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    pass


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def find_nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise KernelBuildError("nvcc not found (set NVCC or put it on PATH)")


def library_path(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def start_builds(names=None
                 ) -> Dict[str, Tuple[subprocess.Popen, Path, float]]:
    """Start one nvcc per missing library, all at once; returns
    {name: (process, temporary output, start time)} for finish_builds to
    wait on."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names or SOURCES:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, time.perf_counter())
    return procs


def finish_builds(procs) -> None:
    """Wait for the builds; each library's nvcc output (with ptxas's
    resource lines, -Xptxas -v) is kept beside it as <library>.log, and
    each successful build is journaled as a compile with its wall
    seconds (from its start to the moment it was seen finished)."""
    from filodb_tpu_torch.utils.devicetelem import telem
    errors = []
    for name, (p, tmp, t0) in procs.items():
        log, _ = p.communicate()
        seconds = time.perf_counter() - t0
        if p.returncode != 0:
            errors.append(f"{name}: nvcc exit {p.returncode}\n{log}")
            continue
        library_path(name).with_suffix(".log").write_text(log)
        os.replace(tmp, library_path(name))
        telem.record_compile(name, shape="sm_90a", seconds=seconds)
    if errors:
        raise KernelBuildError("\n".join(errors))


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PTXAS_USED = re.compile(r"Used (\d+) registers")
_PTXAS_SMEM = re.compile(r"(\d+) bytes smem")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def ptxas_report(name: str):
    """[{kernel, registers, smem, spill_stores, spill_loads}] of one
    library's kernels from its build log (static shared memory only: the
    staged kernels' rows are dynamic), or [] when the library was built
    by another process."""
    path = library_path(name).with_suffix(".log")
    if not path.exists():
        return []
    out, cur = [], None
    for line in path.read_text().splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            cur = dict(kernel=m.group(1), registers=None, smem=0,
                       spill_stores=0, spill_loads=0)
            out.append(cur)
            continue
        if cur is None:
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = _PTXAS_USED.search(line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = _PTXAS_SMEM.search(line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    return out


def _bind(lib: ctypes.CDLL) -> None:
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.fused_rate_dense_launch.argtypes = [
        vp, ll, vp, vp, vp, vp, ll, vp, i,      # vals..Gp
        vp, vp, vp, vp, vp, vp, vp, i,          # idx1..we, W
        i, i, vp, vp, vp]                       # flags, partial, out, stream
    lib.fused_rate_dense_launch.restype = i
    lib.fused_rate_ragged_launch.argtypes = [
        vp, ll, vp, vp, vp, vp, ll, vp, i,
        vp, vp, vp, vp, vp, i,                  # idx1, idx2, ws, we, tsrow, W
        i, i, i,                                # lo, hi, width
        i, i, vp, vp, vp]
    lib.fused_rate_ragged_launch.restype = i
    lib.fused_rate_dense_series_launch.argtypes = [
        vp, ll, vp, ll,                         # vals, stride, vbase, rows
        vp, vp, vp, vp, vp, vp, vp, i,          # idx1..we, W
        i, i, vp, vp]                           # flags, out, stream
    lib.fused_rate_dense_series_launch.restype = i
    lib.fused_rate_ragged_series_launch.argtypes = [
        vp, ll, vp, ll,
        vp, vp, vp, vp, vp, i,                  # idx1, idx2, ws, we, tsrow, W
        i, i, i,                                # lo, hi, width
        i, i, vp, vp, vp]                       # flags, out, pres, stream
    lib.fused_rate_ragged_series_launch.restype = i


def _bind_over_time(lib: ctypes.CDLL) -> None:
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.fused_over_time_launch.argtypes = [
        vp, ll, vp, vp, vp, vp, ll, vp, i,      # vals..Gp
        vp, vp, vp, i,                          # idx1, idx2, n1, W
        i, i, vp, vp, vp]                       # kind, ragged, partial, out,
    lib.fused_over_time_launch.restype = i      # stream
    lib.fused_over_time_series_launch.argtypes = [
        vp, ll, vp, ll,                         # vals, stride, vbase, rows
        vp, vp, vp, i,                          # idx1, idx2, n1, W
        i, i, vp, vp, vp]                       # kind, ragged, out, pres,
    lib.fused_over_time_series_launch.restype = i  # stream


def _bind_drops(lib: ctypes.CDLL) -> None:
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    rows = [vp] * 8 + [i, i]                    # idx1..tsrow, W, span
    for mode in ("dense", "ragged"):
        f = getattr(lib, f"fused_rate_drops_{mode}_launch")
        f.argtypes = [vp, ll, vp, vp, vp, vp, ll, vp, i,   # vals..Gp
                      *rows, i, i, vp, vp, vp]  # flags, partial, out, stream
        f.restype = i
        f = getattr(lib, f"fused_rate_drops_{mode}_series_launch")
        f.argtypes = [vp, ll, vp, ll,           # vals, stride, vbase, rows
                      *rows, i, i, vp, vp, vp]  # flags, out, pres, stream
        f.restype = i


def _bind_probe(lib: ctypes.CDLL) -> None:
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.probe_gather_launch.argtypes = [vp, ll, ll, vp, i, i, vp, vp]
    lib.probe_gather_launch.restype = i
    lib.probe_two_gathers_launch.argtypes = [vp, ll, ll, vp, vp, i, i, vp,
                                             vp]
    lib.probe_two_gathers_launch.restype = i
    lib.probe_onehot_matmul_launch.argtypes = [vp, ll, i, vp, i, vp, vp, vp,
                                               vp, vp]
    lib.probe_onehot_matmul_launch.restype = i


_BINDERS = {"fused_rate": _bind, "fused_over_time": _bind_over_time,
            "fused_drops": _bind_drops, "probe_select": _bind_probe}


def library(name: str = "fused_rate") -> ctypes.CDLL:
    """The loaded library, built first if missing (the device telemetry
    counts the calls that needed no build as cache hits)."""
    from filodb_tpu_torch.utils.devicetelem import watched_call
    return watched_call(name, lambda: _load(name))


def _load(name: str) -> Tuple[ctypes.CDLL, bool]:
    """(the loaded library, whether this call built it)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib, False
    built = False
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not library_path(name).exists():
                finish_builds(start_builds([name]))
                built = True
            lib = ctypes.CDLL(str(library_path(name)))
            _BINDERS[name](lib)
            _libs[name] = lib
    return lib, built


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _check(t: torch.Tensor, what: str, dtype, device, shape=None) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def _check_values(vals_p, vbase_p, rows):
    """Device, dtype, shape and contiguity of the values and the window
    rows every kernel reads -> (device, Tp, W)."""
    dev = vals_p.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {dev}")
    if vals_p.dim() != 2:
        raise ValueError("vals_p must be [rows, Tp]")
    Sp, Tp = vals_p.shape
    W = rows.idx1.numel()
    _check(vals_p, "vals_p", torch.float32, dev)
    _check(vbase_p, "vbase_p", torch.float32, dev, (Sp,))
    for name in ("idx1", "idx2"):
        _check(getattr(rows, name), name, torch.int32, dev, (W,))
    for name in ("t1", "t2", "n", "ws", "we", "n1"):
        _check(getattr(rows, name), name, torch.float32, dev, (W,))
    _check(rows.tsrow, "tsrow", torch.float32, dev, (Tp,))
    if W < 1:
        raise ValueError("fused kernel needs at least one window")
    return dev, Tp, W


def _check_common(vals_p, vbase_p, order, chunks, rows, Gp):
    """_check_values plus the CSR order and its chunk plan (group mode)."""
    dev, Tp, W = _check_values(vals_p, vbase_p, rows)
    _check(order, "order", torch.int32, dev)
    C = chunks.lo.numel()
    _check(chunks.lo, "chunk lo", torch.int32, dev, (C,))
    _check(chunks.hi, "chunk hi", torch.int32, dev, (C,))
    _check(chunks.gco, "group chunk offsets", torch.int32, dev, (Gp + 1,))
    return dev, Tp, W, C


def _check_staged(vals_p) -> None:
    """The staged kernels (K2, K3) copy rows 16 bytes at a time: the row
    stride must be a multiple of 4 slots and the base 16-byte aligned."""
    if vals_p.shape[1] % 4:
        raise ValueError(f"staged kernel needs a row stride that is a "
                         f"multiple of 4 slots, got {vals_p.shape[1]}")
    if vals_p.data_ptr() % 16:
        raise ValueError("staged kernel needs vals_p 16-byte aligned")


def _ragged_stage(vals_p, rows):
    """K3's staged slot range (rows.stage_lo, rows.stage_hi, rows.width),
    checked against the row width."""
    _check_staged(vals_p)
    lo, hi, width = int(rows.stage_lo), int(rows.stage_hi), int(rows.width)
    if not 0 <= lo <= hi <= vals_p.shape[1] or lo % 4 or hi % 4:
        raise ValueError(f"plan stage [{lo}, {hi}) outside the row width "
                         f"{vals_p.shape[1]} or not a multiple of 4")
    return lo, hi, width


def _raise_on(err: int, name: str) -> None:
    if err == NO_FIT:
        raise ValueError(f"{name}: a row's staged slots do not fit in one "
                         f"block's shared memory (K2: the plan's span, K3: "
                         f"its widest window)")
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def fused_rate_dense_cuda(vals_p, vbase_p, order, chunks, rows, Gp: int,
                          is_counter: bool, is_rate: bool) -> torch.Tensor:
    """Launch K1 -> sums [Gp, W] f32 (see csrc/fused_rate.cu)."""
    dev, Tp, W, C = _check_common(vals_p, vbase_p, order, chunks, rows, Gp)
    lib = library()
    partial = torch.empty((max(C, 1), W), dtype=torch.float32, device=dev)
    out = torch.empty((Gp, W), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.fused_rate_dense_launch(
        _ptr(vals_p), Tp, _ptr(vbase_p), _ptr(order), _ptr(chunks.lo),
        _ptr(chunks.hi), C, _ptr(chunks.gco), Gp,
        _ptr(rows.idx1), _ptr(rows.idx2), _ptr(rows.t1), _ptr(rows.t2),
        _ptr(rows.n), _ptr(rows.ws), _ptr(rows.we), W,
        int(is_counter), int(is_rate), _ptr(partial), _ptr(out), stream)
    _raise_on(err, "fused_rate_dense")
    LAUNCHES["fused_rate_dense"] += 1
    return out


def fused_rate_ragged_cuda(vals_p, vbase_p, order, chunks, rows, Gp: int,
                           is_counter: bool, is_rate: bool):
    """Launch K3 -> (sums, presence) [Gp, W] f32."""
    dev, Tp, W, C = _check_common(vals_p, vbase_p, order, chunks, rows, Gp)
    stage = _ragged_stage(vals_p, rows)
    lib = library()
    partial = torch.empty((2, max(C, 1), W), dtype=torch.float32, device=dev)
    out = torch.empty((2, Gp, W), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.fused_rate_ragged_launch(
        _ptr(vals_p), Tp, _ptr(vbase_p), _ptr(order), _ptr(chunks.lo),
        _ptr(chunks.hi), C, _ptr(chunks.gco), Gp,
        _ptr(rows.idx1), _ptr(rows.idx2), _ptr(rows.ws), _ptr(rows.we),
        _ptr(rows.tsrow), W, *stage, int(is_counter), int(is_rate),
        _ptr(partial), _ptr(out), stream)
    _raise_on(err, "fused_rate_ragged")
    LAUNCHES["fused_rate_ragged"] += 1
    return out[0], out[1]


def _kernel_name(kind: str, ragged: bool, with_drops: bool = False) -> str:
    base = {"rate_family": "fused_rate",
            "last_over_time": "fused_last"}.get(kind, "fused_over_time")
    if with_drops:
        if kind != "rate_family":
            raise ValueError(f"in-kernel drops apply to the rate family, "
                             f"not {kind}")
        base = "fused_rate_drops"
    return f"{base}_{'ragged' if ragged else 'dense'}"


def _check_span(vals_p, rows) -> int:
    """The slots K2 reads from each row (rows.span), checked against the
    row width."""
    _check_staged(vals_p)
    span, Tp = int(rows.span), vals_p.shape[1]
    if not 1 <= span <= Tp:
        raise ValueError(f"plan span {span} outside the row width {Tp}")
    return span


def _drops_args(rows, W: int, span: int):
    """The operands every K2 entry point takes after (vals..Gp) or (vals,
    stride, vbase, num_rows): the window rows, W and span."""
    return (_ptr(rows.idx1), _ptr(rows.idx2), _ptr(rows.t1), _ptr(rows.t2),
            _ptr(rows.n), _ptr(rows.ws), _ptr(rows.we), _ptr(rows.tsrow), W,
            span)


def fused_rate_drops_cuda(vals_p, vbase_p, order, chunks, rows, Gp: int,
                          is_counter: bool, is_rate: bool, ragged: bool):
    """Launch K2 in group mode -> sums [Gp, W] f32 (dense) or (sums,
    presence) (ragged); see csrc/fused_drops.cu."""
    dev, Tp, W, C = _check_common(vals_p, vbase_p, order, chunks, rows, Gp)
    span = _check_span(vals_p, rows)
    lib = library("fused_drops")
    planes = 2 if ragged else 1
    partial = torch.empty((planes, max(C, 1), W), dtype=torch.float32,
                          device=dev)
    out = torch.empty((planes, Gp, W), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    name = _kernel_name("rate_family", ragged, with_drops=True)
    err = getattr(lib, name + "_launch")(
        _ptr(vals_p), Tp, _ptr(vbase_p), _ptr(order), _ptr(chunks.lo),
        _ptr(chunks.hi), C, _ptr(chunks.gco), Gp,
        *_drops_args(rows, W, span), int(is_counter),
        int(is_rate), _ptr(partial), _ptr(out), stream)
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return (out[0], out[1]) if ragged else out[0]


def fused_over_time_cuda(vals_p, vbase_p, order, chunks, rows, Gp: int,
                         kind: str, ragged: bool):
    """Launch K4 (kind last_over_time) or K5 (sum/avg/count_over_time) in
    group mode -> sums [Gp, W] f32 (dense) or (sums, presence) (ragged);
    see csrc/fused_over_time.cu."""
    dev, Tp, W, C = _check_common(vals_p, vbase_p, order, chunks, rows, Gp)
    code = _SLOT_KIND[kind]
    lib = library("fused_over_time")
    planes = 2 if ragged else 1
    partial = torch.empty((planes, max(C, 1), W), dtype=torch.float32,
                          device=dev)
    out = torch.empty((planes, Gp, W), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.fused_over_time_launch(
        _ptr(vals_p), Tp, _ptr(vbase_p), _ptr(order), _ptr(chunks.lo),
        _ptr(chunks.hi), C, _ptr(chunks.gco), Gp,
        _ptr(rows.idx1), _ptr(rows.idx2), _ptr(rows.n1), W, code,
        int(ragged), _ptr(partial), _ptr(out), stream)
    name = _kernel_name(kind, ragged)
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return (out[0], out[1]) if ragged else out[0]


def fused_per_series_cuda(vals_p, vbase_p, rows, num_rows: int, kind: str,
                          ragged: bool, is_counter: bool = False,
                          is_rate: bool = False, with_drops: bool = False):
    """Launch the per-series mode (K6) of K1/K3 (kind rate_family), K2
    (rate_family with_drops) or K4/K5 -> (values [num_rows, W] f32,
    presence [num_rows, W] f32 when ragged, else None)."""
    dev, Tp, W = _check_values(vals_p, vbase_p, rows)
    if not 0 <= num_rows <= vals_p.shape[0]:
        raise ValueError(f"num_rows={num_rows} outside the {vals_p.shape[0]} "
                         f"rows of vals_p")
    out = torch.empty((num_rows, W), dtype=torch.float32, device=dev)
    pres = (torch.empty((num_rows, W), dtype=torch.float32, device=dev)
            if ragged else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    name = _kernel_name(kind, ragged, with_drops) + "_series"
    if with_drops:
        span = _check_span(vals_p, rows)
        err = getattr(library("fused_drops"), name + "_launch")(
            _ptr(vals_p), Tp, _ptr(vbase_p), num_rows,
            *_drops_args(rows, W, span),
            int(is_counter), int(is_rate), _ptr(out),
            _ptr(pres) if ragged else None, stream)
    elif kind == "rate_family":
        lib = library("fused_rate")
        if ragged:
            err = lib.fused_rate_ragged_series_launch(
                _ptr(vals_p), Tp, _ptr(vbase_p), num_rows,
                _ptr(rows.idx1), _ptr(rows.idx2), _ptr(rows.ws),
                _ptr(rows.we), _ptr(rows.tsrow), W,
                *_ragged_stage(vals_p, rows), int(is_counter),
                int(is_rate), _ptr(out), _ptr(pres), stream)
        else:
            err = lib.fused_rate_dense_series_launch(
                _ptr(vals_p), Tp, _ptr(vbase_p), num_rows,
                _ptr(rows.idx1), _ptr(rows.idx2), _ptr(rows.t1),
                _ptr(rows.t2), _ptr(rows.n), _ptr(rows.ws), _ptr(rows.we),
                W, int(is_counter), int(is_rate), _ptr(out), stream)
    else:
        code = _SLOT_KIND[kind]
        lib = library("fused_over_time")
        err = lib.fused_over_time_series_launch(
            _ptr(vals_p), Tp, _ptr(vbase_p), num_rows, _ptr(rows.idx1),
            _ptr(rows.idx2), _ptr(rows.n1), W, code, int(ragged), _ptr(out),
            _ptr(pres) if ragged else None, stream)
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out, pres


def _check_probe(x, idx, what):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {dev}")
    if x.dim() != 2:
        raise ValueError("x must be [rows, K]")
    _check(x, "x", torch.float32, dev)
    for i, t in enumerate(idx):
        _check(t, f"{what} index {i + 1}", torch.int32, dev)
    return dev


def _check_selection(x, idx, W: int, WP: int):
    if not 0 <= W <= WP:
        raise ValueError(f"W={W} outside [0, WP={WP}]")
    for t in idx:
        if t.numel() < W:
            raise ValueError(f"an index row of {t.numel()} for W={W}")


def probe_gather_cuda(x, idx1, W: int, WP: int) -> torch.Tensor:
    """Launch K8's gather: y [rows, WP] f32, y[:, w] = x[:, idx1[w]] for
    w < W, 0 beyond (csrc/probe_select.cu)."""
    dev = _check_probe(x, (idx1,), "probe_gather")
    _check_selection(x, (idx1,), W, WP)
    y = torch.empty((x.shape[0], WP), dtype=torch.float32, device=dev)
    err = library("probe_select").probe_gather_launch(
        _ptr(x), x.shape[0], x.shape[1], _ptr(idx1), W, WP, _ptr(y),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "probe_gather")
    LAUNCHES["probe_gather"] += 1
    return y


def probe_two_gathers_cuda(x, idx1, idx2, W: int, WP: int) -> torch.Tensor:
    """Launch K8's difference of two gathers: y[:, w] = x[:, idx2[w]] -
    x[:, idx1[w]] for w < W, 0 beyond."""
    dev = _check_probe(x, (idx1, idx2), "probe_two_gathers")
    _check_selection(x, (idx1, idx2), W, WP)
    y = torch.empty((x.shape[0], WP), dtype=torch.float32, device=dev)
    err = library("probe_select").probe_two_gathers_launch(
        _ptr(x), x.shape[0], x.shape[1], _ptr(idx1), _ptr(idx2), W, WP,
        _ptr(y), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "probe_two_gathers")
    LAUNCHES["probe_two_gathers"] += 1
    return y


def probe_onehot_matmul_cuda(x, onehot) -> torch.Tensor:
    """Launch K8's product: y = x @ onehot in FP32 for any onehot [K, N],
    summed over each column's nonzero entries (csrc/probe_select.cu: the
    column lists, then x streamed once through shared memory); K and N
    multiples of 4, x contiguous, 16-byte aligned bases."""
    dev = _check_probe(x, (), "probe_onehot_matmul")
    rows, K = x.shape
    _check(onehot, "onehot", torch.float32, dev)
    if onehot.dim() != 2 or onehot.shape[0] != K:
        raise ValueError(f"onehot must be [{K}, N], got "
                         f"{tuple(onehot.shape)}")
    N = onehot.shape[1]
    if K % 4 or N % 4 or x.data_ptr() % 16 or onehot.data_ptr() % 16:
        raise ValueError("probe_onehot_matmul needs K and N multiples of 4 "
                         "and 16-byte aligned operands")
    lk = torch.empty((K, N), dtype=torch.int32, device=dev)
    lv = torch.empty((K, N), dtype=torch.float32, device=dev)
    cnt = torch.empty((N,), dtype=torch.int32, device=dev)
    y = torch.empty((rows, N), dtype=torch.float32, device=dev)
    err = library("probe_select").probe_onehot_matmul_launch(
        _ptr(x), rows, K, _ptr(onehot), N, _ptr(lk), _ptr(lv), _ptr(cnt),
        _ptr(y), torch.cuda.current_stream(dev).cuda_stream)
    if err == NO_FIT:
        raise ValueError(f"probe_onehot_matmul: a row of K={K} floats does "
                         f"not fit the shared-memory ring")
    _raise_on(err, "probe_onehot_matmul")
    LAUNCHES["probe_onehot_matmul"] += 1
    return y
