"""Optional C++ host library (port of filodb_tpu/native): xxhash32 and
xxhash64, the NibblePack codec and the single-core iterator rate, bound
with ctypes.

`lib` is the loaded library or None, as in the reference.  Nothing is
built or loaded when this module is imported: the first read of `lib`
(a module __getattr__) calls `load()`, which compiles filodb_native.cc
with g++ (`$CXX` when set) into filodb_tpu_torch/build/ (git-ignored),
under a name carrying the hash of the source, so an edited source
rebuilds; the answer is then kept as the module's `lib`.  The compiler
writes to a temporary name that is then moved into place with
os.replace, so processes that build at the same time never load a
half-written file.  Without a compiler, or when the build or the load
fails, `lib` is None and every caller keeps its numpy and Python paths,
as the reference does; `build_error()` says why.  Nothing is written
beside this module, and the reference's own library is never loaded.

The hashes and the codec are bound through ctypes.PyDLL, which keeps the
interpreter lock over the call: they take microseconds, and a call that
drops the lock (ctypes.CDLL, the reference's binding) hands it to
another thread each time and waits for it back, which under four
remote-write handler threads made the door's slab building several
times slower.  iter_rate, one long loop, drops the lock (CDLL).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().with_name("filodb_native.cc")
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
CXXFLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]

_lock = threading.Lock()
_tried = False
_lib: Optional["NativeLib"] = None
_error = ""


class NativeLib:
    def __init__(self, path: Path):
        self._c = ctypes.PyDLL(str(path))
        self._long = ctypes.CDLL(str(path))
        self.path = path
        c = self._c
        c.filodb_xxhash32.restype = ctypes.c_uint32
        c.filodb_xxhash32.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                      ctypes.c_uint32]
        c.filodb_xxhash64.restype = ctypes.c_uint64
        c.filodb_xxhash64.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                      ctypes.c_uint64]
        c.filodb_nibble_pack.restype = ctypes.c_long
        c.filodb_nibble_pack.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t]
        c.filodb_nibble_unpack.restype = ctypes.c_long
        c.filodb_nibble_unpack.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_size_t]
        c = self._long
        c.filodb_iter_rate.restype = None
        c.filodb_iter_rate.argtypes = [
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_double),
            ctypes.c_size_t, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_size_t,
            ctypes.c_longlong, ctypes.POINTER(ctypes.c_double)]

    def xxhash32(self, data: bytes, seed: int = 0) -> int:
        return self._c.filodb_xxhash32(data, len(data), seed)

    def xxhash64(self, data: bytes, seed: int = 0) -> int:
        return self._c.filodb_xxhash64(data, len(data), seed)

    def nibble_pack(self, values: np.ndarray) -> bytes:
        vals = np.ascontiguousarray(values, dtype=np.uint64)
        n = len(vals)
        cap = ((n + 7) // 8) * 66
        out = np.empty(cap, dtype=np.uint8)
        written = self._c.filodb_nibble_pack(
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
        if written < 0:
            raise ValueError("nibble_pack: output buffer overflow")
        return out[:written].tobytes()

    def nibble_unpack(self, data: bytes, count: int) -> np.ndarray:
        buf = np.frombuffer(data, dtype=np.uint8)
        out = np.empty(count, dtype=np.uint64)
        consumed = self._c.filodb_nibble_unpack(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), count)
        if consumed < 0:
            raise ValueError("nibble_unpack: truncated input")
        return out

    def iter_rate(self, ts_row: np.ndarray, vals: np.ndarray,
                  wends: np.ndarray, range_ms: int) -> np.ndarray:
        """Per-(series, window) extrapolated rate, single C core — the
        compiled ChunkedWindowIterator stand-in."""
        ts = np.ascontiguousarray(ts_row, dtype=np.int64)
        v = np.ascontiguousarray(vals, dtype=np.float64)
        we = np.ascontiguousarray(wends, dtype=np.int64)
        S, T = v.shape
        out = np.empty((S, len(we)), dtype=np.float64)
        self._long.filodb_iter_rate(
            ts.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), S, T,
            we.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), len(we),
            int(range_ms),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return out


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libfilodb_native-{digest}.so"


def _build(out: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++ not on PATH, CXX unset)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} exit {proc.returncode}: "
                               f"{proc.stderr.strip()[-2000:]}")
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()


def load() -> Optional[NativeLib]:
    """The loaded library, building it on the first call; None when it
    cannot be built or loaded (then `build_error()` says why)."""
    global _tried, _lib, _error
    if _tried:
        return _lib
    with _lock:
        if not _tried:
            try:
                path = library_path()
                if not path.exists():
                    _build(path)
                _lib = NativeLib(path)
            except Exception as e:  # noqa: BLE001 — the fallbacks serve
                _lib, _error = None, f"{type(e).__name__}: {e}"
            _tried = True
    return _lib


def build_error() -> str:
    """Why `lib` is None ("" when it loaded or was not asked yet)."""
    return _error


def __getattr__(name: str):
    # PEP 562: `lib` is resolved at its first read, then kept in the
    # module's globals, so later reads never come here
    if name == "lib":
        globals()["lib"] = got = load()
        return got
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
