"""Predictive NibblePack codec (port of filodb_tpu/memory/nibblepack.py,
with its three paths).

Storage scheme per the reference spec (ref: doc/compression.md:33-90,
memory/src/main/scala/filodb.memory/format/NibblePack.scala): groups of 8
u64 values are encoded as

  +0  u8 bitmask (bit i set => value i nonzero; LSB = first value)
  +1  u8: bits 0-3 = trailing zero nibbles, bits 4-7 = numNibbles-1
      (skipped when bitmask == 0)
  +2  packed nibble stream, LSB-first per value, for each nonzero value
      (skipped when bitmask == 0)

This is the host-side wire/storage codec; decoded data lives as dense
arrays for the device.  Three interchangeable implementations, all
bit-exact (with each other and with the reference's):

  - C (filodb_tpu_torch/native, built at first use), used when it loads;
  - vectorized NumPy (_pack_vec/_unpack_vec): group-wise uint64 ops over
    ALL groups at once — no Python loop per group — the fallback;
  - pure-Python reference (_pack_py/_unpack_py): the readable spec,
    kept as the parity oracle and for tiny inputs where NumPy dispatch
    overhead exceeds the loop cost.

Used for timestamps (after delta-delta), doubles (after XOR predictor) and
histogram bucket deltas.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from filodb_tpu_torch import native as _native

_M64 = 0xFFFFFFFFFFFFFFFF

# below this many values the pure-Python loop beats NumPy dispatch overhead
# (measured crossover ~3 groups on this host; see tests/test_nibblepack.py
# parity fuzz for the bit-exactness contract that makes the switch safe)
_VEC_MIN_VALUES = 32

# popcount LUT for uint8 bitmasks (np.bitwise_count needs numpy>=2.0;
# a 256-entry gather is just as fast for our [G] masks and always there)
_POPCNT8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint8)

# _KTH8[mask, k] = bit index of the k-th set bit of `mask` (0 when absent):
# maps "k-th nonzero value of the group" back to its slot 0..7
_KTH8 = np.zeros((256, 8), dtype=np.uint8)
for _m in range(256):
    _set = [i for i in range(8) if _m & (1 << i)]
    for _k, _i in enumerate(_set):
        _KTH8[_m, _k] = _i
del _m, _set

# payload-nibble q of a group with nn nibbles/value belongs to nonzero
# value q//nn, nibble q%nn — tabulated so the hot loop gathers instead of
# integer-dividing [G, 128] arrays (row nn=0 is never consulted: tn==0)
_QDIV = np.zeros((17, 128), dtype=np.uint8)
_QMOD = np.zeros((17, 128), dtype=np.uint8)
for _nn in range(1, 17):
    _q = np.arange(128)
    _QDIV[_nn] = np.minimum(_q // _nn, 7)
    _QMOD[_nn] = _q % _nn
del _nn, _q


def _trailing_zero_nibbles(x: int) -> int:
    if x == 0:
        return 16
    n = 0
    while (x & 0xF) == 0:
        x >>= 4
        n += 1
    return n


def _leading_zero_nibbles(x: int) -> int:
    if x == 0:
        return 16
    return 16 - ((x.bit_length() + 3) // 4)


def pack(values: np.ndarray) -> bytes:
    """Pack an array of uint64 into NibblePack bytes.  Length is encoded by the
    caller (chunk metadata holds numRows); trailing group is zero-padded."""
    lib = _native.lib
    if lib is not None:
        return lib.nibble_pack(values)
    if len(values) < _VEC_MIN_VALUES:
        return _pack_py(values)
    return _pack_vec(values)


def _pack_py(values: np.ndarray) -> bytes:
    vals = np.asarray(values, dtype=np.uint64)
    n = len(vals)
    out = bytearray()
    ngroups = (n + 7) // 8
    padded = np.zeros(ngroups * 8, dtype=np.uint64)
    padded[:n] = vals
    for g in range(ngroups):
        group = [int(v) for v in padded[g * 8:(g + 1) * 8]]
        bitmask = 0
        for i, v in enumerate(group):
            if v != 0:
                bitmask |= 1 << i
        out.append(bitmask)
        if bitmask == 0:
            continue
        trailing = min(_trailing_zero_nibbles(v) for v in group if v != 0)
        leading = min(_leading_zero_nibbles(v) for v in group if v != 0)
        num_nibbles = 16 - leading - trailing
        out.append((trailing & 0xF) | ((num_nibbles - 1) << 4))
        # Pack nibbles LSB-first across all nonzero values.
        acc = 0
        acc_bits = 0
        for v in group:
            if v == 0:
                continue
            shifted = v >> (trailing * 4)
            acc |= (shifted & ((1 << (num_nibbles * 4)) - 1)) << acc_bits
            acc_bits += num_nibbles * 4
        while acc_bits > 0:
            out.append(acc & 0xFF)
            acc >>= 8
            acc_bits -= 8
    return bytes(out)


def _nibble_geometry(v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-value (trailing_zero_nibbles, nibble_length) for a uint64 array,
    via branch-free binary descent (vectorized steps instead of a Python
    while-loop per value).  Zero values report (15, 0) — callers mask them
    out before taking group minima.  The descent runs at the narrowest
    dtype covering the batch's max value (delta-delta payloads are tiny,
    and uint64 passes would quadruple the memory traffic for them);
    accumulators are uint8 since counts never exceed 16."""
    vmax = int(v.max()) if v.size else 0
    if vmax < (1 << 16):
        x0, rounds = v.astype(np.uint16), ((8, 2), (4, 1))
    elif vmax < (1 << 32):
        x0, rounds = v.astype(np.uint32), ((16, 4), (8, 2), (4, 1))
    else:
        x0, rounds = v, ((32, 8), (16, 4), (8, 2), (4, 1))
    dt = x0.dtype.type
    tz = np.zeros(v.shape, dtype=np.uint8)
    nl = np.zeros(v.shape, dtype=np.uint8)
    x_tz = x0.copy()
    x_nl = x0.copy()
    for bits, nibs in rounds:
        b = dt(bits)
        lowmask = dt((1 << bits) - 1)
        m = (x_tz & lowmask) == 0
        tz += np.where(m, np.uint8(nibs), np.uint8(0))
        x_tz = np.where(m, x_tz >> b, x_tz)
        hi = (x_nl >> b) != 0
        nl += np.where(hi, np.uint8(nibs), np.uint8(0))
        x_nl = np.where(hi, x_nl >> b, x_nl)
    nl += (x_nl != 0)
    return tz, nl


def _pack_vec(values: np.ndarray) -> bytes:
    """Vectorized NumPy pack: bit-exact with _pack_py / the C codec, but
    every step operates on ALL 8-value groups at once.  Per-group rows of
    [bitmask | header | payload bytes] are assembled in a [G, width]
    matrix and the variable-width byte stream falls out of one row-major
    boolean compaction.  Intermediate work stays in uint8/int32 (the
    nibble matrix comes from a little-endian byte VIEW of the shifted
    values, not 16 uint64 shift+masks) so memory traffic, not dtype
    width, bounds the cost."""
    vals = np.asarray(values, dtype=np.uint64)
    n = len(vals)
    if n == 0:
        return b""
    G = (n + 7) // 8
    if not vals.any():
        # all-zero input (constant-slope timestamps after delta-delta):
        # G empty-bitmask groups, nothing else to compute
        return b"\x00" * G
    v = np.zeros(G * 8, dtype=np.uint64)
    v[:n] = vals
    v = v.reshape(G, 8)
    nzmask = v != 0
    bitmask = np.packbits(nzmask, axis=1, bitorder="little")[:, 0]   # [G]
    nz = _POPCNT8[bitmask].astype(np.int32)                          # [G]
    has = nz > 0

    tz, nl = _nibble_geometry(v)
    sentinel = np.uint8(63)
    trailing = np.where(nzmask, tz, sentinel).min(axis=1)
    leading = np.where(nzmask, np.uint8(16) - nl, sentinel).min(axis=1)
    trailing = np.where(has, trailing, np.uint8(0)).astype(np.int32)
    leading = np.where(has, leading, np.uint8(0)).astype(np.int32)
    nn = np.where(has, 16 - leading - trailing, 0)     # nibbles per value

    # layout: 1 bitmask byte (+ 1 header + ceil(nibbles/2) when nonzero)
    tn = nz * nn                                       # nibbles per group
    payload_bytes = (tn + 1) // 2
    gsize = 1 + np.where(has, 1 + payload_bytes, 0)

    # nibble stream: per nonzero value, nn LSB-first nibbles of v >> 4*tz.
    # Little-endian byte view of the shifted values = the 16 nibbles of
    # each value, so splitting bytes gives the nibble matrix in two
    # uint8 ops instead of sixteen uint64 shift+masks.
    shifted = v >> (trailing.astype(np.uint64) * np.uint64(4))[:, None]
    b8 = shifted.astype("<u8", copy=False).view(np.uint8).reshape(G, 8, 8)
    # only the first ceil(max nn / 2) bytes of each value can be consulted
    # below — build that many nibble columns, not all 16
    maxnn = int(nn.max())
    nbytes_v = (maxnn + 1) >> 1
    nib = np.empty((G, 8, 2 * nbytes_v), dtype=np.uint8)
    nib[:, :, 0::2] = b8[:, :, :nbytes_v] & 0xF
    nib[:, :, 1::2] = b8[:, :, :nbytes_v] >> 4
    # group payload nibble q = nibble q%nn of the (q//nn)-th NONZERO value
    # (nn is uniform within a group) — two LUT gathers replace per-nibble
    # index arithmetic, and per-group rows assemble in one shot
    Q = int(tn.max())
    if Q:
        Qe = Q + (Q & 1)
        grow = np.arange(G, dtype=np.intp)[:, None]
        qcols = np.arange(Q, dtype=np.int32)
        k = _QDIV[nn[:, None], qcols[None, :]]          # [G, Q] value rank
        jn = _QMOD[nn[:, None], qcols[None, :]]         # [G, Q] nibble no.
        vi = _KTH8[bitmask[:, None], k]                 # [G, Q] value slot
        paynib = np.zeros((G, Qe), dtype=np.uint8)
        # q >= tn[g] gathers a neighbor's nibble — zero it so an odd tail
        # byte's high nibble matches the reference's zero fill
        np.multiply(nib[grow, vi, jn], qcols[None, :] < tn[:, None],
                    out=paynib[:, :Q])
        paybytes = paynib[:, 0::2] | (paynib[:, 1::2] << 4)
    else:
        paybytes = np.zeros((G, 0), dtype=np.uint8)
    # row-major boolean compaction of [bitmask | header | payload...]
    # yields the final byte stream directly — no scatter, no repeat
    mat = np.zeros((G, 2 + paybytes.shape[1]), dtype=np.uint8)
    mat[:, 0] = bitmask
    mat[:, 1] = np.where(has, (trailing & 0xF) | ((nn - 1) << 4), 0)
    mat[:, 2:] = paybytes
    keep = np.arange(mat.shape[1], dtype=np.int32)[None, :] < gsize[:, None]
    out = mat[keep]
    return out.tobytes()


def unpack(data: bytes, count: int) -> np.ndarray:
    """Unpack `count` uint64 values from NibblePack bytes."""
    lib = _native.lib
    if lib is not None:
        return lib.nibble_unpack(data, count)
    if count < _VEC_MIN_VALUES:
        return _unpack_py(data, count)
    return _unpack_vec(data, count)


def _unpack_vec(data: bytes, count: int) -> np.ndarray:
    """Vectorized NumPy unpack.  The only sequential dependency in the
    format is the group-boundary chain (each group's size is read from its
    own first two bytes); it is resolved with pointer doubling — log2(G)
    vectorized gathers over a per-position "size if a group started here"
    table — after which extraction is pure array math.  Truncated input is
    a ValueError, exactly like the Python and C implementations."""
    if count == 0:
        return np.zeros(0, dtype=np.uint64)
    buf = np.frombuffer(data, dtype=np.uint8)
    L = len(buf)
    if L == 0:
        raise ValueError("nibble_unpack: truncated input")
    G = (count + 7) // 8
    if not buf[:G].any():
        # all-zero bitmasks (the constant-slope timestamp shape: every
        # delta-delta group empty) — G one-byte groups, nothing to decode
        if L < G:
            raise ValueError("nibble_unpack: truncated input")
        return np.zeros(count, dtype=np.uint64)
    # per-position group size, assuming a group starts at that byte —
    # all-uint8 in-place arithmetic (tn <= 128 fits), one int32 pass at
    # the end; sizes are data, so this is the only full-buffer stage
    size_at = np.empty(L, dtype=np.uint8)
    np.right_shift(buf[1:], 4, out=size_at[:L - 1])
    size_at[L - 1] = 0
    size_at += 1
    size_at *= _POPCNT8[buf]                       # total nibbles if nonzero
    size_at += 1
    size_at >>= 1                                  # ceil(nibbles / 2)
    size_at += 2
    np.place(size_at, buf == 0, 1)
    # next-group position from each byte, clamped to the L sentinel
    nxt = np.empty(L + 1, dtype=np.int32)
    np.add(np.arange(L, dtype=np.int32), size_at, out=nxt[:L])
    np.minimum(nxt[:L], L, out=nxt[:L])
    nxt[L] = L
    # group offsets: the one sequential dependency in the format.  Pointer
    # doubling resolves it with vectorized gathers; the jump table stops
    # doubling at 32 steps (each doubling costs a full-buffer gather) and
    # the tail splices 32 groups per shot — control flow touches Python
    # once per 256 values, every byte-level op stays vectorized.
    offsets = np.empty(G, dtype=np.int32)
    offsets[0] = 0
    have = 1
    stride = 1
    stride_cap = max(32, G >> 6)     # ~64 tail splices, whatever the size
    step = nxt                       # position after `stride` steps
    while have < G:
        take = min(stride, G - have)
        offsets[have:have + take] = \
            step[offsets[have - stride:have - stride + take]]
        have += take
        if stride < stride_cap and stride <= have and have < G:
            step = step[step]
            stride *= 2
    if offsets[-1] >= L:             # a group's bitmask byte ran past the end
        raise ValueError("nibble_unpack: truncated input")
    bm = buf[offsets]
    has = bm != 0
    # nonzero groups need their header byte and full payload in-bounds
    if (has & (offsets + 1 >= L)).any():
        raise ValueError("nibble_unpack: truncated input")
    if (offsets + size_at[offsets] > L).any():
        raise ValueError("nibble_unpack: truncated input")

    hdr = np.where(has, buf[np.minimum(offsets + 1, L - 1)], 0)
    nn = (hdr >> 4).astype(np.int32) + 1               # [G]
    bits = ((bm[:, None] >> np.arange(8, dtype=np.uint8)) & 1)  # [G, 8]
    # rank*nn <= 7*16 fits uint8 — keep the per-value index math narrow
    rank = np.cumsum(bits, axis=1, dtype=np.uint8) - bits       # set bits below
    # Each value's nibbles occupy payload nibble range [rank*nn, rank*nn+nn)
    # — i.e. a window of at most 9 bytes starting at byte rank*nn >> 1.
    # Gather a fixed-width byte window per value and let a little-endian
    # integer VIEW fuse it; a half-nibble shift re-aligns odd starts.  The
    # window narrows to 2/4 bytes when the largest nn allows (delta-delta
    # payloads are 1-3 nibbles/value — 4x less gather traffic), and only
    # the 17-nibble case (nn=16, odd start) consults a 9th byte.
    # Everything past the [G, 8, W] gather runs at [G, 8] scale.
    maxnn = int(nn[has].max()) if has.any() else 1
    W, dt = ((2, "<u2") if maxnn <= 3 else
             (4, "<u4") if maxnn <= 7 else (8, "<u8"))
    bufp = np.zeros(L + 16, dtype=np.uint8)            # window overshoot pad
    bufp[:L] = buf
    pn = rank * nn[:, None].astype(np.uint8)           # payload nibble start
    bstart = (offsets + 2)[:, None] + (pn >> 1)        # [G, 8]
    if W == 2:
        # two [G, 8] gathers beat building a [G, 8, 2] index tensor
        lo = (bufp[bstart].astype(np.uint16)
              | (bufp[bstart + 1].astype(np.uint16) << 8))
    else:
        win = bufp[bstart[:, :, None] + np.arange(W, dtype=np.int32)]
        lo = win.reshape(G * 8, W).view(dt).reshape(G, 8)
    odd = (pn & 1).astype(lo.dtype)
    vals = lo >> (odd << 2)                            # drop odd-start nibble
    if W < 8:                                          # 4*nn < window bits
        mask4 = np.left_shift(np.int64(1), 4 * nn) - 1
        vals = (vals & mask4.astype(lo.dtype)[:, None]).astype(np.uint64)
    else:
        vals = vals.astype(np.uint64, copy=False)
        if maxnn == 16:                # 17-nibble span: top nibble from b9
            b9 = bufp[bstart + 8].astype(np.uint64)
            vals |= np.where((pn & 1) == 1,
                             (b9 & np.uint64(0xF)) << np.uint64(60),
                             np.uint64(0))
        nibmask = _M64 >> (np.uint64(64)
                           - nn.astype(np.uint64) * np.uint64(4))
        vals &= nibmask[:, None]
    trail4 = (hdr & 0xF).astype(np.uint64)
    if trail4.any():                 # skip the pass when no group shifts
        vals <<= trail4[:, None] * np.uint64(4)
    vals[bits == 0] = 0              # zero-slot scatter, not a full mask pass
    flat = vals.reshape(-1)
    return flat if len(flat) == count else flat[:count].copy()


def _unpack_py(data: bytes, count: int) -> np.ndarray:
    out = np.zeros(count, dtype=np.uint64)
    idx = 0
    pos = 0
    while idx < count:
        # truncated input is a ValueError, never a silent zero-pad (as in
        # the reference's C codec: divergent decodes would corrupt results)
        if pos >= len(data):
            raise ValueError("nibble_unpack: truncated input")
        bitmask = data[pos]
        pos += 1
        if bitmask == 0:
            idx += 8
            continue
        if pos >= len(data):
            raise ValueError("nibble_unpack: truncated input")
        hdr = data[pos]
        pos += 1
        trailing = hdr & 0xF
        num_nibbles = (hdr >> 4) + 1
        nonzero = bin(bitmask).count("1")
        total_nibbles = num_nibbles * nonzero
        nbytes = (total_nibbles + 1) // 2
        if pos + nbytes > len(data):
            raise ValueError("nibble_unpack: truncated input")
        acc = int.from_bytes(data[pos:pos + nbytes], "little")
        pos += nbytes
        mask_bits = (1 << (num_nibbles * 4)) - 1
        acc_shift = 0
        for i in range(8):
            if bitmask & (1 << i):
                v = ((acc >> acc_shift) & mask_bits) << (trailing * 4)
                acc_shift += num_nibbles * 4
                if idx + i < count:
                    out[idx + i] = v & _M64
        idx += 8
    return out


def zigzag_encode(values: np.ndarray) -> np.ndarray:
    """int64 -> uint64 zigzag (small magnitudes -> small codes)."""
    v = np.asarray(values, dtype=np.int64)
    return ((v << np.int64(1)) ^ (v >> np.int64(63))).astype(np.uint64)


def zigzag_decode(codes: np.ndarray) -> np.ndarray:
    u = np.asarray(codes, dtype=np.uint64)
    return ((u >> np.uint64(1)).astype(np.int64)
            ^ -(u & np.uint64(1)).astype(np.int64))


def pack_i64(values: np.ndarray) -> bytes:
    return pack(zigzag_encode(values))


def unpack_i64(data: bytes, count: int) -> np.ndarray:
    return zigzag_decode(unpack(data, count))


def pack_f64_xor(values: np.ndarray) -> bytes:
    """Gorilla-style XOR-predictor + NibblePack for doubles (ref:
    doc/compression.md:25-31; the reference stores doubles raw or as
    delta-delta longs, XOR+NibblePack gives strictly better wire size)."""
    bits = np.asarray(values, dtype=np.float64).view(np.uint64)
    prev = np.concatenate([[np.uint64(0)], bits[:-1]])
    return pack(bits ^ prev)


def unpack_f64_xor(data: bytes, count: int) -> np.ndarray:
    xored = unpack(data, count)
    bits = np.bitwise_xor.accumulate(xored)
    return bits.view(np.float64)


def delta_delta_encode(ts: np.ndarray) -> Tuple[int, int, np.ndarray]:
    """Timestamp compression: sloped line + per-sample deviations (ref:
    memory/.../format/vectors/DeltaDeltaVector.scala:28 'delta-delta').

    Returns (base, slope, deltas) where ts[i] == base + slope*i + deltas[i].
    A constant-interval series yields all-zero deltas (the const-slope case
    that occupies ~0 bytes/sample after NibblePack).
    """
    t = np.asarray(ts, dtype=np.int64)
    n = len(t)
    base = int(t[0]) if n else 0
    slope = int(round((int(t[-1]) - base) / (n - 1))) if n > 1 else 0
    line = base + slope * np.arange(n, dtype=np.int64)
    return base, slope, (t - line)


def delta_delta_decode(base: int, slope: int, deltas: np.ndarray) -> np.ndarray:
    n = len(deltas)
    return (base + slope * np.arange(n, dtype=np.int64)
            + np.asarray(deltas, dtype=np.int64))


def pack_timestamps(ts: np.ndarray) -> Tuple[int, int, bytes]:
    base, slope, deltas = delta_delta_encode(ts)
    return base, slope, pack_i64(deltas)


def unpack_timestamps(base: int, slope: int, data: bytes, count: int) -> np.ndarray:
    return delta_delta_decode(base, slope, unpack_i64(data, count))
