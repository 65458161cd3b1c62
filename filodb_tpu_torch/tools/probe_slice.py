"""Column-selection probe on the card (port of tools/probe_slice.py).

The fused kernels' window-boundary selections are column selections at
slots f0 + w * stride.  This probe runs the three strategies of the
reference probe over x [GRID x BS, TP] f32 with W = 110 selections, each
a hand-written kernel (csrc/probe_select.cu, K8):

  tiled_gather  y[:, w] = x[:, f0 + stride * w]          (probe_gather)
  tiled_two     y[:, w] = x[:, i2[w]] - x[:, i1[w]]      (probe_two_gathers)
  matmul        y = x @ onehot                           (probe_onehot_matmul)

and prints one JSON line per strategy: the max abs error against the
plain version and the device ms per call, the slope of CUDA-event times
over K = 2 and K = 16 chained launches.

    python -m filodb_tpu_torch.tools.probe_slice [--grid N] [--device cpu]

It needs a CUDA card; --device cpu runs the plain versions instead, and
prints no times.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from filodb_tpu_torch.ops import probe
from filodb_tpu_torch.utils.device import resolve_device

BS, TP, WP = 256, 768, 128
F0, STRIDE, W = 5, 6, 110
GRID = 1024        # series blocks (262,144 rows)
KS = (2, 16)       # chained launches of the two timed runs


def inputs(grid: int, device, seed: int = 0):
    """(x, onehot, i1, i2) as the reference probe builds them: i1 holds
    the W selected slots, i2 the slots stride - 1 later."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((grid * BS, TP)).astype(np.float32)
    idx = np.zeros(TP, np.int32)
    idx[:W] = F0 + STRIDE * np.arange(W, dtype=np.int32)
    onehot = np.zeros((TP, WP), np.float32)
    onehot[idx[:W], np.arange(W)] = 1.0

    def put(a):
        return torch.from_numpy(a).to(device)
    return put(x), put(onehot), put(idx), put(idx + (STRIDE - 1))


# columns of adversarial_inputs' o that break the one-hot pattern
ADV_ZERO, ADV_PAIR, ADV_THREE, ADV_NAN, ADV_INF = 3, 7, 11, 13, 17


def adversarial_inputs(rows: int, device, seed: int = 0):
    """(x [rows, TP], o [TP, WP]) f32 for the product's exact rules.

    o is the probe's one-hot selection (column w takes slot F0 + STRIDE
    * w, columns W.. are zero) except: column ADV_ZERO is all zero,
    ADV_PAIR is +1 at its slot and -1 one slot later, ADV_THREE holds
    0.5, -2 and 4 at three slots whose x values are multiples of 2^-8 in
    [-16, 16) (so their sum is exact in any order), ADV_NAN adds a NaN
    beside its 1, and ADV_INF is +Inf at its slot.  x is standard normal
    with, by row r % 10: 0 -0.0 in every selected slot, 1 +Inf in column
    0's slot, 3 -Inf in a slot no column selects, 5 NaN in column 2's
    slot, 8 +Inf in column ADV_INF's slot.
    """
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, TP)).astype(np.float32)
    sel = F0 + STRIDE * np.arange(W)
    o = np.zeros((TP, WP), np.float32)
    o[sel, np.arange(W)] = 1.0
    o[:, ADV_ZERO] = 0.0
    o[sel[ADV_PAIR] + 1, ADV_PAIR] = -1.0
    three = sel[ADV_THREE] + np.array([-2, 0, 3])
    o[three, ADV_THREE] = (0.5, -2.0, 4.0)
    x[:, three] = rng.integers(-4096, 4096, size=(rows, 3)) / np.float32(256)
    o[sel[ADV_NAN] + 2, ADV_NAN] = np.nan
    o[sel[ADV_INF], ADV_INF] = np.inf
    r = np.arange(rows)
    x[np.ix_(r[r % 10 == 0], sel)] = -0.0
    x[r[r % 10 == 1], sel[0]] = np.inf
    x[r[r % 10 == 3], sel[5] + 1] = -np.inf
    x[r[r % 10 == 5], sel[2]] = np.nan
    x[r[r % 10 == 8], sel[ADV_INF]] = np.inf
    return (torch.from_numpy(x).to(device), torch.from_numpy(o).to(device))


STRATEGIES = {
    "tiled_gather": (lambda x, o, i1, i2: probe.probe_gather(x, i1, W, WP),
                     lambda x, o, i1, i2: probe.probe_gather_plain(
                         x, i1, W, WP)),
    "tiled_two": (lambda x, o, i1, i2: probe.probe_two_gathers(
        x, i1, i2, W, WP),
        lambda x, o, i1, i2: probe.probe_two_gathers_plain(
            x, i1, i2, W, WP)),
    "matmul": (lambda x, o, i1, i2: probe.probe_onehot_matmul(x, o),
               lambda x, o, i1, i2: probe.probe_onehot_matmul_plain(x, o)),
}


def device_ms_per_call(fn, reps: int = 7) -> float:
    """The slope of the median CUDA-event time over KS chained calls."""
    p50 = {}
    for k in KS:
        lat = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(k):
                fn()
            b.record()
            torch.cuda.synchronize()
            lat.append(a.elapsed_time(b))
        p50[k] = float(np.median(lat))
    return (p50[KS[1]] - p50[KS[0]]) / (KS[1] - KS[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=GRID)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    x, o, i1, i2 = inputs(args.grid, dev)
    for name, (kern, plain) in STRATEGIES.items():
        got = kern(x, o, i1, i2)
        want = plain(x, o, i1, i2)
        rec = {"strategy": name,
               "max_abs_err": float((got - want).abs().max())}
        if dev.type == "cuda":
            fn = (lambda kern=kern: kern(x, o, i1, i2))
            fn()
            torch.cuda.synchronize()
            rec["device_ms_per_call"] = device_ms_per_call(fn)
        print(json.dumps(rec))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
