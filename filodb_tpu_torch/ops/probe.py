"""The column-selection probe's three strategies (K8, the port of
tools/probe_slice.py's Pallas bodies) and their plain versions.

probe_gather selects W columns of x into the first W of WP output
columns, probe_two_gathers takes the difference of two such selections,
and probe_onehot_matmul is the product with a one-hot selection matrix.
A CPU tensor takes the plain version; a CUDA tensor launches the kernel
in csrc/probe_select.cu or raises.
"""
from __future__ import annotations

import torch


def _padded(sel: torch.Tensor, WP: int) -> torch.Tensor:
    out = torch.zeros((sel.shape[0], WP), dtype=sel.dtype, device=sel.device)
    out[:, :sel.shape[1]] = sel
    return out


def probe_gather_plain(x, idx1, W: int, WP: int) -> torch.Tensor:
    """x[:, idx1[:W]] padded with zero columns to WP."""
    return _padded(x[:, idx1[:W].long()], WP)


def probe_two_gathers_plain(x, idx1, idx2, W: int, WP: int) -> torch.Tensor:
    """x[:, idx2[:W]] - x[:, idx1[:W]] padded with zero columns to WP."""
    return _padded(x[:, idx2[:W].long()] - x[:, idx1[:W].long()], WP)


def probe_onehot_matmul_plain(x, onehot) -> torch.Tensor:
    """x @ onehot in FP32, TF32 off."""
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return x @ onehot
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


def probe_gather(x, idx1, W: int, WP: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return probe_gather_plain(x, idx1, W, WP)
    from filodb_tpu_torch.ops import kernels
    return kernels.probe_gather_cuda(x, idx1, W, WP)


def probe_two_gathers(x, idx1, idx2, W: int, WP: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return probe_two_gathers_plain(x, idx1, idx2, W, WP)
    from filodb_tpu_torch.ops import kernels
    return kernels.probe_two_gathers_cuda(x, idx1, idx2, W, WP)


def probe_onehot_matmul(x, onehot) -> torch.Tensor:
    if x.device.type == "cpu":
        return probe_onehot_matmul_plain(x, onehot)
    from filodb_tpu_torch.ops import kernels
    return kernels.probe_onehot_matmul_cuda(x, onehot)
