"""Instant (scalar) functions and binary operators, elementwise over
periodic sample matrices [S, W] (port of filodb_tpu/ops/instant.py).

The reference applies these op by op, not compiled as one program, so a
division by a constant here is a true division, as there.  NaN means
absent and propagates.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

_SECONDS_PER_DAY = 86400.0


def _days_in_month(y, m):
    thirty_one = ((m == 1) | (m == 3) | (m == 5) | (m == 7) | (m == 8)
                  | (m == 10) | (m == 12))
    thirty = (m == 4) | (m == 6) | (m == 9) | (m == 11)
    leap = ((torch.remainder(y, 4) == 0) & (torch.remainder(y, 100) != 0)) \
        | (torch.remainder(y, 400) == 0)
    feb = torch.where(leap, 29.0, 28.0).to(y.dtype)
    return torch.where(thirty_one, 31.0,
                       torch.where(thirty, 30.0, feb).to(y.dtype)).to(y.dtype)


def _civil_from_epoch_days(days):
    """Gregorian (y, m, d) from days since 1970-01-01 (Howard Hinnant's
    civil_from_days algorithm, branchless)."""
    z = days + 719468.0
    era = torch.floor(z / 146097.0)
    doe = z - era * 146097.0
    yoe = torch.floor((doe - torch.floor(doe / 1460.0)
                       + torch.floor(doe / 36524.0)
                       - torch.floor(doe / 146096.0)) / 365.0)
    y = yoe + era * 400.0
    doy = doe - (365.0 * yoe + torch.floor(yoe / 4.0)
                 - torch.floor(yoe / 100.0))
    mp = torch.floor((5.0 * doy + 2.0) / 153.0)
    d = doy - torch.floor((153.0 * mp + 2.0) / 5.0) + 1.0
    m = mp + torch.where(mp < 10.0, 3.0, -9.0).to(mp.dtype)
    y = y + (m <= 2.0).to(y.dtype)
    return y, m, d


def _epoch_parts(v):
    return _civil_from_epoch_days(torch.floor(v / _SECONDS_PER_DAY))


def _day_of_year(v):
    """1..365/366: days since Jan 1 of the value's year, from the same
    civil-date math as the other date parts."""
    y, _, _ = _epoch_parts(v)
    ys = y - 1.0                           # era math with March-year m=11
    era = torch.floor(ys / 400.0)
    yoe = ys - era * 400.0
    # civil Jan 1 of year y is 306 days after March 1 of year y-1
    doe = yoe * 365.0 + torch.floor(yoe / 4.0) - torch.floor(yoe / 100.0) \
        + 306.0
    jan1_days = era * 146097.0 + doe - 719468.0
    return torch.floor(v / _SECONDS_PER_DAY) - jan1_days + 1.0


def _sign(v):
    # torch.sign(NaN) is 0; absent must stay absent
    return torch.where(torch.isnan(v), v, torch.sign(v))


INSTANT_FUNCTIONS: Dict[str, Callable] = {
    "abs": torch.abs,
    "ceil": torch.ceil,
    "floor": torch.floor,
    "exp": torch.exp,
    "ln": torch.log,
    "log2": torch.log2,
    "log10": torch.log10,
    "sqrt": torch.sqrt,
    "round": lambda v, to_nearest=1.0: torch.floor(v / to_nearest + 0.5)
    * to_nearest,
    "clamp_min": torch.maximum,
    "clamp_max": torch.minimum,
    "clamp": lambda v, lo, hi: torch.minimum(torch.maximum(v, lo), hi),
    "sgn": _sign,
    "deg": torch.rad2deg,
    "rad": torch.deg2rad,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "asinh": torch.asinh, "acosh": torch.acosh, "atanh": torch.atanh,
    # date parts read the sample VALUE as epoch seconds (PromQL semantics)
    "minute": lambda v: torch.remainder(torch.floor(v / 60.0), 60.0),
    "hour": lambda v: torch.remainder(torch.floor(v / 3600.0), 24.0),
    "day_of_week": lambda v: torch.remainder(
        torch.floor(v / _SECONDS_PER_DAY) + 4.0, 7.0),
    "day_of_month": lambda v: _epoch_parts(v)[2],
    "month": lambda v: _epoch_parts(v)[1],
    "year": lambda v: _epoch_parts(v)[0],
    "days_in_month": lambda v: _days_in_month(*_epoch_parts(v)[:2]),
    "day_of_year": _day_of_year,
}


def apply_instant_function(name: str, vals: torch.Tensor, *params
                           ) -> torch.Tensor:
    return INSTANT_FUNCTIONS[name](vals, *params)


# ---------------------------------------------------------- binary operators

ARITH_OPERATORS: Dict[str, Callable] = {
    "+": torch.add,
    "-": torch.sub,
    "*": torch.mul,
    "/": torch.div,     # IEEE: x/0 = inf, 0/0 = nan, as PromQL
    "%": torch.fmod,    # Go math.Mod: the sign of the dividend
    "^": torch.pow,
    "atan2": torch.atan2,
}

COMPARISON_OPERATORS: Dict[str, Callable] = {
    "==": torch.eq,
    "!=": torch.ne,
    ">": torch.gt,
    "<": torch.lt,
    ">=": torch.ge,
    "<=": torch.le,
}


def apply_binary_op(lhs: torch.Tensor, rhs: torch.Tensor, *, op: str,
                    bool_modifier: bool = False,
                    keep_side: str = "lhs") -> torch.Tensor:
    """Vector op vector/scalar.  A comparison without `bool` filters: it
    keeps the `keep_side` value where true and NaN where false; with
    `bool` it gives 1/0."""
    absent = torch.isnan(lhs) | torch.isnan(rhs)
    nan = torch.full((), float("nan"), dtype=lhs.dtype, device=lhs.device)
    if op in ARITH_OPERATORS:
        return torch.where(absent, nan, ARITH_OPERATORS[op](lhs, rhs))
    cmp = COMPARISON_OPERATORS[op](lhs, rhs)
    if bool_modifier:
        return torch.where(absent, nan, cmp.to(lhs.dtype))
    kept = lhs if keep_side == "lhs" else rhs
    return torch.where(~absent & cmp, kept, nan)
