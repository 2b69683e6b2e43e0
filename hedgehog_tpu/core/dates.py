"""Time & day-count substrate: int64 millisecond "ticks" + ACT/365 year fractions.

Parity target: reference src/date_functions.jl.  The reference measures all
maturities as milliseconds since the proleptic-Gregorian epoch 0000-01-01T00:00
(Julia Dates epoch) and converts to ACT/365 year fractions for all math
(src/date_functions.jl:1-3, :54-58, :87-89).  We keep the identical epoch and
constants so golden values and tick-based theta conventions carry over exactly.

Precision note: tick magnitudes (~6.4e13 for modern dates) overflow float32, so ticks
stay int64/float64 at the API boundary; kernels only ever see year fractions.
``yearfrac``/``add_yearfrac`` are jnp-traceable (AD-compatible — theta is
defined as a derivative against expiry *in ticks*, reference
src/greeks/greeks_problem.jl:472-475).
"""

from __future__ import annotations

import datetime as _dt
from typing import Union

__all__ = [
    "SECONDS_IN_YEAR_365",
    "MILLISECONDS_IN_YEAR_365",
    "MILLISECONDS_IN_DAY",
    "to_ticks",
    "yearfrac",
    "add_yearfrac",
    "ticks_to_datetime",
    "DayCount",
    "Act365Fixed",
    "Act360",
    "Act36525",
    "Thirty360E",
    "ActActISDA",
    "ACT365F",
]

SECONDS_IN_YEAR_365 = 365 * 86400
MILLISECONDS_IN_YEAR_365 = SECONDS_IN_YEAR_365 * 1000
MILLISECONDS_IN_DAY = 86400_000

# Python's date.toordinal() counts days with 0001-01-01 == 1; the Julia Dates
# epoch is 0000-01-01 and year 0 is a leap year (366 days), so the offset
# between the two conventions is a constant 365 days.
_ORDINAL_OFFSET_DAYS = 365

DateLike = Union[int, float, _dt.date, _dt.datetime]


def to_ticks(x: DateLike):
    """Convert a date/datetime/numeric timestamp to ms-since-0000-01-01 ticks.

    Numbers pass through unchanged (already ticks) — mirrors the reference's
    normalization of mixed inputs (src/date_functions.jl:15-41).  Traced JAX
    values pass through as-is.
    """
    if isinstance(x, _dt.datetime):
        days = x.toordinal() + _ORDINAL_OFFSET_DAYS
        ms = (
            days * MILLISECONDS_IN_DAY
            + x.hour * 3_600_000
            + x.minute * 60_000
            + x.second * 1000
            + x.microsecond // 1000
        )
        return ms
    if isinstance(x, _dt.date):
        return (x.toordinal() + _ORDINAL_OFFSET_DAYS) * MILLISECONDS_IN_DAY
    return x  # numeric or traced: already ticks


# ---- day-count conventions (beyond-reference: src/date_functions.jl is
# ACT/365-fixed only) --------------------------------------------------------
#
# Two tiers, reflecting what a jitted program can trace:
# - LINEAR conventions (ACT/365F, ACT/360, ACT/365.25) are a constant scale
#   on tick differences — fully jit/vmap/grad-compatible (theta-in-ticks is a
#   well-defined constant slope, matching greeks_problem.jl:472-475).
# - CALENDAR conventions (30E/360, ACT/ACT ISDA) are staircase functions of
#   calendar dates; they evaluate at the concrete-date boundary and raise a
#   clear TypeError under tracing (there is no meaningful tick-derivative).
#
# Instances are empty frozen dataclasses: hashable and ==-comparable, so they
# work as static pytree fields / jit static args.

import dataclasses as _dc


class DayCount:
    """Base day-count convention; subclasses define ``yearfrac(start, stop)``
    on ticks/dates.  ``ms_per_year`` is set for linear conventions (None for
    calendar ones)."""

    ms_per_year: Union[float, None] = None

    def yearfrac(self, start: DateLike, stop: DateLike):
        raise NotImplementedError


class _LinearDayCount(DayCount):
    def yearfrac(self, start: DateLike, stop: DateLike):
        return (to_ticks(stop) - to_ticks(start)) / self.ms_per_year


@_dc.dataclass(frozen=True)
class Act365Fixed(_LinearDayCount):
    """ACT/365 Fixed — the reference's (and this library's) default."""

    ms_per_year = float(MILLISECONDS_IN_YEAR_365)


@_dc.dataclass(frozen=True)
class Act360(_LinearDayCount):
    """ACT/360 (money-market basis)."""

    ms_per_year = 360 * 86400 * 1000.0


@_dc.dataclass(frozen=True)
class Act36525(_LinearDayCount):
    """ACT/365.25 (average-year basis)."""

    ms_per_year = 365.25 * 86400 * 1000.0


def _as_date(x: DateLike, what: str) -> _dt.date:
    if isinstance(x, (_dt.date, _dt.datetime)):
        return x.date() if isinstance(x, _dt.datetime) else x
    try:
        return ticks_to_datetime(x).date()
    except Exception as exc:  # traced tick values cannot become dates
        raise TypeError(
            f"calendar day-count conventions need concrete dates/ticks for "
            f"{what} (got {type(x).__name__}); use a linear convention "
            f"(Act365Fixed/Act360/Act36525) inside jit, or convert dates to "
            f"year fractions at the boundary"
        ) from exc


@_dc.dataclass(frozen=True)
class Thirty360E(DayCount):
    """30E/360 (Eurobond basis): each month counts 30 days, with day-of-month
    clamped to 30 on both ends."""

    def yearfrac(self, start: DateLike, stop: DateLike):
        d1 = _as_date(start, "30E/360")
        d2 = _as_date(stop, "30E/360")
        a = min(d1.day, 30)
        b = min(d2.day, 30)
        return (360 * (d2.year - d1.year) + 30 * (d2.month - d1.month)
                + (b - a)) / 360.0


@_dc.dataclass(frozen=True)
class ActActISDA(DayCount):
    """ACT/ACT ISDA: actual days in each calendar year divided by that year's
    actual length (365 or 366), summed over the years the period spans."""

    def yearfrac(self, start: DateLike, stop: DateLike):
        d1 = _as_date(start, "ACT/ACT ISDA")
        d2 = _as_date(stop, "ACT/ACT ISDA")
        if d2 < d1:
            return -self.yearfrac(d2, d1)
        total = 0.0
        for y in range(d1.year, d2.year + 1):
            y_start = max(d1, _dt.date(y, 1, 1))
            y_end = min(d2, _dt.date(y + 1, 1, 1))
            days_in_year = (_dt.date(y + 1, 1, 1) - _dt.date(y, 1, 1)).days
            total += (y_end - y_start).days / days_in_year
        return total


#: the default convention (module-level singleton)
ACT365F = Act365Fixed()


def yearfrac(start: DateLike, stop: DateLike, daycount: DayCount = None):
    """Year fraction between two time points (dates or ticks) under a
    day-count convention (default ACT/365 Fixed, the reference's only
    convention)."""
    if daycount is None or isinstance(daycount, Act365Fixed):
        return (to_ticks(stop) - to_ticks(start)) / MILLISECONDS_IN_YEAR_365
    return daycount.yearfrac(start, stop)


def add_yearfrac(t: DateLike, yf):
    """Add an ACT/365 year fraction to a timestamp; returns float ticks.

    AD-compatible (pure arithmetic), matching src/date_functions.jl:87-89.
    """
    return to_ticks(t) + yf * MILLISECONDS_IN_YEAR_365


def ticks_to_datetime(ticks: Union[int, float]) -> _dt.datetime:
    """Inverse of :func:`to_ticks` for concrete (non-traced) values."""
    ticks = int(ticks)
    days, ms = divmod(ticks, MILLISECONDS_IN_DAY)
    base = _dt.datetime.fromordinal(days - _ORDINAL_OFFSET_DAYS)
    return base + _dt.timedelta(milliseconds=ms)
