"""Date-range input resolution for daily-partitioned data directories.

The port's own copy of `photon_ml_tpu/utils/date_range.py`.
Counterpart of photon-client util/DateRange.scala, util/DaysRange.scala and
IOUtils.scala:30-155 (resolveRange, getInputPathsWithinDateRange), plus the
driver hook GameDriver.pathsForDateRange:248-257. The reference's drivers
accept either

  * an absolute range "yyyyMMdd-yyyyMMdd" (DateRange.fromDateString), or
  * a relative range "<start days ago>-<end days ago>" (DaysRange, e.g.
    "90-1" = from 90 days ago through yesterday),

then expand every base input directory into its existing daily
subdirectories `<base>/yyyy/MM/dd` within the range.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import os
from typing import List, Optional, Sequence

_PATTERN = "%Y%m%d"  # DateRange.DEFAULT_PATTERN "yyyyMMdd"
_DELIMITER = "-"  # DateRange.DEFAULT_DELIMITER


@dataclasses.dataclass(frozen=True)
class DateRange:
    """Inclusive [start, end] calendar-day range (DateRange.scala:30-104)."""

    start: _dt.date
    end: _dt.date

    def __post_init__(self):
        if self.start > self.end:
            raise ValueError(
                f"Invalid range: start date {self.start} comes after end date {self.end}"
            )

    @classmethod
    def parse(cls, range_str: str) -> "DateRange":
        """DateRange.fromDateString: "yyyyMMdd-yyyyMMdd"."""
        start_s, end_s = _split_range(range_str)
        return cls(
            _dt.datetime.strptime(start_s, _PATTERN).date(),
            _dt.datetime.strptime(end_s, _PATTERN).date(),
        )

    def days(self) -> List[_dt.date]:
        n = (self.end - self.start).days
        return [self.start + _dt.timedelta(days=i) for i in range(n + 1)]

    def __str__(self) -> str:
        return (
            f"{self.start.strftime(_PATTERN)}{_DELIMITER}{self.end.strftime(_PATTERN)}"
        )


@dataclasses.dataclass(frozen=True)
class DaysRange:
    """Relative "<start days ago>-<end days ago>" range (DaysRange.scala:30-80)."""

    start_days_ago: int
    end_days_ago: int

    def __post_init__(self):
        if self.start_days_ago < self.end_days_ago:
            raise ValueError(
                f"Invalid range: start {self.start_days_ago} days ago must not "
                f"be more recent than end {self.end_days_ago} days ago"
            )
        if self.end_days_ago < 0:
            raise ValueError("days-ago values must be non-negative")

    @classmethod
    def parse(cls, range_str: str) -> "DaysRange":
        start_s, end_s = _split_range(range_str)
        return cls(int(start_s), int(end_s))

    def to_date_range(self, today: Optional[_dt.date] = None) -> DateRange:
        """DaysRange.toDateRange: anchor at the local calendar day."""
        today = today or _dt.date.today()
        return DateRange(
            today - _dt.timedelta(days=self.start_days_ago),
            today - _dt.timedelta(days=self.end_days_ago),
        )

    def __str__(self) -> str:
        return f"{self.start_days_ago}{_DELIMITER}{self.end_days_ago}"


def _split_range(range_str: str) -> tuple:
    parts = range_str.split(_DELIMITER)
    if len(parts) != 2:
        raise ValueError(
            f"Invalid range string '{range_str}': expected 'start{_DELIMITER}end'"
        )
    return parts[0].strip(), parts[1].strip()


def resolve_range(
    date_range: Optional[str],
    days_range: Optional[str],
    *,
    today: Optional[_dt.date] = None,
) -> Optional[DateRange]:
    """IOUtils.resolveRange: at most one of the two specs may be given."""
    if date_range and days_range:
        raise ValueError(
            "Both date range and days ago given. You must specify date ranges "
            "using only one format."
        )
    if date_range:
        return DateRange.parse(date_range)
    if days_range:
        return DaysRange.parse(days_range).to_date_range(today)
    return None


def paths_for_date_range(
    base_dirs: Sequence[str],
    date_range: Optional[DateRange],
    *,
    error_on_missing: bool = False,
) -> List[str]:
    """GameDriver.pathsForDateRange + IOUtils.getInputPathsWithinDateRange:
    expand each base dir into its existing `yyyy/MM/dd` daily subdirectories
    within the range; without a range the base dirs pass through unchanged.
    Raises when a base dir has NO daily directory in range (the reference's
    `require(existingPaths.nonEmpty)`), or on any missing day when
    `error_on_missing`."""
    if date_range is None:
        return list(base_dirs)
    out: List[str] = []
    for base in base_dirs:
        candidates = [
            os.path.join(base, day.strftime("%Y/%m/%d"))
            for day in date_range.days()
        ]
        if error_on_missing:
            missing = [p for p in candidates if not os.path.exists(p)]
            if missing:
                raise FileNotFoundError(f"Path {missing[0]} does not exist")
        existing = [p for p in candidates if os.path.exists(p)]
        if not existing:
            raise FileNotFoundError(
                f"No data folder found between {date_range.start} and "
                f"{date_range.end} in {base}"
            )
        out.extend(existing)
    return out
