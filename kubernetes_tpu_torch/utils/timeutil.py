"""RFC3339 timestamps — the one wire format every ObjectMeta timestamp
(creationTimestamp, lastScaleTime, lastScheduleTime) uses.

A copy of ``kubernetes_tpu/utils/timeutil.py``."""

from __future__ import annotations

from datetime import datetime, timezone

RFC3339 = "%Y-%m-%dT%H:%M:%SZ"


def parse_rfc3339(text: str) -> datetime:
    return datetime.strptime(text, RFC3339).replace(tzinfo=timezone.utc)


def format_rfc3339(t: datetime) -> str:
    return t.strftime(RFC3339)


def now_utc() -> datetime:
    return datetime.now(timezone.utc)
