"""Minimal 5-field cron schedule parser.

The reference's scheduledjob controller parses ``spec.schedule`` with
robfig/cron (pkg/controller/scheduledjob/utils.go:130 ``cron.Parse`` —
it prepends a seconds field; scheduling granularity is still the
minute).  This is the standard 5-field grammar at minute granularity:

    minute hour day-of-month month day-of-week

Each field: ``*``, ``*/step``, ``a``, ``a-b``, ``a-b/step``, and
comma-separated lists thereof.  Day-of-week 0 and 7 are both Sunday.
As in cron, when BOTH day-of-month and day-of-week are restricted the
match is the union of the two (crontab(5)).
"""

from __future__ import annotations

from dataclasses import dataclass
from datetime import datetime, timedelta

_BOUNDS = ((0, 59), (0, 23), (1, 31), (1, 12), (0, 7))


def _parse_field(text: str, lo: int, hi: int) -> frozenset[int]:
    out: set[int] = set()
    for part in text.split(","):
        part = part.strip()
        if not part:
            raise ValueError("empty cron field element")
        step = 1
        if "/" in part:
            part, _, step_s = part.partition("/")
            step = int(step_s)
            if step < 1:
                raise ValueError(f"invalid cron step {step}")
        if part == "*":
            a, b = lo, hi
        elif "-" in part:
            a_s, _, b_s = part.partition("-")
            a, b = int(a_s), int(b_s)
        else:
            a = b = int(part)
        if not (lo <= a <= hi and lo <= b <= hi and a <= b):
            raise ValueError(f"cron field value out of range: {part!r}")
        out.update(range(a, b + 1, step))
    return frozenset(out)


@dataclass(frozen=True)
class Schedule:
    minutes: frozenset[int]
    hours: frozenset[int]
    dom: frozenset[int]
    months: frozenset[int]
    dow: frozenset[int]
    dom_star: bool  # field was '*' (crontab(5) dom/dow union rule)
    dow_star: bool

    def _day_matches(self, d: datetime) -> bool:
        # Python weekday(): Monday=0; cron: Sunday=0 (and 7).
        cron_dow = (d.weekday() + 1) % 7
        dom_ok = d.day in self.dom
        dow_ok = cron_dow in self.dow or (cron_dow == 0 and 7 in self.dow)
        if self.dom_star and self.dow_star:
            return True
        if self.dom_star:
            return dow_ok
        if self.dow_star:
            return dom_ok
        return dom_ok or dow_ok  # both restricted: union (crontab(5))

    def next(self, after: datetime) -> datetime:
        """The first schedule time strictly AFTER ``after`` (robfig
        cron's Next contract, utils.go getRecentUnmetScheduleTimes walks
        it)."""
        t = after.replace(second=0, microsecond=0) + timedelta(minutes=1)
        # Bounded walk: 4 years covers any 5-field schedule incl. a
        # Feb-29 dom.
        end = t + timedelta(days=4 * 366)
        while t < end:
            if t.month not in self.months:
                # jump to the 1st of the next month
                y, m = t.year + (t.month == 12), t.month % 12 + 1
                t = t.replace(year=y, month=m, day=1, hour=0, minute=0)
                continue
            if not self._day_matches(t):
                t = (t + timedelta(days=1)).replace(hour=0, minute=0)
                continue
            if t.hour not in self.hours:
                t = (t + timedelta(hours=1)).replace(minute=0)
                continue
            if t.minute not in self.minutes:
                t += timedelta(minutes=1)
                continue
            return t
        raise ValueError("schedule never fires")


def parse(schedule: str) -> Schedule:
    fields = schedule.split()
    if len(fields) != 5:
        raise ValueError(
            f"cron schedule needs 5 fields, got {len(fields)}: "
            f"{schedule!r}")
    sets = [_parse_field(f, lo, hi)
            for f, (lo, hi) in zip(fields, _BOUNDS)]
    return Schedule(minutes=sets[0], hours=sets[1], dom=sets[2],
                    months=sets[3], dow=sets[4],
                    dom_star=fields[2] == "*", dow_star=fields[4] == "*")

