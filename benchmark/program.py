"""What the program recorded of the run's traced window, for the readers of
the per-layer metrics it measures itself: its spans and their counts
(``homomorph_tpu_torch.utils.profiling.records``, the records of the
program's latest traced session).  Where the program recorded nothing, or
keeps no such records, the readers find nothing and return ``None``."""

from __future__ import annotations


def records() -> list:
    """The program's records, or ``[]`` where it keeps none."""
    from homomorph_tpu_torch.utils import profiling

    read = getattr(profiling, "records", None)
    return [] if read is None else list(read())


def per_request(name: str, value, recs: "list | None" = None) -> "float | None":
    """Mean over the requests that hold a ``name`` record with a value of
    the sum of ``value(record)`` over their ``name`` records (``None``: the
    record has no value); ``None`` where no request holds one.  The mean is
    over the requests the program recorded, however many the window had."""
    per: dict = {}
    for r in records() if recs is None else recs:
        if r.name != name:
            continue
        v = value(r)
        if v is not None:
            per[r.request] = per.get(r.request, 0.0) + v
    return sum(per.values()) / len(per) if per else None


def span_ms(record) -> "float | None":
    """A span's host time in ms."""
    s = getattr(record, "seconds", None)
    return None if s is None else s * 1e3
