"""The program's own spans over the traced slice, for the readers of
`program_span` metrics: the registry of thermal3d_torch.core.profiling, which
the port writes only while a profiler records (in a run, exactly the traced
slice).

A run without a traced slice, a program without the registry, and spans whose
distinct request ids are not the slice's requests give None: the metric is
left out of the line.
"""

from __future__ import annotations

from typing import Optional, Sequence


def per_request(run, names: Sequence[str], key: str) -> Optional[float]:
    """The sum over the spans named `names` of their totals' `key` ("host_ms",
    "self_ms" or "device_ms"), a request of the traced slice; None where a
    name has no span or no such total."""
    from thermal3d_torch.core import profiling

    if run.trace is None:
        return None
    totals = getattr(profiling, "totals", None)
    request_ids = getattr(profiling, "request_ids", None)
    if totals is None or request_ids is None or len(request_ids()) != run.trace.requests:
        return None
    by_name = totals()
    values = [by_name[n][key] for n in names if n in by_name]
    if len(values) != len(names) or None in values:
        return None
    return sum(values) / run.trace.requests
