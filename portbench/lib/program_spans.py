"""The program's own spans, and the reductions over them that the readers
share.

The port (`ipercore_tpu_torch.utils.logging`) records its spans while
`torch.profiler` records, so a traced run's window holds them. A program
without that facility gives none, and the readers that need it return None.

A program span is a `Span` (name, start_ns, end_ns, id, parent, request,
thread, attrs); a benchmark span is (name, start_ns, end_ns). Both are on the
profiler's clock (`time.time_ns`). Spans nest: the innermost span open at a
moment is the one that began last among those holding it, on whichever
thread, so a kernel launched by the autograd engine's thread while the main
thread sits in a backward span falls under that span.
"""
from __future__ import annotations

import bisect

from portbench.lib.trace import union_intervals

_taken: dict = {"run": None, "spans": None}


def _take(run) -> None:
    """Empty the program's store once for `run`: the readers of one run
    share what it held."""
    if _taken["run"] is run:
        return
    from ipercore_tpu_torch.utils import logging as plog

    take = getattr(plog, "take_spans", None)
    _taken.update(run=run, spans=take() if take else None)


def spans_of(run) -> list | None:
    """The program's spans recorded in the run's traced window, or None when
    the program records none."""
    _take(run)
    return _taken["spans"] or None


def named(spans, name: str) -> list:
    return [s for s in spans if s[0] == name]


def mean_ms(spans, name: str) -> float | None:
    """Mean host milliseconds of the spans called `name`."""
    picked = named(spans, name)
    if not picked:
        return None
    return sum(s[2] - s[1] for s in picked) / len(picked) / 1e6


class Nesting:
    """The spans (program and benchmark alike) ordered by start, for asking
    which one is innermost at a moment."""

    def __init__(self, spans):
        self.spans = sorted(((s[1], s[2], s[0]) for s in spans), key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]

    def innermost(self, t: int, outside: str = "host") -> str:
        """The name of the span that began last among those holding t."""
        for j in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            if t < self.spans[j][1]:
                return self.spans[j][2]
        return outside


def idle_by_span(kernels, spans) -> dict:
    """The device's idle seconds between kernels, by the innermost span open
    when each gap began (`host` outside every span)."""
    nest = Nesting(spans)
    merged = union_intervals(kernels)
    out: dict = {}
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        label = nest.innermost(e0)
        out[label] = out.get(label, 0.0) + (s1 - e0) / 1e9
    return out


def launched_under(kernels, launches: dict, spans) -> list:
    """For each kernel (name, start_ns, end_ns, key), the innermost span open
    when it was launched: `launches` maps a kernel's key to its launch's host
    time; `unattributed` where the launch was not recorded."""
    nest = Nesting(spans)
    return [nest.innermost(launches[k[3]]) if k[3] in launches else "unattributed" for k in kernels]


def device_by_span(kernels, launches: dict, spans) -> dict:
    """Device seconds of the kernels by the span that launched them
    (`launched_under`)."""
    out: dict = {}
    for (_, s, e, _), label in zip(kernels, launched_under(kernels, launches, spans)):
        out[label] = out.get(label, 0.0) + (e - s) / 1e9
    return out
