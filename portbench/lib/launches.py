"""Device time by the program span that launched it.

`LaunchProfiler` is `trace.Profiler` that also keeps, for each kernel it
returns, the host time of its launch (kineto's earliest host event with the
kernel's correlation id; on the host, where the operators run where they are
called, the operator's own start), as `launch_ns`, aligned with the kernels.
A driver hands that list to its readers as the counter `launch_ns`.
"""
from __future__ import annotations

from portbench.lib import trace as tr
from portbench.lib.program_spans import Nesting, spans_of


class LaunchProfiler(tr.Profiler):
    def __init__(self, devices):
        super().__init__(devices)
        self.launch_ns: list = []

    def stop(self):
        kernels, t_stop = super().stop()
        events = self.prof.profiler.kineto_results.events()
        if not self.cuda:
            self.launch_ns = [k[1] for k in kernels]
            return kernels, t_stop
        launches, keys = {}, []
        for ev in events:
            key = ev.correlation_id()
            if ev.device_type() == self.kind:
                if ev.duration_ns() > 0:
                    keys.append(key)
            elif key > 0:
                launches[key] = min(launches.get(key, ev.start_ns()), ev.start_ns())
        self.launch_ns = [launches.get(key) for key in keys]
        return kernels, t_stop


def device_s_launched_under(run, names) -> float | None:
    """Device seconds of the run's kernels whose launch fell, innermost, in a
    program span named in `names`; None without program spans or launches."""
    spans = spans_of(run)
    launch_ns = run.counters.get("launch_ns")
    if not spans or not launch_ns:
        return None
    nest = Nesting(spans)
    return sum(k[2] - k[1] for k, t in zip(run.kernels, launch_ns)
               if t is not None and nest.innermost(t) in names) / 1e9
