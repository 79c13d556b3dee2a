"""The trace's reductions: on one device exactly what they gave before they
took devices apart, on a kernel list recorded on the card; on several devices
each device's own timeline."""
import gzip
import json
import os

import pytest

from portbench.lib import trace as tr

RECORDED = os.path.join(os.path.dirname(__file__), "data", "imitate_trace.json.gz")


# The reductions as they were when every cell ran on one device, kept here
# word for word to hold the present ones to.
def one_device_union_intervals(kernels):
    out = []
    for _, s, e in sorted(kernels, key=lambda k: k[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def one_device_busy_seconds(kernels):
    return sum(e - s for s, e in one_device_union_intervals(kernels)) / 1e9


def one_device_idle_share(run):
    if not run.kernels or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - one_device_busy_seconds(run.kernels) / run.window_s)


def one_device_top_device_ops(kernels, n=10):
    by = {}
    for name, s, e in kernels:
        by[name] = by.get(name, 0.0) + (e - s) / 1e9
    return [[k[:160], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def one_device_idle_gaps(kernels, spans, n=10):
    by = {}
    merged = one_device_union_intervals(kernels)
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        label = "host"
        for name, a, b in spans:
            if a <= e0 < b:
                label = name
        by[label] = by.get(label, 0.0) + (s1 - e0) / 1e9
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def recorded():
    """The kernels (name, start_ns, end_ns, device) and benchmark spans of a
    traced run of `imitate.attlwb_spade_512` on the card, times from the
    first kernel's start."""
    with gzip.open(RECORDED, "rt") as f:
        d = json.load(f)
    kernels = [(d["names"][i], s, e, dev) for i, s, e, dev in d["kernels"]]
    return kernels, [tuple(s) for s in d["spans"]], d["window_s"]


def test_one_device_reads_exactly_as_before():
    kernels, spans, window_s = recorded()
    assert len(kernels) > 10000 and {k[3] for k in kernels} == {0}
    old = [k[:3] for k in kernels]
    old_run = tr.Run(cell="c", config={}, traffic={}, kernels=old, spans=spans, window_s=window_s)
    for ks in (kernels, old):  # records with and without their device
        run = tr.Run(cell="c", config={}, traffic={}, kernels=ks, spans=spans, window_s=window_s)
        assert tr.busy_seconds(ks) == one_device_busy_seconds(old)
        assert tr.idle_share(run) == one_device_idle_share(old_run)
        assert tr.idle_gaps(ks, spans) == one_device_idle_gaps(old, spans)
        assert tr.top_device_ops(ks) == one_device_top_device_ops(old)
        assert tr.union_intervals(ks) == one_device_union_intervals(old)
    assert 0 < tr.idle_share(run) < 10 and tr.idle_gaps(kernels, spans)


def test_two_devices_are_idle_on_their_own_timelines():
    # the cards take turns: together never idle, each idle half the window
    kernels = [("a", 0, 100, 0), ("b", 100, 200, 1), ("c", 200, 300, 0), ("d", 300, 400, 1)]
    run = tr.Run(cell="c", config={}, traffic={}, kernels=kernels, window_s=400e-9, devices=2)
    assert one_device_idle_share(tr.Run(cell="c", config={}, traffic={}, kernels=[k[:3] for k in kernels],
                                        window_s=400e-9)) == pytest.approx(0.0)
    assert tr.busy_seconds(kernels) == pytest.approx(200e-9)
    assert tr.idle_share(run) == pytest.approx(50.0)
    # card 0's gap begins at 100 under `request`, card 1's at 200 under `fetch`
    spans = [("request", 0, 1000), ("fetch", 150, 260)]
    assert sorted(tr.idle_gaps(kernels, spans)) == [["fetch", pytest.approx(50e-9)],
                                                    ["request", pytest.approx(50e-9)]]
    # a card that ran nothing counts as never busy
    run4 = tr.Run(cell="c", config={}, traffic={}, kernels=kernels, window_s=400e-9, devices=4)
    assert tr.busy_seconds(kernels, 4) == pytest.approx(100e-9)
    assert tr.idle_share(run4) == pytest.approx(75.0)
    assert tr.top_device_ops(kernels)[0] == ["a", pytest.approx(100e-9)]
    assert tr.device_seconds(kernels) == pytest.approx(400e-9)
