"""The readers of the port's own spans (``portbench/spans.py`` and the
metrics that use it), each on a synthetic ``harness.Profile`` and records
put in the port's recorder: records outside the profiled stretch are
ignored, idle time merges overlapping device operations, and a trace or
a program with nothing to read gives None."""

from __future__ import annotations

import pytest

from minigrid_dynamicprogramming_tpu_torch.utils import profiling
from portbench import harness, spans

T0 = 1_800_000_000  # s on the shared clock
ROLLOUT = ["lanes.step.span_ms", "lanes.transition.span_ms", "lanes.select.span_ms",
           "lanes.observation.span_ms", "lanes.graph_nodes", "lanes.capture.idle_ms",
           "generator.generate.span_ms"]
DP = ["dp.extract.span_ms", "dp.masks.span_ms", "dp.kernel.span_ms", "dp.policy.span_ms"]


def ns(ms: float) -> int:
    return T0 * 10**9 + int(ms * 1e6)


def s(ms: float) -> float:
    return T0 + ms / 1e3


def rec(rid, name, parent, start_ms, end_ms, device_ms, count=1, request=1, **attrs):
    return profiling.Record(rid, name, parent, request, ns(start_ms), attrs, ns(end_ms), count,
                            device_ms)


@pytest.fixture
def recorder(monkeypatch):
    r = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", r)
    return r


def read(metric: str, trace: dict):
    return harness.load_module("metrics", metric).read(trace)


def profile(host_ms, device=()):
    """A profile whose host events span ``host_ms`` (start, end) and whose
    device operations are (start ms, end ms) pairs."""
    lo, hi = host_ms
    return harness.Profile(
        device=[("k", s(a), (b - a) / 1e3) for a, b in device],
        host=[("aten::x", s(lo), 0.0), ("aten::y", s(hi), 0.0)], wall_s=(hi - lo) / 1e3,
    )


def rollout_records(offset_ms=0.0, steps=10):
    """One rollout call's records from ``offset_ms``: its pool's generate,
    the capture (its warm-up step's records inside), the replays' in-graph
    sums over ``steps`` steps."""
    o = offset_ms
    return [
        rec(1 + o, "lanes.rollout", None, o + 0, o + 100, 100.0, request=1 + o),
        rec(2 + o, "lanes.pool", 1 + o, o + 1, o + 9, 8.0, request=1 + o),
        rec(3 + o, "generator.generate", 2 + o, o + 1, o + 8, 6.5, request=1 + o),
        rec(4 + o, "lanes.capture", 1 + o, o + 10, o + 40, 30.0, request=1 + o,
            pool_bytes=1 << 20, graph_nodes=611, stamp_nodes=8),
        rec(5 + o, "lanes.step", 4 + o, o + 11, o + 15, 4.0, request=1 + o),
        rec(6 + o, "lanes.transition", 5 + o, o + 11, o + 12, 1.5, request=1 + o),
        rec(7 + o, "lanes.replay", 1 + o, o + 40, o + 99, 59.0, request=1 + o),
        rec(8 + o, "lanes.step", 7 + o, o + 40, o + 99, 1.6 * steps, steps, request=1 + o, graph=True),
        rec(9 + o, "lanes.transition", 8 + o, o + 40, o + 99, 0.5 * steps, steps, request=1 + o,
            graph=True),
        rec(10 + o, "lanes.select", 8 + o, o + 40, o + 99, 0.3 * steps, steps, request=1 + o,
            graph=True),
        rec(11 + o, "lanes.observation", 8 + o, o + 40, o + 99, 0.6 * steps, steps, request=1 + o,
            graph=True),
    ]


def test_rollout_readers_read_the_profiled_call(recorder):
    for r in rollout_records():
        recorder.add(r)
    trace = {"rollout_call": profile((0, 100), device=[(10, 12), (11, 14), (20, 25), (38, 45)])}
    # The replays' steps only: the capture's warm-up step is left out.
    assert read("lanes.step.span_ms", trace) == pytest.approx(1.6)
    assert read("lanes.transition.span_ms", trace) == pytest.approx(0.5)
    assert read("lanes.select.span_ms", trace) == pytest.approx(0.3)
    assert read("lanes.observation.span_ms", trace) == pytest.approx(0.6)
    assert read("lanes.graph_nodes", trace) == 611
    assert read("generator.generate.span_ms", trace) == pytest.approx(6.5)
    # lanes.capture is 10-40 ms: busy 10-14 (two overlapping operations),
    # 20-25 and 38-40 (clipped), so 30 - 11 ms idle.
    assert read("lanes.capture.idle_ms", trace) == pytest.approx(19.0, abs=1e-3)


def test_records_outside_the_profile_are_ignored(recorder):
    # A call before the profile (an untraced stretch's would keep none; a
    # second profile's records lie elsewhere on the clock) and the
    # profiled one, whose steps take another time.
    for r in rollout_records(offset_ms=-1000.0, steps=4):
        r.device = 99.0
        recorder.add(r)
    for r in rollout_records():
        recorder.add(r)
    trace = {"rollout_call": profile((0, 100))}
    assert read("lanes.step.span_ms", trace) == pytest.approx(1.6)
    assert read("generator.generate.span_ms", trace) == pytest.approx(6.5)
    assert read("lanes.capture.idle_ms", trace) == pytest.approx(30.0, abs=1e-3)


def test_dp_readers_average_a_call_over_the_solve_profile_only(recorder):
    rid = 0
    for call, (lo, scale) in enumerate([(0, 1.0), (200, 1.0), (5000, 10.0)]):
        for name, ms in (("dp.extract", 1.0), ("dp.vi", 70.0), ("dp.masks", 2.0),
                         ("dp.kernel", 63.0), ("dp.policy", 19.0)):
            rid += 1
            recorder.add(rec(rid, name, None, lo + 1, lo + 2, ms * scale * (1 + call % 2)))
    # The third call lies in another profile (the vi_calls stretch).
    trace = {"solve_calls": profile((0, 300)), "vi_calls": profile((4000, 6000))}
    assert read("dp.extract.span_ms", trace) == pytest.approx(1.5)
    assert read("dp.masks.span_ms", trace) == pytest.approx(3.0)
    assert read("dp.kernel.span_ms", trace) == pytest.approx(94.5)
    assert read("dp.policy.span_ms", trace) == pytest.approx(28.5)


def test_idle_merges_overlapping_operations():
    prof = profile((0, 10), device=[(1, 5), (2, 3), (4, 6), (8, 20)])
    # busy 1-6 and 8-10 within 0-10
    assert spans.idle_ms_within(prof, s(0), s(10)) == pytest.approx(3.0, abs=1e-3)
    assert spans.idle_ms_within(prof, s(6), s(8)) == pytest.approx(2.0, abs=1e-3)
    assert spans.idle_ms_within(profile((0, 1)), s(0), s(4)) == pytest.approx(4.0, abs=1e-3)


@pytest.mark.parametrize("metric", ROLLOUT + DP)
def test_readers_find_nothing(recorder, metric, monkeypatch):
    assert read(metric, {}) is None
    key = "rollout_call" if metric in ROLLOUT else "solve_calls"
    trace = {key: profile((0, 100), device=[(1, 2)])}
    assert read(metric, trace) is None  # no records: tracing was off
    for r in rollout_records():
        recorder.add(r)
    recorder.add(rec(99, "dp.extract", None, 1, 2, 1.0))
    # A program with no recorder, such as one from before the recorder.
    monkeypatch.delattr(profiling, "records")
    assert spans.program_records() == [] and read(metric, trace) is None
