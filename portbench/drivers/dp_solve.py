"""Driver of the key-domain solve cells: each call turns a batch of DoorKey
states into V and the greedy policy through the port's
``extract_key_layout`` -> ``cuda_key_value_iteration`` ->
``key_greedy_policy``, called back to back, each call synchronised, as a
training loop that labels its batches would.

Traffic parameters: ``layouts`` a call, ``sweeps``, ``gamma``,
``max_doors``, a ``ring`` of distinct batches that the calls cycle
through, ``check_calls`` (calls of the window checked), ``check_block``
(layouts the reference solves at once) and, for the traced run,
``trace_calls``.  The states come from the reference's DoorKey maker,
seeded from the run's seed, and reach the port through ``bridge``.

End-to-end: ``dp_layouts_per_s``, the layouts of every call in the window
over the window's time; ``dp_solve_ms_p95``, the 95th percentile of the
calls' times from their start to their synchronised end, on the card's clock
(CUDA events); ``setup_s``.

The check, once the window has closed: ``check_calls`` calls drawn from
the seed, each against the plain reference (``reference/key_vi.py``) on
the same raw layouts: the widest gap between the program's V and the
reference's, and the widest gap between the program's V and the value
of its policy's action in one backup over the reference's V
(``reference/key_vi.py:policy_value_gap``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import harness
from portbench.counts import key_vi_work
from portbench.reference import doorkey as ref
from portbench.reference import key_vi as ref_vi


def port_arrays(raw: dict) -> dict:
    """The port's batch-first state fields of raw layouts (fresh episodes)."""
    from minigrid_dynamicprogramming_tpu_torch.core.state import AUX_SLOTS, MISSION_SLOTS

    n, h, w = raw["obj"].shape
    plane = np.zeros((n, h, w), np.uint8)
    return {
        "grid_obj": raw["obj"], "grid_color": raw["color"], "grid_state": raw["state"],
        "contains_obj": np.full_like(plane, ref.EMPTY), "contains_color": plane,
        "marks": np.zeros((n, h, w), np.int32), "vmarks": np.zeros((n, h, w), np.int32),
        "agent_pos": raw["agent_pos"], "agent_dir": raw["agent_dir"],
        "carrying_obj": np.full(n, ref.EMPTY, np.uint8), "carrying_color": np.zeros(n, np.uint8),
        "carrying_contains_obj": np.full(n, ref.EMPTY, np.uint8),
        "carrying_contains_color": np.zeros(n, np.uint8), "carrying_marks": np.zeros(n, np.int32),
        "step_count": np.zeros(n, np.int32), "terminated": np.zeros(n, bool),
        "truncated": np.zeros(n, bool),
        "aux": np.zeros((n, AUX_SLOTS), np.int32), "mission": np.zeros((n, MISSION_SLOTS), np.int32),
    }


def ref_tables(raw: dict, dev, max_doors: int, rows=slice(None)) -> ref_vi.Tables:
    def t(k):
        return torch.from_numpy(np.ascontiguousarray(raw[k][rows])).to(dev)

    n = raw["obj"][rows].shape[0]
    empty = torch.full((n,), ref.EMPTY, dtype=torch.uint8, device=dev)
    return ref_vi.tables(t("obj"), t("color"), t("state"), empty,
                         torch.zeros(n, dtype=torch.uint8, device=dev), max_doors)


def _check(raw: dict, v, pol, p: dict, dev, control: bool) -> dict:
    """The widest V gap and policy value gap of one call's answers
    against the reference, solved ``check_block`` layouts at a time.  With
    ``control``, the answers are the reference's own in bfloat16."""
    gamma, n, doors = p["gamma"], p["sweeps"], p["max_doors"]
    v_gap = pol_gap = 0.0
    for lo in range(0, raw["obj"].shape[0], p["check_block"]):
        rows = slice(lo, lo + p["check_block"])
        t = ref_tables(raw, dev, doors, rows)
        v_ref = ref_vi.value_iteration(t, gamma, n)
        if control:
            v_low = ref_vi.value_iteration(t, gamma, n, dtype=torch.bfloat16)
            v_got, pol_got = v_low.float(), ref_vi.greedy_policy(v_low, t, gamma)
        else:
            v_got, pol_got = v[rows].float(), pol[rows]
        v_gap = max(v_gap, float((v_got - v_ref).abs().max()))
        pol_gap = max(pol_gap, ref_vi.policy_value_gap(v_ref, t, gamma, v_got, pol_got))
        del v_ref, t
    return {"v_gap": v_gap, "policy_value_gap": pol_gap}


def run(ctx: harness.Context) -> dict:
    from minigrid_dynamicprogramming_tpu_torch import bridge
    from minigrid_dynamicprogramming_tpu_torch.core.state import EnvState
    from minigrid_dynamicprogramming_tpu_torch.dp import cuda_vi
    from minigrid_dynamicprogramming_tpu_torch.dp import tabular_key as TK

    cfg, p, dev = ctx.config, ctx.params, torch.device(ctx.device)
    on_card = dev.type == "cuda"
    b, n, gamma, doors = p["layouts"], p["sweeps"], p["gamma"], p["max_doors"]
    maker = ctx.rng(0)
    raws = [ref.make_layouts(maker, b, cfg["size"]) for _ in range(p["ring"])]
    states = [bridge.from_numpy(EnvState, port_arrays(r), dev) for r in raws]

    def solve(state):
        layout = TK.extract_key_layout(state, max_doors=doors)
        v = cuda_vi.cuda_key_value_iteration(layout, gamma, n)
        return v, TK.key_greedy_policy(v, layout, gamma)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    solve(states[0])  # warm-up: builds (first run in a checkout) and loads the kernels
    sync()
    ctx.setup_done()

    sample = sorted(ctx.rng(1).choice(p["ring"], size=p["check_calls"], replace=False).tolist())
    kept, spans, i = {}, harness.Spans(dev), 0
    t0 = time.perf_counter()
    while True:
        t = spans.start()
        out = solve(states[i % p["ring"]])
        spans.stop(t)
        sync()
        if i in sample:
            kept[i] = out
        i += 1
        if time.perf_counter() - t0 >= ctx.seconds and i > sample[-1]:
            break
    window_s = time.perf_counter() - t0
    call_ms = spans.ms()
    harness.report_window(len(call_ms), window_s, call_ms)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    trace = None
    if ctx.trace and on_card:
        trace = _trace(ctx, solve, states, raws, sync, call_ms, TK, cuda_vi)
    elif ctx.trace:
        trace = {}

    del states
    worst, failed = {}, 0
    for k in sample:
        v, pol = kept.pop(k)
        got = _check(raws[k % p["ring"]], v, pol, p, dev, ctx.control)
        del v, pol
        failed += int(any(val > ctx.limits[name] for name, val in got.items()))
        for name, val in got.items():
            worst[name] = max(worst.get(name, 0.0), val)
    return {
        "e2e": {"dp_layouts_per_s": i * b / window_s, "dp_solve_ms_p95": harness.p95(call_ms),
                "setup_s": ctx.setup_s},
        "trace": trace, "checks": [(k, v, ctx.limits[k]) for k, v in worst.items()],
        "attempted": i, "failed": failed, "memory_peak_bytes": peak,
    }


def _trace(ctx, solve, states, raws, sync, call_ms, TK, cuda_vi) -> dict:
    """The traced run's readings, after the window: each layer's span
    (CUDA events, a synchronise after each layer) over ``trace_calls``
    calls; the profiler over as many whole calls (the traced window), and
    over as many value-iteration calls alone on one batch's layouts, with
    that call's work counted by ``counts/key_vi_work.py``."""
    p = ctx.params
    calls, gamma, n, doors = p["trace_calls"], p["gamma"], p["sweeps"], p["max_doors"]
    spans = {k: harness.Spans(ctx.device) for k in ("extract", "vi", "policy")}
    for i in range(calls):
        state = states[i % p["ring"]]
        t = spans["extract"].start()
        layout = TK.extract_key_layout(state, max_doors=doors)
        spans["extract"].stop(t)
        sync()
        t = spans["vi"].start()
        v = cuda_vi.cuda_key_value_iteration(layout, gamma, n)
        spans["vi"].stop(t)
        sync()
        t = spans["policy"].start()
        TK.key_greedy_policy(v, layout, gamma)
        spans["policy"].stop(t)
        sync()
        del v

    def run_calls():
        for i in range(calls):
            solve(states[i % p["ring"]])
            sync()

    window = harness.profile(run_calls)
    window.counters["calls"] = calls
    layout = TK.extract_key_layout(states[0], max_doors=doors)

    def vi_calls():
        for _ in range(calls):
            cuda_vi.cuda_key_value_iteration(layout, gamma, n)

    vi = harness.profile(vi_calls)
    nbytes, ops = key_vi_work.work(ref_tables(raws[0], ctx.device, doors), n)
    vi.counters.update(calls=calls, bytes=nbytes, operations=ops)
    return {
        "window": window, "solve_calls": window, "vi_calls": vi, "call_ms": call_ms,
        "spans_ms": {k: s.ms() for k, s in spans.items()},
    }
