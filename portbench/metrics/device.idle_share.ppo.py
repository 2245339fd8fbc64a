"""The card's idle share in the traced PPO updates, in %: 1 - the
profiler's device busy time (overlapping operations merged) over the
updates' wall time, ended by a synchronise."""


def read(trace: dict):
    prof = trace.get("ppo_updates")
    if prof is None or not prof.device or prof.wall_s <= 0:
        return None
    return 100.0 * (1.0 - prof.busy_s() / prof.wall_s)
