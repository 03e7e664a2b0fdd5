"""Device milliseconds of kernel groups per step or per forward, from the
profiled stretch: ``{"groups": [...], "per": "step" | "forward"}``."""

from h100_bench.bench import groups


def read(run, spec):
    by_group = run.profile.group_s(groups())
    if not any(g in by_group for g in spec["groups"]):
        return None
    per = run.profile.units * (run.stats["forwards_per_unit"] if spec["per"] == "forward" else 1)
    return 1e3 * sum(by_group.get(g, 0.0) for g in spec["groups"]) / per
