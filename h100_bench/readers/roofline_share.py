"""A kernel family's share of its roofline, in percent: the benchmark's
least time for the stretch's calls of it (``roofline.py``, from the spec
and dtypes) over the device time of its groups in the profiled stretch:
``{"groups": [...]}``. Nothing where the groups ran no kernel."""

from h100_bench.bench import groups


def read(run, spec):
    by_group = run.profile.group_s(groups())
    measured_s = sum(by_group.get(g, 0.0) for g in spec["groups"])
    if measured_s <= 0.0:
        return None
    bound_s = run.stats["knn_bound_ms_per_unit"] * run.profile.units / 1e3
    return 100.0 * bound_s / measured_s
