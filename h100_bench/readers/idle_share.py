"""The share of the profiled stretch's wall time in which no operation ran
on the device, in percent."""


def read(run, spec):
    p = run.profile
    return 100.0 * max(0.0, 1.0 - p.busy_s / p.window_s)
