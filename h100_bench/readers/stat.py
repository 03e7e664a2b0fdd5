"""A number the mode measured itself, by key: ``{"key": ...}``; nothing where
the mode has none (a cell without device augmentation has no
``augment_ms``)."""


def read(run, spec):
    return run.stats.get(spec["key"])
