"""``device_idle_pct.train``: 1 - busy / wall over the traced stretch of
a training run, busy the union of the device operations' intervals.  The
stretch traces the device only (``devtrace.py``), so the profiler does
not slow the host that launches the step."""


def read(obs):
    if obs["kind"] != "train" or obs["trace"] is None:
        return None
    tr = obs["trace"]
    return 100.0 * (1.0 - tr.busy_s() / tr.wall_s)
