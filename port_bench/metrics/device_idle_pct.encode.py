"""``device_idle_pct.encode``: 1 - busy / wall over the traced stretch of
an encode run, busy the union of the device operations' intervals."""


def read(obs):
    if obs["kind"] != "encode" or obs["trace"] is None:
        return None
    tr = obs["trace"]
    return 100.0 * (1.0 - tr.busy_s() / tr.wall_s)
