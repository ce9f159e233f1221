"""``step_host_ms.train``: the host's milliseconds in the benchmark's
span around ``train_step(...)``, from the call to its return, without a
synchronization, averaged over the window's steps outside the traced
stretch."""


def read(obs):
    if obs["kind"] != "train":
        return None
    return obs["step_host_ms"]
