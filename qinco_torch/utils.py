"""Small shared utilities: the device choice, timers and formatting
(counterpart of ``qinco_tpu/utils.py``).

Timers read the host's wall clock; callers fence device work
(``torch.cuda.synchronize()``) before they stop one."""

from __future__ import annotations

import time

import numpy as np
import torch

from . import tracing


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another one.  Without a card and without an explicit request it
    raises rather than quietly running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "qinco_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def sync(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host_to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A float32 copy of host array ``a`` (a memmap slice, say) on
    ``device``; to a card through pinned memory, without blocking the
    host.  The span ``io.upload`` (:mod:`qinco_torch.tracing`) holds the
    bytes copied."""
    with tracing.span("io.upload", bytes=int(np.size(a)) * 4):
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        if device.type == "cuda":
            tracing.count("io.h2d_bytes", t.nbytes)
            return t.pin_memory().to(device, non_blocking=True)
        return t


def format_time(t: float) -> str:
    hours, t = divmod(t, 3600)
    minutes, seconds = divmod(t, 60)
    return f"{int(hours):02}:{int(minutes):02}:{int(seconds):02}"


def format_memory(mem: float) -> str:
    for shift, unit in ((40, "T"), (30, "G"), (20, "M"), (10, "K")):
        if mem >= 2**shift:
            return f"{mem / (2 ** shift):.1f}{unit}"
    return f"{mem:.1f}b"


class Timer:
    """Accumulating wall-clock timer, also a context manager."""

    def __init__(self, elapsed: float = 0.0):
        self.elapsed = elapsed
        self.start_at: float | None = None

    def start(self, reset: bool = False) -> None:
        if reset:
            self.reset()
        elif self.start_at is not None:
            raise RuntimeError("Timer already running")
        self.start_at = time.perf_counter()

    def reset(self) -> None:
        self.elapsed = 0.0
        if self.start_at is not None:
            self.start_at = time.perf_counter()

    def stop(self) -> float:
        self.elapsed += time.perf_counter() - self.start_at
        self.start_at = None
        return self.get()

    def running(self) -> bool:
        return self.start_at is not None

    def get(self) -> float:
        if self.running():
            return self.elapsed + time.perf_counter() - self.start_at
        return self.elapsed

    def s(self, digits: int = 3) -> str:
        return f"{self.get():.{digits}f}s"

    def __str__(self) -> str:
        return format_time(self.get())

    __repr__ = __str__

    def __enter__(self) -> "Timer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


class TimersManager:
    """A named group of timers, read as attributes."""

    def __init__(self, *names: str):
        self._timers: dict[str, Timer] = {}
        self.add(*names)

    def add(self, *names: str) -> None:
        for name in names:
            self._timers.setdefault(name, Timer())

    def __getattr__(self, name: str) -> Timer:
        try:
            return self.__dict__["_timers"][name]
        except KeyError:
            raise AttributeError(name) from None

    def sum(self) -> Timer:
        """A stopped timer holding the sum of the group's times."""
        return Timer(elapsed=sum(t.get() for t in self._timers.values()))

    def state_dict(self) -> dict:
        return {name: t.get() for name, t in self._timers.items()}

    def load_state_dict(self, state: dict) -> None:
        for name, val in state.items():
            self.add(name)
            self._timers[name].elapsed = val

    def __str__(self) -> str:
        return " ".join(f"T_{n}={t}" for n, t in self._timers.items())
