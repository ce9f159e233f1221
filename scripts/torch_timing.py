"""Timing of the port's kernels for the scripts beside this one
(``torch_ktopa_breakdown.py``, ``torch_kernel_variants.py``,
``torch_scoring_times.py``): the ms of back-to-back calls between CUDA
events, the device ms of a kernel's launch from torch.profiler, and the
card a result was measured on.  Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import subprocess
import time

import torch


def time_calls(fn, iters: int, device: torch.device, kernel: str):
    """(ms a call, device ms a launch of ``kernel``) of ``fn()``, which
    launches ``kernel`` once, over ``iters`` back-to-back calls after one
    warm-up call.  On a card the first is read between two CUDA events
    (each call's host work overlaps the kernels queued before it, unless it
    takes longer than they do), the second from torch.profiler over another
    ``iters`` calls: the kernel's own time, whatever the host does.  On the
    CPU: the host clock, and None."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters, None
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
    if len(us) != iters:
        raise RuntimeError(f"{len(us)} launches of {kernel} in {iters} calls")
    return start.elapsed_time(end) / iters, sum(us) / 1e3 / iters


def time_variants(variants, call_of, rows_of, iters: int, row_tiles, device: torch.device,
                  kernel: str, batch: int) -> dict:
    """The breakdown entry points' run: each variant at each rows a work
    item (``None``: the plan's), ``call_of(variant, rows)`` the call it
    times and ``rows_of(variant, rows)`` the rows its launch takes (None
    on the CPU), through :func:`time_calls`.  A rows value the card does not
    take (a ValueError) is recorded as an error, as the JAX scripts record
    theirs.  Returns the scripts' JSON: ``utc``, ``batch``, ``ms_per_step``
    and ``kernel_ms`` keyed ``<variant>@R<rows>``, ``device``."""
    results, kernel_ms = {}, {}
    for rt in row_tiles:
        for v in variants:
            t0 = time.perf_counter()
            name = f"{v}@R{rt}"
            try:
                R = rows_of(v, rt)
                name = f"{v}@R{R}" if R else v
                ms, kernel_ms[name] = time_calls(call_of(v, rt), iters, device, kernel)
                results[name] = ms
                launch = "" if kernel_ms[name] is None else f", {kernel_ms[name]:8.3f} a launch"
                print(f"{name:22s}: {ms:8.3f} ms/step{launch} ({batch / ms:.1f}k vec-steps/s)",
                      flush=True)
            except ValueError as e:
                results[name] = f"error: {str(e).splitlines()[0][:160]}"
                print(f"{name}: ERROR {results[name]}", flush=True)
            print(f"  (wall {time.perf_counter() - t0:.1f}s)", flush=True)
    return {"utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()), "batch": batch,
            "ms_per_step": results, "kernel_ms": kernel_ms, "device": card(device)}


def card(device: torch.device) -> dict:
    """The device a result was measured on: the card's name and power limit
    (``nvidia-smi``) on a card, ``cpu`` otherwise."""
    if device.type != "cuda":
        return {"name": "cpu"}
    line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    name, limit = (f.strip() for f in line.split(","))
    return {"name": name, "power_limit": limit}
