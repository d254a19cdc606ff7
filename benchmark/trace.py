"""The reading of a torch.profiler trace of the profiled sub-window into
what the per-layer readers take (the arithmetic of `chip_smoke.py`'s
`phase_profile`, copied): device time by kernel name, device busy time as
the union of the device intervals, the host calls that start device
work, the sub-window's length, and the breakdown of the longest device
operations and idle gaps."""

from __future__ import annotations

# host calls that start device work
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync",
                "cudaGraphLaunch")
BREAKDOWN_ENTRIES = 10


def kernel_us(ctx, pattern: str) -> float:
    """Device microseconds of the operations whose name holds `pattern`."""
    return sum(t for name, t in ctx["device_us"].items() if pattern in name)


def summarize(prof) -> dict:
    """device_us (by name), busy_us, window_us, host_calls and breakdown
    of a finished `torch.profiler.profile`."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end, e.name)
        if e.device_type == DeviceType.CUDA:
            device.append(span)
        elif e.device_type == DeviceType.CPU:
            host.append(span)
    if not device:
        raise RuntimeError("the trace holds no device activity")
    device.sort()
    busy, reach, by_name, gaps = 0.0, device[0][0], {}, []
    for start, end, name in device:
        if start > reach:
            gaps.append((start - reach, reach, start))
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        by_name[name] = by_name.get(name, 0.0) + (end - start)
    first = min(device[0][0], min((h[0] for h in host), default=device[0][0]))
    last = max(reach, max((h[1] for h in host), default=reach))
    calls = {}
    for _, _, name in host:
        if name in LAUNCH_CALLS:
            calls[name] = calls.get(name, 0) + 1
    gaps.sort(reverse=True)
    top_gaps = [[_host_label(host, a, b), 1e-6 * length]
                for length, a, b in gaps[:BREAKDOWN_ENTRIES]]
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"device_us": by_name, "busy_us": busy, "window_us": last - first,
            "host_calls": calls,
            "breakdown": {"device_ops": [[n, 1e-6 * t] for n, t in
                                         top_ops[:BREAKDOWN_ENTRIES]],
                          "idle_gaps": top_gaps}}


def _host_label(host, a, b) -> str:
    """The innermost host operation running at the middle of the gap
    (a, b): of those that span it, the one that started last."""
    mid = 0.5 * (a + b)
    best = None
    for start, end, name in host:
        if start <= mid <= end and (best is None or start > best[0]):
            best = (start, name)
    return best[1] if best else "(no host operation)"
