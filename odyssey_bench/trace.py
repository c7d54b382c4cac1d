"""Reading the profiler's trace of a window: the device's busy time as the
union of its activity intervals, the device operations that took most time,
and the longest idle gaps named by what the host was doing in them."""
from __future__ import annotations

import numpy as np

TOP = 10


def _union(starts: np.ndarray, ends: np.ndarray) -> tuple:
    """Merged intervals (sorted, disjoint) of the given ones."""
    if len(starts) == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > reach[:-1]
    idx = np.flatnonzero(new)
    last = np.append(idx[1:] - 1, len(s) - 1)
    return s[idx], reach[last]


def summarize(prof, window_s: float) -> dict:
    """``busy_s``: seconds with an operation on the device; ``window_s``:
    the traced window (host clock); ``device_ops``: device time by
    operation; ``idle_gaps``: the longest gaps between device activity,
    each named by the innermost host event that spans its middle."""
    from torch.autograd import DeviceType

    dev_s, dev_e, host = [], [], []
    by_name: dict = {}
    for e in prof.events():
        t0, t1 = e.time_range.start, e.time_range.end
        if getattr(e, "is_user_annotation", False) or e.name.startswith("harness."):
            host.append((t0, t1, e.name))
        elif e.device_type == DeviceType.CUDA:
            dev_s.append(t0)
            dev_e.append(t1)
            by_name[e.name] = by_name.get(e.name, 0.0) + (t1 - t0) * 1e-6
        else:
            host.append((t0, t1, e.name))
    s, e = _union(np.asarray(dev_s, float), np.asarray(dev_e, float))
    busy_s = float((e - s).sum()) * 1e-6
    gaps = []
    if len(s) > 1:
        g0, g1 = e[:-1], s[1:]
        longest = np.argsort(g0 - g1)[:TOP]
        hs = np.asarray([h[0] for h in host], float)
        he = np.asarray([h[1] for h in host], float)
        for i in longest:
            mid = (g0[i] + g1[i]) / 2
            cover = np.flatnonzero((hs <= mid) & (he >= mid))
            name = (host[cover[np.argmin(he[cover] - hs[cover])]][2]
                    if len(cover) else "no host event")
            gaps.append([name, float(g1[i] - g0[i]) * 1e-6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(busy_s=busy_s, window_s=float(window_s),
                device_ops=[[k[:160], v] for k, v in ops], idle_gaps=gaps,
                device_events=len(dev_s), host_events=len(host))
