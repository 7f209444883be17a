"""The traced run's reading of ``torch.profiler``: device activity as
intervals on the device's clock, the host spans the benchmark records
around its calls (``episode.reset``, ``entry.call``), and what follows from
them: the busy time (the union of the device intervals, never their sum,
since an ensemble's streams overlap), each device operation's summed time,
and the device's idle gaps, each named by what the host was doing then.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple

SPANS = ("episode.reset", "entry.call")
# idle gaps named in a reading (the longest)
GAPS = 10


class Reading(NamedTuple):
    """``busy_s``: the union of device intervals in the traced window;
    ``window_s``: the window, from the first traced span's start to the
    last one's end; ``op_s``: device seconds per operation name;
    ``gaps``: ``(label, seconds)`` of the ``GAPS`` longest idle gaps,
    longest first."""

    busy_s: float
    window_s: float
    op_s: Dict[str, float]
    gaps: List[Tuple[str, float]]


def _is_device(event) -> bool:
    return str(event.device_type()).split(".")[-1] in ("CUDA", "PrivateUse1")


def _is_annotation(event) -> bool:
    kind = str(event.activity_type()).lower() if hasattr(event, "activity_type") else ""
    return "annotation" in kind or event.name() in SPANS


# wrappers that name no operation in ``at::native`` kernels' template arguments
_GENERIC = {"gpu_kernel_impl_nocast", "gpu_kernel_impl", "gpu_index_kernel", "index_kernel_impl",
            "OpaqueType", "memory", "detail", "vectorized_elementwise_kernel",
            "unrolled_elementwise_kernel", "elementwise_kernel", "BinaryFunctor", "AUnaryFunctor",
            "BUnaryFunctor"}


def short_name(name: str) -> str:
    """A device operation's name without its return type, arguments and
    template arguments, but for the first functor of ``at::native`` they
    name (``elementwise_kernel<where_kernel_impl>``)."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    cut = [i for i in (name.find("<"), name.find("(")) if i > 0]
    if not cut:
        return name
    head = name[:min(cut)]
    found = [m for m in re.findall(r"at::native::(\w+)", name[len(head):]) if m not in _GENERIC]
    return f"{head}<{found[0]}>" if found else head


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def read(prof) -> Reading:
    """The reading of a finished ``torch.profiler.profile`` whose window
    holds the benchmark's spans."""
    device, host, spans = [], [], []
    op_ns: Dict[str, int] = defaultdict(int)
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if _is_device(e):
            # the profiler mirrors host spans onto the device's timeline as
            # annotations; they are no device work
            if end > start and not _is_annotation(e):
                device.append((start, end))
                op_ns[e.name()] += end - start
        elif e.name() in SPANS:
            spans.append((start, end, e.name()))
        else:
            host.append((start, end, e.name()))
    if not spans:
        raise RuntimeError("the trace holds none of the benchmark's spans")
    lo, hi = min(s[0] for s in spans), max(s[1] for s in spans)
    busy = _union([(max(a, lo), min(b, hi)) for a, b in device if b > lo and a < hi])
    busy_ns = sum(b - a for a, b in busy)
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    gaps = sorted(((a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a),
                  key=lambda g: g[0] - g[1])[:GAPS]
    labelled = [(_label((a + b) // 2, spans, host), (b - a) / 1e9) for a, b in gaps]
    return Reading(busy_ns / 1e9, (hi - lo) / 1e9, {k: v / 1e9 for k, v in op_ns.items()},
                   labelled)


def _label(t: int, spans, host) -> str:
    """What the host was doing at ``t``: the benchmark's span then and the
    shortest host operation within it ("between calls" outside every
    span)."""
    outer = [s for s in spans if s[0] <= t < s[1]]
    if not outer:
        return "between calls"
    inner = [h for h in host if h[0] <= t < h[1]]
    name = outer[0][2]
    if inner:
        name += "/" + min(inner, key=lambda h: h[1] - h[0])[2]
    return name


def breakdown(reading: Reading, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations that took most
    time (summed by ``short_name``) and the longest idle gaps by what the
    host was doing, each list ``[[name, seconds], ...]`` of at most ``top``
    entries."""
    by_short: Dict[str, float] = defaultdict(float)
    for name, seconds in reading.op_s.items():
        by_short[short_name(name)] += seconds
    ops = sorted(by_short.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in reading.gaps[:top]]}
