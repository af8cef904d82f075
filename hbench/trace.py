"""The device trace of a traced run (--trace 1), by torch.profiler.

Two readings, both made only in traced runs:

  * a slice of the measured window (Slice): the union of the device
    operations' intervals (busy), the slice's length, the device operations
    that took most time, the longest idle gaps by what the host was doing
    in them and, where a mesh's collectives ran, the device ms of one
    all-gather;
  * a few forwards profiled back to back after the window (per_forward):
    the device operations of one forward, and the device ms one forward
    spends in the library's conv/GEMM kernels, in PyTorch's elementwise
    and reduction kernels, and in the program's hand-written kernels.

The reduction copies the method of the repository's
chip_smoke.py:profile_batch (the intervals' union over one trace), run
over a steady slice of the window instead of one batch.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

# the program's hand-written kernels (tengine_tpu_torch/csrc/*.cu)
OWN_KERNELS = ("qconv_mma_kernel", "dw_qconv_kernel", "stem_qconv_kernel", "qblock_kernel")
# its hand-written kernels around the fast lowering's library convs
# (csrc/requant.cu); counted with OWN_KERNELS in own_kernel_ms alone
REQUANT_KERNELS = ("qwiden_kernel", "qrequant_kernel")
LIB_CONV = ("conv", "gemm", "xmma", "cutlass")
# idle gaps shorter than this are launch spacing, not waiting
GAP_MIN_US = 2.0
# collectives left out at each end of a slice: they wait on a peer whose
# tracer is starting or stopping, which no untraced call does
EDGE_GATHERS = 8


def _profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _device_events(prof) -> List:
    """The device's operations: kernels, copies, fills. The tracer also
    puts the host's record_function ranges on the device's timeline
    (spanning the work they launched); those are left out."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and not e.name.startswith("hbench.")]


def _host_events(prof) -> List:
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CPU]


def is_own(name: str) -> bool:
    return any(k in name for k in OWN_KERNELS)


def is_own_kernel(name: str) -> bool:
    """Any of the program's hand-written kernels."""
    return is_own(name) or any(k in name for k in REQUANT_KERNELS)


def is_lib_conv(name: str) -> bool:
    low = name.lower()
    return not is_own(name) and any(k in low for k in LIB_CONV)


def is_elementwise(name: str) -> bool:
    """PyTorch's own elementwise, reduction and indexing kernels."""
    return "at::native::" in name and not is_lib_conv(name)


def is_nccl(name: str) -> bool:
    """NCCL's collective kernels (ncclDevKernel_AllGather_..., ...)."""
    return "nccl" in name.lower()


def union(spans: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """The length of the union of sorted intervals, and the gaps between."""
    busy, end, gaps = 0.0, None, []
    for lo, hi in spans:
        if end is not None and lo > end:
            gaps.append((end, lo))
        busy += max(0.0, hi - (lo if end is None else max(lo, end)))
        end = hi if end is None else max(end, hi)
    return busy, gaps


def warm_up(device) -> None:
    """Start and stop the profiler once around a small device operation, so
    that the tracer's own start-up stays out of the window."""
    x = torch.ones(1024, device=device)
    with _profile():
        (x * 2).sum().item()


class Slice:
    """Traces the window from `start_s` to `start_s + length_s` after its
    start; `tick(elapsed)` is called by the loop that drives the window.
    `quiesce()`, where the loop gives one, is called before the tracer
    starts and stops: it waits until the program has no work in flight, so
    that the tracer is never switched while another thread launches."""

    def __init__(self, start_s: float, length_s: float, device):
        self.start_s, self.end_s = start_s, start_s + length_s
        self.device = device
        self.prof = None
        self.done = False
        self.quiesce = None

    def tick(self, elapsed: float) -> None:
        if self.done:
            return
        if self.prof is None and elapsed >= self.start_s:
            if self.quiesce is not None:
                self.quiesce()
            self.prof = _profile()
            self.prof.__enter__()
        elif self.prof is not None and elapsed >= self.end_s:
            self.stop()

    def stop(self) -> None:
        if self.prof is not None and not self.done:
            if self.quiesce is not None:
                self.quiesce()
            torch.cuda.synchronize(self.device)
            self.prof.__exit__(None, None, None)
            self.done = True

    def reduce(self) -> Optional[dict]:
        """busy_s and window_s of the slice, and the breakdown; None where
        nothing ran on the device."""
        if self.prof is None:
            return None
        self.stop()
        dev = _device_events(self.prof)
        if not dev:
            return None
        spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
        busy_us, gaps = union(spans)
        window_us = spans[-1][1] - spans[0][0]
        by_name: Dict[str, float] = defaultdict(float)
        for e in dev:
            by_name[e.name] += e.time_range.end - e.time_range.start
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        out = {
            "busy_s": busy_us / 1e6,
            "window_s": window_us / 1e6,
            "device_ops": [[k[:160], v / 1e6] for k, v in ops],
            "idle_gaps": _label_gaps(gaps, _host_events(self.prof)),
        }
        gather = gather_ms([(e.time_range.start, e.time_range.end) for e in dev
                            if is_nccl(e.name)])
        if gather is not None:  # only where a collective ran
            out["gather_ms"] = gather
        return out


def gather_ms(spans: List[Tuple[float, float]]) -> Optional[float]:
    """The mean device ms of one collective kernel, from the (start, end)
    us of each in a slice of the window: every rank traces the slice, so a
    kernel's time is its transfer and its wait for the slowest peer as the
    window has them. EDGE_GATHERS at each end are left out; None where too
    few ran."""
    kept = sorted(spans)[EDGE_GATHERS:len(spans) - EDGE_GATHERS]
    if not kept:
        return None
    return sum(hi - lo for lo, hi in kept) / 1e3 / len(kept)


def _label_gaps(gaps, host) -> List[list]:
    """Idle time by what the host was doing: each gap of GAP_MIN_US or more
    is labelled with the shortest host event that spans its midpoint; the
    labels' summed seconds, the ten largest."""
    host = sorted(((e.time_range.start, e.time_range.end, e.name) for e in host))
    starts = [h[0] for h in host]
    total: Dict[str, float] = defaultdict(float)
    for lo, hi in gaps:
        if hi - lo < GAP_MIN_US:
            continue
        mid = 0.5 * (lo + hi)
        i = bisect.bisect_right(starts, mid)
        best = None
        for s, e, name in host[max(0, i - 400):i]:
            if e >= mid and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        total[best[2] if best else "host: no traced operation"] += (hi - lo) / 1e6
    return [[k[:160], v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:10]]


def per_forward(call, n: int, device) -> dict:
    """Profiles `n` back-to-back calls of `call()` (each one forward, the
    program's copies in and out included): the device operations, the
    busy ms, and the ms the device spends in library conv/GEMM, in
    PyTorch's elementwise kernels and in the program's own kernels, each
    per forward."""
    call()
    torch.cuda.synchronize(device)
    with _profile() as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize(device)
    return forward_ms(_device_events(prof), n)


def forward_ms(dev: List, n: int) -> dict:
    """per_forward's reading of the device operations `dev` of `n`
    forwards. Each kind's ms is the union of its intervals: a library may
    run one forward's kernels side by side on streams of its own (cuDNN
    does, in ResNet-50's large convs), whose durations would count twice."""

    def ms(kind: Callable[[str], bool]) -> float:
        busy_us, _ = union(sorted((e.time_range.start, e.time_range.end)
                                  for e in dev if kind(e.name)))
        return busy_us / 1e3 / n

    return {
        "launches": len(dev) / n,
        "busy_ms": ms(lambda k: True),
        "lib_conv_ms": ms(is_lib_conv),
        "elementwise_ms": ms(is_elementwise),
        "own_kernel_ms": ms(is_own_kernel),
    }
