"""Profiling helpers (the reference has only ad-hoc @time calls —
SURVEY.md §5; here: structured tracing + simple timers)."""

from __future__ import annotations

import contextlib
import time
import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace viewable in TensorBoard/Perfetto."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Wall-clock timer that blocks on device results.

    with Timer() as t:
        out = fn(x)
        t.block(out)
    print(t.elapsed)
    """

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.elapsed = None
        return self

    def block(self, out):
        jax.block_until_ready(out)
        return out

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        return False


_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "u64": 8,
    "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1, "pred": 1,
}

_COLLECTIVES = (
    "all-gather", "all-reduce", "collective-permute", "all-to-all",
    "reduce-scatter", "collective-broadcast",
)


def hlo_collective_stats(compiled_text: str) -> dict:
    """Communication accounting from optimized HLO: count and output bytes
    of every collective instruction (all-gather / all-reduce /
    collective-permute / all-to-all / reduce-scatter).

    Collectives inside a `while` body execute once per solver iteration, and
    the iteration loop dominates these programs, so the totals read as
    per-iteration communication volume (prologue/epilogue collectives are
    counted too — noted upper bound).  Pass
    ``jax.jit(f).lower(*args).compile().as_text()``.
    """
    import re

    by_kind: dict = {}
    total_bytes = 0
    count = 0
    # e.g.:  %ag = f32[1,4,2048]{2,1,0} all-gather(...)
    #        %ar = (f32[2], f32[2]) all-reduce(...)
    # Async collectives lower to a -start/-done pair describing ONE transfer;
    # count only the sync op or the -start half (matching any "-" suffix
    # would double-count every async collective and its bytes).
    pat = re.compile(
        r"=\s*(\(?[a-z0-9]+\[[0-9,]*\][^)]*?\)?)\s+("
        + "|".join(_COLLECTIVES)
        + r")(?:-start)?\("
    )
    shape_pat = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
    for m in pat.finditer(compiled_text):
        shapes, kind = m.group(1), m.group(2)
        nbytes = 0
        for sm in shape_pat.finditer(shapes):
            dt, dims = sm.group(1), sm.group(2)
            elems = 1
            for dd in dims.split(","):
                if dd:
                    elems *= int(dd)
            nbytes += elems * _DTYPE_BYTES.get(dt, 4)
        count += 1
        total_bytes += nbytes
        k = by_kind.setdefault(kind, {"count": 0, "bytes": 0})
        k["count"] += 1
        k["bytes"] += nbytes
    return {"count": count, "bytes": total_bytes, "by_kind": by_kind}


def _union_ns(intervals) -> float:
    """Total length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


# What trace_device_stats reads: one plane per GPU, and on it the "Stream
# #..." lines, which hold the kernels and copies the device ran (the derived
# "XLA Ops"/"XLA Modules" lines are skipped).
DEVICE_PLANE_PREFIX = "/device:GPU"
KERNEL_LINE = "Stream"


def trace_device_stats(logdir: str) -> dict:
    """Reduce a ``jax.profiler`` trace to device-side counts and times.

    Reads the newest ``*.xplane.pb`` under ``logdir``: the events on the
    ``KERNEL_LINE`` lines of every ``DEVICE_PLANE_PREFIX`` plane.  Returns,
    per plane and in total: the event count,
    the summed event time, the busy time (union of event intervals) and the
    window (first start to last end), all in nanoseconds, plus the device
    time of the ten costliest event names.
    """
    import glob
    import os

    from jax.profiler import ProfileData

    paths = sorted(
        glob.glob(os.path.join(logdir, "plugins", "profile", "*",
                               "*.xplane.pb")),
        key=os.path.getmtime,
    )
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {logdir}")
    pd = ProfileData.from_file(paths[-1])
    planes = {}
    by_name: dict = {}
    for plane in pd.planes:
        if not plane.name.startswith(DEVICE_PLANE_PREFIX):
            continue
        iv = []
        for line in plane.lines:
            if KERNEL_LINE not in line.name:
                continue
            for ev in line.events:
                s = float(ev.start_ns)
                iv.append((s, s + float(ev.duration_ns)))
                by_name[ev.name] = by_name.get(ev.name, 0.0) + float(
                    ev.duration_ns
                )
        planes[plane.name] = {
            "events": len(iv),
            "event_ns": sum(e - s for s, e in iv),
            "busy_ns": _union_ns(iv),
            "window_ns": (max(e for _, e in iv) - min(s for s, _ in iv))
            if iv else 0.0,
        }
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "planes": planes,
        "events": sum(p["events"] for p in planes.values()),
        "busy_ns": sum(p["busy_ns"] for p in planes.values()),
        "top_ns": dict(top),
    }


def card_info() -> str:
    """``name, power.limit`` of each GPU, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them (one card per ``;``).  Raises where nvidia-smi is missing: every
    device number is reported beside the card it came from."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout
    return "; ".join(l.strip() for l in out.splitlines() if l.strip())


def time_fn(fn, *args, iters: int = 3, warmup: int = 1) -> float:
    """Median wall time of ``fn(*args)`` with compile warmup."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
