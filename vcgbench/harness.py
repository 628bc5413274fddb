"""What every cell shares: finding a cell's files by name, the run's
environment, the device record, the per-layer metric readers, the
profiler over a sub-window and the reduction of its trace, and the
result line.

A cell is an entry of BENCHMARK.json's "workloads". Its configuration is
vcgbench/configs/<config>.json, its traffic vcgbench/traffic/<traffic>.json;
the traffic names the runner ("kind": vcgbench/kinds/<kind>.py) and the
generator it reads. The limits that decide `correct` are
vcgbench/limits/<cell>.json. A per-layer metric is
vcgbench/metrics/<name>.py, whose read(ctx) returns a number or None
(nothing to read).
"""

from __future__ import annotations

import bisect
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / "_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "video_chapter_generation_tpu")


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: dict = field(default_factory=dict)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The workload `name` of root/BENCHMARK.json with its configuration,
    traffic and the metrics it reports; KeyError if there is none."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({sorted(wl)})")
    w = wl[name]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    lim = HERE / "limits" / f"{name}.json"
    return Cell(name, config, traffic, int(w["chips"]),
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)],
                json.loads(lim.read_text()) if lim.exists() else {})


def setup_env() -> None:
    """Build and kernel caches at fixed paths inside the checkout, few
    host threads; before torch is imported."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(CACHE / sub)
    os.environ.setdefault("OMP_NUM_THREADS", "2")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def device_record(count: int, peak_bytes: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak_bytes),
            "power": power_limit()}


def forbidden_modules() -> List[str]:
    """Top-level names in sys.modules that the port may not load (each
    module name cut at its first dot, compared whole)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


# ---------------------------------------------------------------------------
# per-layer metrics
# ---------------------------------------------------------------------------


def read_metric(name: str, ctx: dict) -> Optional[float]:
    """vcgbench/metrics/<name>.py's read(ctx)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"vcgbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def per_layer_metrics(cell: Cell, ctx: dict) -> Dict[str, dict]:
    out = {}
    for m in cell.per_layer:
        v = read_metric(m["name"], ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


# ---------------------------------------------------------------------------
# profiler traces
# ---------------------------------------------------------------------------


def kernel_events(prof, device_type: str = "CUDA"
                  ) -> List[Tuple[int, int, str]]:
    """(start_ns, end_ns, name) of every device operation a finished
    torch.profiler.profile recorded (kernels, copies, sets)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name != device_type:
            continue
        start = int(e.start_ns()) if hasattr(e, "start_ns") else int(
            e.start_us() * 1000)
        dur = int(e.duration_ns()) if hasattr(e, "duration_ns") else int(
            e.duration_us() * 1000)
        out.append((start, start + dur, e.name()))
    return out


def union_busy(events: Sequence[Tuple[int, int, str]], lo: int, hi: int
               ) -> Tuple[float, List[Tuple[int, int]]]:
    """Seconds in [lo, hi] covered by at least one event, and the idle
    gaps [(start, end)] between them."""
    spans = sorted((max(s, lo), min(e, hi)) for s, e, _ in events
                   if e > lo and s < hi)
    busy, gaps, cur_s, cur_e = 0, [], None, lo
    for s, e in spans:
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            if s > cur_e:
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    if cur_e < hi:
        gaps.append((cur_e, hi))
    return busy / 1e9, gaps


def breakdown(events, lo: int, hi: int, top: int = 10) -> dict:
    """The device operations that took most time in [lo, hi] and the
    longest idle gaps, each gap named by the operation that ended before
    it ("after <op>"; what the host did then is not traced), summed by
    name."""
    by_name: Dict[str, float] = {}
    for s, e, name in events:
        if e > lo and s < hi:
            by_name[name] = by_name.get(name, 0.0) + (min(e, hi)
                                                      - max(s, lo)) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    _, gaps = union_busy(events, lo, hi)
    ends = sorted((e, name) for s, e, name in events)
    ends_t = [e for e, _ in ends]
    named: Dict[str, float] = {}
    for gs, ge in gaps:
        i = bisect.bisect_right(ends_t, gs) - 1
        label = "after " + ends[i][1][:120] if i >= 0 else "before any op"
        named[label] = named.get(label, 0.0) + (ge - gs) / 1e9
    idle = sorted(named.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in idle]}


def is_copy(name: str) -> bool:
    """A copy or a set (the copy engines' work), not a kernel."""
    return name.startswith(("Memcpy", "Memset"))


class WholeWindowTrace:
    """The profiler over the whole window of a run that reports its
    end-to-end metrics, device activity only: started in set-up, before
    the window opens, and read once the window has closed and the device
    has drained. `busy(lo_ns, hi_ns)` gives the seconds in which a kernel
    ran and those in which any device operation ran."""

    def __init__(self, dev):
        import torch

        self.kind = "CUDA" if dev.type == "cuda" else "CPU"
        acts = [torch.profiler.ProfilerActivity.CUDA if self.kind == "CUDA"
                else torch.profiler.ProfilerActivity.CPU]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()

    def busy(self, lo: int, hi: int) -> Dict[str, float]:
        self.prof.stop()
        ev = kernel_events(self.prof, self.kind)
        return {"kernel_busy_s": union_busy(
                    [e for e in ev if not is_copy(e[2])], lo, hi)[0],
                "device_busy_s": union_busy(ev, lo, hi)[0]}


def host_usage() -> Dict[str, float]:
    """This process's CPU seconds so far: read at both ends of a window,
    to tell a slower host from a process that waited for one."""
    import resource

    r = resource.getrusage(resource.RUSAGE_SELF)
    return {"cpu_user_s": r.ru_utime, "cpu_sys_s": r.ru_stime}


class TraceWindow:
    """The profiler over the traffic's sub-window of the window
    (wall-clock seconds from its start), started and stopped from the
    thread that drives the device: `tick()` is called there at every
    device call. Only device activity is recorded; `summary()`, once the
    window has closed, reduces it to the seconds in which some operation
    ran, the sub-window's length and a breakdown."""

    def __init__(self, trace: dict, t_start: float, dev):
        self.lo = t_start + trace["start_s"]
        self.length = trace["length_s"]
        self.dev = dev
        self.prof = None
        self.bounds = None

    def tick(self) -> None:
        import torch

        now = time.time()
        if self.prof is None and now >= self.lo:
            acts = [torch.profiler.ProfilerActivity.CUDA
                    if self.dev.type == "cuda"
                    else torch.profiler.ProfilerActivity.CPU]
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            self.bounds = [time.time_ns(), None]
        elif self.bounds and self.bounds[1] is None and \
                now >= self.bounds[0] / 1e9 + self.length:
            self._stop()

    def _stop(self) -> None:
        import torch

        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        self.bounds[1] = time.time_ns()
        self.prof.stop()

    def summary(self) -> dict:
        """{"events", "device": {busy_s, window_s}, "breakdown"}, or {}
        when the window closed before the sub-window began."""
        if self.prof is None:
            return {}
        if self.bounds[1] is None:
            self._stop()
        lo, hi = self.bounds
        ev = kernel_events(self.prof)
        busy, _ = union_busy(ev, lo, hi)
        return {"events": ev,
                "device": {"busy_s": busy, "window_s": (hi - lo) / 1e9},
                "breakdown": breakdown(ev, lo, hi)}


# ---------------------------------------------------------------------------
# the result
# ---------------------------------------------------------------------------


def emit(result: dict, checks: List[dict]) -> None:
    """Each compared number beside its limit, as the last lines on
    standard error and as the result line's last key; then the line."""
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
              f"({'ok' if c['ok'] else 'FAILED'})", file=sys.stderr,
              flush=True)
    result = dict(result)
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    print(json.dumps(result), flush=True)


def check(name: str, value: float, limit: float) -> dict:
    """A compared number: ok when value <= limit (a NaN is never ok)."""
    ok = value == value and value <= limit
    return {"name": name, "value": value, "limit": limit, "ok": bool(ok)}
