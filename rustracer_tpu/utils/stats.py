"""Stats framework: counters with the reference's categorized report format.

Reference: rustracer-core/src/stats/{mod,macros}.rs — five macro families
(counter, memory counter, int distribution, percent, ratio) over thread-local
cells, flushed to a global accumulator and printed as a "Category/Title"
table (stats/mod.rs:83-201). Here a process-global registry (JAX's
functional model needs no thread-locals); device-side counts are aggregated
tensors fetched at report time.
"""
from __future__ import annotations

import sys
from collections import defaultdict
from typing import Dict, Tuple

_counters: Dict[str, int] = {}
_memory: Dict[str, int] = {}
_distributions: Dict[str, Tuple[int, int, int, int]] = {}  # sum, count, min, max
_percents: Dict[str, Tuple[int, int]] = {}
_ratios: Dict[str, Tuple[int, int]] = {}
_phases: Dict[str, float] = {}  # per-phase wall seconds (SURVEY §5.1)


def init_stats():
    """Reset all registries (lib.rs init_stats)."""
    _counters.clear()
    _memory.clear()
    _distributions.clear()
    _percents.clear()
    _ratios.clear()
    _phases.clear()


def phases() -> Dict[str, float]:
    """Copy of the per-phase wall seconds recorded since init_stats()."""
    return dict(_phases)


class time_phase:
    """Context manager accumulating wall time under a phase name — the
    per-phase observability the reference lacks (only a render-time print,
    api.rs:1012-1013; PBRT's ProfilePhase was not ported)."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        import time
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import time
        _phases[self.name] = _phases.get(self.name, 0.0) + \
            time.perf_counter() - self._t0
        return False


def print_phases(file=None):
    file = file or sys.stdout
    if not _phases:
        return
    print("Phase timings:", file=file)
    for name, secs in sorted(_phases.items(), key=lambda kv: -kv[1]):
        print(f"    {name:<42}{secs:9.3f} s", file=file)


def counter_add(name: str, n: int = 1):
    _counters[name] = _counters.get(name, 0) + int(n)


# --- device-counter tape ---------------------------------------------------
# OBSERVED device-side counts (reference scene.rs:9-20, mipmap.rs:17-19
# count work actually executed, not dispatched). Hot-path code calls
# device_count(name, traced_scalar) while the render step is being TRACED;
# the renderer brackets li_fn with begin/end and folds the collected traced
# scalars into the per-step counter vector it already fetches. No-op when no
# tape is active (unit tests, gradient transforms, sharded shard_map bodies).

_device_tape = None


def device_tape_begin():
    global _device_tape
    _device_tape = {}


def device_count(name: str, value):
    """Accumulate a (traced or python) scalar onto the active tape."""
    if _device_tape is None:
        return
    _device_tape[name] = _device_tape.get(name, 0) + value


def device_tape_end():
    global _device_tape
    tape, _device_tape = _device_tape, None
    return tape or {}


def device_tape_drain():
    """Return current entries and reset the tape (None when inactive).

    Loop-building code (lax.scan / while_loop drivers) brackets its traced
    body with this: entries the body added are static per-trace python
    counts, which the driver re-emits scaled by the executed trip count.
    Traced values must never cross a loop boundary via the tape — they are
    carried through the loop state instead."""
    global _device_tape
    if _device_tape is None:
        return None
    tape, _device_tape = _device_tape, {}
    return tape


def memory_add(name: str, nbytes: int):
    _memory[name] = _memory.get(name, 0) + int(nbytes)


def distribution_report(name: str, value: int, count: int = 1):
    s, c, lo, hi = _distributions.get(name, (0, 0, 1 << 62, -(1 << 62)))
    _distributions[name] = (s + int(value), c + count,
                            min(lo, int(value)), max(hi, int(value)))


def percent_report(name: str, num: int, denom: int):
    n, d = _percents.get(name, (0, 0))
    _percents[name] = (n + int(num), d + int(denom))


def ratio_report(name: str, num: int, denom: int):
    n, d = _ratios.get(name, (0, 0))
    _ratios[name] = (n + int(num), d + int(denom))


def _split(name):
    if "/" in name:
        cat, title = name.split("/", 1)
    else:
        cat, title = "Misc", name
    return cat, title


def _fmt_mem(nbytes):
    kb = nbytes / 1024.0
    if kb < 1024:
        return f"{kb:9.2f} kB"
    mib = kb / 1024.0
    if mib < 1024:
        return f"{mib:9.2f} MiB"
    return f"{mib / 1024.0:9.2f} GiB"


def print_stats(file=None):
    """Categorized table (stats/mod.rs:83-201 format)."""
    file = file or sys.stdout
    by_cat = defaultdict(list)
    for name, v in _counters.items():
        cat, title = _split(name)
        if v:
            by_cat[cat].append((title, f"{v:12d}"))
    for name, v in _memory.items():
        cat, title = _split(name)
        if v:
            by_cat[cat].append((title, _fmt_mem(v)))
    for name, (s, c, lo, hi) in _distributions.items():
        cat, title = _split(name)
        if c:
            by_cat[cat].append(
                (title, f"{s / c:.3f} avg [range {lo} - {hi}]"))
    for name, (n, d) in _percents.items():
        cat, title = _split(name)
        if d:
            by_cat[cat].append((title, f"{100.0 * n / d:.2f}% ({n}/{d})"))
    for name, (n, d) in _ratios.items():
        cat, title = _split(name)
        if d:
            by_cat[cat].append((title, f"{n / d:.2f}x ({n}/{d})"))
    print("Statistics:", file=file)
    for cat in sorted(by_cat):
        print(f"  {cat}", file=file)
        for title, val in sorted(by_cat[cat]):
            print(f"    {title:<42}{val}", file=file)
