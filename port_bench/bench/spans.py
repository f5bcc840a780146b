"""The program's own spans in a traced run: device time and idle time by the phase that launched or awaited them.

While a profiler records, ``factorizer_tpu_torch`` opens a ``torch.profiler.record_function`` named ``ftt.<name>``
at each phase boundary of its train step and its served case (``utils/profiling.py::span``): ``train.forward``,
``train.backward``, ``train.update``; ``sliding_window.prepare``, ``.gather``, ``.predict``, ``.blend``,
``.normalize``; ``serve.combine``.  The benchmark's own spans are named ``port_bench.<name>``
(``bench/trace.py``), and neither reduction reads the other's.

:func:`reduce_program_spans` attributes by launch, never by where device time overlaps a host span, since the card
runs behind the host:

* a device operation (kernel, copy or set) belongs to the innermost program span open on the host when the runtime
  or driver call that launched it ran, matched to it through their shared ``args.correlation``, on any thread (the
  backward launches from autograd's device thread while ``train.backward`` is open on the main one);
* an idle gap of the device belongs to the innermost program span open on the host at the gap's start, as
  ``trace.reduce_events`` names gaps by the benchmark's spans.

``trace.traced`` returns only its own reduction; :func:`install` wraps it so that a traced run's result also holds
this one under ``"program"``, every other key and value as they were.  The readers of the per-phase metrics call it
when they are loaded, which ``bench.cell.run_cell`` does before the run.
"""

from __future__ import annotations

from . import trace

PREFIX = "ftt."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _innermost(spans: list, times: list) -> list:
    """For each time ``t``, the name of the innermost (shortest) span with ``start <= t < end``; None where none is."""
    bounds = sorted([(s, 0, i) for i, (s, _, _) in enumerate(spans)] + [(e, 1, i) for i, (_, e, _) in enumerate(spans)])
    out: list = [None] * len(times)
    open_: dict = {}
    k = 0
    for j in sorted(range(len(times)), key=times.__getitem__):
        while k < len(bounds) and bounds[k][0] <= times[j]:
            _, closing, i = bounds[k]
            if closing:
                open_.pop(i, None)
            else:
                open_[i] = spans[i]
            k += 1
        if open_:
            out[j] = min(open_.values(), key=lambda sp: sp[1] - sp[0])[2]
    return out


def reduce_program_spans(events: list) -> dict:
    """A chrome trace's ``traceEvents`` -> ``{"spans": {name: {"device_s", "idle_s", "opened"}}, "outside_device_s",
    "outside_idle_s", "unmatched_device_s"}``: for each program span's name (without ``ftt.``) the device seconds
    launched inside it, the device's idle seconds that began inside it and the times it opened; the device seconds
    and idle seconds outside every program span; and the device seconds whose launch the trace does not hold."""
    spans, device, launches = [], [], {}
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        start, end, cat = float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]), ev.get("cat")
        if cat in trace.DEVICE_CATS:
            device.append((start, end, (ev.get("args") or {}).get("correlation")))
        elif cat in LAUNCH_CATS and "correlation" in (ev.get("args") or {}):
            launches.setdefault(ev["args"]["correlation"], start)
        elif cat == "user_annotation" and str(ev.get("name", "")).startswith(PREFIX):
            spans.append((start, end, ev["name"][len(PREFIX):]))
    table: dict = {}
    for _, _, name in spans:
        entry = table.setdefault(name, {"device_s": 0.0, "idle_s": 0.0, "opened": 0})
        entry["opened"] += 1
    out = {"spans": table, "outside_device_s": 0.0, "outside_idle_s": 0.0, "unmatched_device_s": 0.0}

    matched = [(s, e, launches[c]) for s, e, c in device if c in launches]
    out["unmatched_device_s"] = sum(e - s for s, e, c in device if c not in launches) * 1e-6
    for (start, end, _), name in zip(matched, _innermost(spans, [t for _, _, t in matched])):
        if name is None:
            out["outside_device_s"] += (end - start) * 1e-6
        else:
            table[name]["device_s"] += (end - start) * 1e-6

    merged = trace._merge([(s, e) for s, e, _ in device])
    gaps = [(prev_end, nxt - prev_end) for (_, prev_end), (nxt, _) in zip(merged, merged[1:])]
    for (_, length), name in zip(gaps, _innermost(spans, [t for t, _ in gaps])):
        if name is None:
            out["outside_idle_s"] += length * 1e-6
        else:
            table[name]["idle_s"] += length * 1e-6
    return out


def install() -> None:
    """Wrap ``trace.traced`` (once) so that its result also holds :func:`reduce_program_spans` of the same events
    under ``"program"``; ``trace.reduce_events`` is the harness's own outside a traced run."""
    if getattr(trace.traced, "reduces_program_spans", False):
        return
    traced, reduce_events = trace.traced, trace.reduce_events

    def traced_with_program(run_units, device) -> dict:
        seen = []

        def keep(events: list) -> dict:
            seen.append(events)
            return reduce_events(events)

        trace.reduce_events = keep
        try:
            out = traced(run_units, device)
        finally:
            trace.reduce_events = reduce_events
        out["program"] = reduce_program_spans(seen[-1])
        return out

    traced_with_program.reduces_program_spans = True
    trace.traced = traced_with_program


def per_unit_ms(run, names: tuple, key: str) -> float | None:
    """1e3 x the ``key`` seconds (``"device_s"`` or ``"idle_s"``) of the spans ``names`` in the traced units, over
    their count; None where the run holds no program spans or no device operation was launched inside one (on the
    CPU, or a program that opens none)."""
    program = getattr(run, "trace", {}).get("program")
    if not program or not any(v["device_s"] > 0 for v in program["spans"].values()):
        return None
    seconds = sum(program["spans"][n][key] for n in names if n in program["spans"])
    return 1e3 * seconds / run.traced_units
