"""The ``serve`` kind of traffic: a closed loop of cases through the program's fold ensemble, and the reference's
check of the answers.

Set-up builds the mix's ``folds`` networks (each holding the seed's tensors of its own stream) behind
:class:`bench.cell.Forward`, makes one cycle of case images on the host, and warms up by serving a case of the
cycle's largest size.  The window serves the cycle's cases one at a time, each timed from the image on the host to
the mask back on the host, through ``zoo_scripts.ensemble_predict``.  The answers of the cases that
``traffic.serve_checked`` draws from the seed are moved to the host as the window produces them (after the case's
time is taken), so the device's peak holds only the program's tensors; a checked case the window did not reach is
served after the window.  The reference serves the same images from the same tensors (``bench.check.serve_numbers``).
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import torch

from port_bench.bench import cell as cells
from port_bench.bench import check, flops, program, trace, traffic, weights
from port_bench.reference import serve as ref_serve

TRACED_UNITS = 2


def _spec(cell, ctx) -> dict:
    return ctx.reference.param_spec(cell.config["network_def"], tuple(cell.traffic["roi"]))


def serve_case(models: list, image, tr: dict, device):
    """One case, timed from the image on the host to the mask back on the host: ``(mask on the host, probs)``."""
    with trace.span("serve.case"):
        with trace.span("serve.to_device"):
            x = image.to(device)
        with trace.span("serve.ensemble_predict"):
            mask, probs = program.serve(models, x, tuple(tr["roi"]), tr["sw_batch"], tr["overlap"])
        with trace.span("serve.mask_to_host"):
            host = mask.cpu()
    return host, probs


def program_models(cell, ctx) -> list:
    """The folds' networks from the seed's tensors, in evaluation mode, each behind a :class:`cells.Forward`."""
    spec_ = _spec(cell, ctx)
    return [cells.Forward(cells.program_network(cell, ctx, spec_, f).eval()) for f in range(cell.traffic["folds"])]


def reference_probs(cell, ctx, images: list, dtype=None) -> list:
    """The reference's fold-mean probabilities of each image, from the seed's tensors, in ``dtype`` (default: the
    held dtype)."""
    tr, net = cell.traffic, cell.config["network_def"]
    dtype = dtype or ctx.held
    spec_ = _spec(cell, ctx)
    folds = [weights.make_weights(spec_, ctx.seed, f, ctx.device, dtype) for f in range(tr["folds"])]
    return [ref_serve.ensemble_probs(ctx.reference.forward, folds, net, image.to(ctx.device, dtype), tuple(tr["roi"]),
                                     tr["sw_batch"], tr["overlap"], tr["mode"]).cpu() for image in images]


def run(cell, ctx) -> SimpleNamespace:
    tr, device = cell.traffic, ctx.device
    net, roi = cell.config["network_def"], tuple(tr["roi"])
    cases = traffic.serve_cases(tr, net, ctx.seed, device, ctx.held)
    models = program_models(cell, ctx)
    checked = traffic.serve_checked(tr, ctx.seed)
    out = SimpleNamespace(kind="serve", flops_call=flops.forward_flops(ctx.reference, net, tr["sw_batch"], roi),
                          folds=tr["folds"])
    windows = [tr["shapes"][i]["windows"] for i in tr["pattern"]]
    serve_case(models, cases[windows.index(max(windows))], tr, device)  # warm-up: the largest size
    cells.reset_peak(device)

    start = time.perf_counter()
    out.setup_s = start - ctx.t0
    calls_before = sum(m.calls for m in models)
    answers, k, failed = {}, 0, 0
    while True:
        pos = k % len(cases)
        mask, probs = serve_case(models, cases[pos], tr, device)
        if tuple(mask.shape) != (1, net["out_channels"], *cases[pos].shape[2:]):
            failed += 1
        if k < len(cases) and pos in checked:
            answers[pos] = (mask, probs.cpu())
        del probs
        k += 1
        if time.perf_counter() - start >= ctx.seconds:
            break
    out.window_s = time.perf_counter() - start
    out.units, out.failed = k, failed
    out.windows_done, out.mean_windows = sum(windows[j % len(windows)] for j in range(k)), sum(windows) / len(windows)
    out.window_calls = sum(m.calls for m in models) - calls_before

    if ctx.trace:
        events, case_events = [], []

        def units():
            nonlocal k
            for _ in range(TRACED_UNITS):
                start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                first = len(events)
                start_ev.record()
                serve_case(models, cases[k % len(cases)], tr, device)
                end_ev.record()
                case_events.append((start_ev, end_ev, first, len(events)))
                k += 1

        for m in models:
            m.events = events
        calls = sum(m.calls for m in models)
        out.trace, out.launches = cells.traced(units, ctx)
        out.traced_calls = sum(m.calls for m in models) - calls
        out.traced_units = TRACED_UNITS
        outside = [a.elapsed_time(b) - sum(s.elapsed_time(e) for s, e in events[lo:hi]) for a, b, lo, hi in case_events]
        out.outside_forward_ms = sum(outside) / len(outside)
        for m in models:
            m.events = None
    cells.sync(device)
    out.peak_bytes = cells.peak_bytes(device)
    for pos in checked:  # an answer the window did not reach is waited for
        if pos not in answers:
            mask, probs = serve_case(models, cases[pos], tr, device)
            answers[pos] = (mask, probs.cpu())
    del models
    cells.free_memory()

    t_ref = time.perf_counter()
    refs = reference_probs(cell, ctx, [cases[pos] for pos in checked])
    out.reference_s = time.perf_counter() - t_ref
    out.numbers = check.serve_numbers([answers[pos] for pos in checked], refs, cell.limits["probs_gap"])
    return out


# -- the readings that set the limits (port_bench/control.py)

def readings(cell, ctx, do_program: bool, do_control: bool) -> dict:
    """name -> the numbers ``bench.check`` compares for the seed's checked cases, against the reference:
    ``program`` (the lower readings) and ``control`` (the reference put in the program's place at the
    configuration's ``precision.control``, its mask ``probs > 0.5``: the upper readings)."""
    tr = cell.traffic
    cases = traffic.serve_cases(tr, cell.config["network_def"], ctx.seed, ctx.device, ctx.held)
    images = [cases[pos] for pos in traffic.serve_checked(tr, ctx.seed)]
    refs = reference_probs(cell, ctx, images)
    limit = cell.limits["probs_gap"]
    out = {}
    if do_program:
        models = program_models(cell, ctx)
        answers = [serve_case(models, image, tr, ctx.device) for image in images]
        del models
        out["program"] = check.serve_numbers([(m, p.cpu()) for m, p in answers], refs, limit)
    if do_control:
        with cells.precision(cell.config["precision"]["control"]) as dtype:
            ctl = reference_probs(cell, ctx, images, dtype)
        out["control"] = check.serve_numbers([((p > 0.5).to(dtype=p.dtype), p) for p in ctl], refs, limit)
    return out
