"""The ``train`` kind of traffic: a closed loop of the program's train steps, and the reference's check of them.

Set-up builds one train state (the program's network holding the seed's tensors, its fused AdamW, its
``make_train_step`` with DiceCE), drives it through the mix's first ``checked_steps`` steps with the window's own
call and feed, on ring batches that all differ, and hands that same state to the window.  Those steps' losses, the
first step's gradient as the optimiser got it (AdamW's first moment over ``1 - beta1``) and the leaves' change are
what the reference's steps, from the same tensors and batches, are compared with (``bench.check.train_numbers``).
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import torch

from port_bench.bench import cell as cells
from port_bench.bench import check, flops, program, trace, traffic, weights
from port_bench.reference import train as ref_train

BETA1 = 0.9  # AdamW's first-moment decay, the program's and the reference's default
TRACED_UNITS = 3


def checked_batches(tr: dict, ring: list) -> list:
    return [ring[i % len(ring)] for i in range(tr["checked_steps"])]


def _spec(cell, ctx) -> dict:
    return ctx.reference.param_spec(cell.config["network_def"], tuple(cell.traffic["roi"]))


def program_readings(cell, ctx, ring: list, steps: int | None = None):
    """The program's first ``steps`` (default ``checked_steps``) steps from the seed's tensors through its own step
    and feed: the readings (losses, the first gradient's leaf norms from AdamW's state, the leaves' change) and the
    live state and step."""
    cfg, spec_ = cell.config, _spec(cell, ctx)
    model = cells.program_network(cell, ctx, spec_, 0)
    state, step = program.train_state(model, cfg["learning_rate"], cfg["weight_decay"])
    losses, grad_norms = [], None
    for i, batch in enumerate(checked_batches(cell.traffic, ring)[:steps]):
        with trace.span("train.step"):
            state, m = step(state, batch)
        losses.append(m["loss"])
        if i == 0:
            grad_norms = check.leaf_norms(program.first_moments(state), 1.0 / (1.0 - BETA1))
    w0 = weights.make_weights(spec_, ctx.seed, 0, ctx.device, ctx.held)
    params = dict(model.named_parameters())
    change_norms = check.leaf_norms({k: params[k].detach() - w0[k] for k in params})
    readings = {"losses": [float(v) for v in losses], "grad_norms": grad_norms, "change_norms": change_norms}
    return readings, state, step


def reference_readings(cell, ctx, batches: list, dtype=None) -> dict:
    """The reference's readings of the same steps from the same tensors and batches, in ``dtype`` (default: the
    held dtype)."""
    cfg, spec_ = cell.config, _spec(cell, ctx)
    dtype = dtype or ctx.held
    trainable = {k for k, (_, kind) in spec_.items() if kind != "nonneg"}
    w0 = weights.make_weights(spec_, ctx.seed, 0, ctx.device, dtype)
    batches = [{k: v.to(dtype) for k, v in b.items()} for b in batches]
    ref = ref_train.train_steps(ctx.reference.forward, w0, cfg["network_def"], batches, cfg["learning_rate"],
                                cfg["weight_decay"], trainable)
    return {"losses": ref["losses"], "grad_norms": check.leaf_norms(ref["first_grads"]),
            "change_norms": check.leaf_norms({k: v - w0[k] for k, v in ref["params"].items()})}


def run(cell, ctx) -> SimpleNamespace:
    tr, device = cell.traffic, ctx.device
    net, roi = cell.config["network_def"], tuple(tr["roi"])
    ring = traffic.train_ring(tr, net, ctx.seed, device, ctx.held)
    out = SimpleNamespace(kind="train", flops_unit=flops.train_step_flops(ctx.reference, net, tr["batch"], roi))
    out.prog, state, step = program_readings(cell, ctx, ring)
    cells.reset_peak(device)

    start = time.perf_counter()
    out.setup_s = start - ctx.t0
    i, window_losses = tr["checked_steps"], []
    while True:
        with trace.span("train.step"):
            state, m = step(state, ring[i % len(ring)])
        window_losses.append(m["loss"])
        i += 1
        if time.perf_counter() - start >= ctx.seconds:
            break
    cells.sync(device)
    out.window_s = time.perf_counter() - start
    out.units = len(window_losses)
    out.failed = int((~torch.isfinite(torch.stack(window_losses))).sum())

    if ctx.trace:
        def units():
            nonlocal state, i
            for _ in range(TRACED_UNITS):
                with trace.span("train.step"):
                    state, _m = step(state, ring[i % len(ring)])
                i += 1
        out.trace, out.launches = cells.traced(units, ctx)
        out.traced_units = TRACED_UNITS
    out.peak_bytes = cells.peak_bytes(device)
    del state, step, m
    cells.free_memory()

    t_ref = time.perf_counter()
    out.ref = reference_readings(cell, ctx, checked_batches(tr, ring))
    out.reference_s = time.perf_counter() - t_ref
    out.numbers = check.train_numbers(out.prog, out.ref)
    return out


# -- the readings that set the limits (port_bench/control.py)

def half_batches(batches: list) -> list:
    return [{k: v[: v.shape[0] // 2] for k, v in b.items()} for b in batches]


def readings(cell, ctx, do_program: bool, do_control: bool) -> dict:
    """name -> the numbers ``bench.check`` compares, against the reference: ``program`` (the lower readings);
    ``control`` (the reference put in the program's place at the configuration's ``precision.control``) and
    ``fault_half_batch`` (half of each batch left out, the mean taken over the rest, planted in the reference put
    in the program's place): the upper readings.  The fault "a step that returns its state unchanged" reads 1 in
    either change number by definition and needs no run."""
    ring = traffic.train_ring(cell.traffic, cell.config["network_def"], ctx.seed, ctx.device, ctx.held)
    batches = checked_batches(cell.traffic, ring)
    ref = reference_readings(cell, ctx, batches)
    out = {}
    if do_program:
        prog, state, step = program_readings(cell, ctx, ring)
        del state, step
        out["program"] = check.train_numbers(prog, ref)
    if do_control:
        with cells.precision(cell.config["precision"]["control"]) as dtype:
            out["control"] = check.train_numbers(reference_readings(cell, ctx, batches, dtype), ref)
        out["fault_half_batch"] = check.train_numbers(reference_readings(cell, ctx, half_batches(batches)), ref)
    return out


def look(cell, ctx) -> dict:
    """Where the program and the reference part over the checked steps, step by step.

    The program runs its steps, keeping its parameters before each and its first moments after each (the step's
    gradient is ``(m_k - beta1 m_{k-1}) / (1 - beta1)``).  The reference evaluates each step's loss and gradient
    twice: at the program's parameters before that step (the same state), and along its own AdamW trajectory from
    the same start (its own states).  Where the same-state gaps stay at the first step's, the program's step is the
    reference's step at every state, and what grows in the own-state gaps is the two trajectories parting: the
    cause lies in the later steps, not in the step's arithmetic.  Each step's row gives both losses' gaps, the worst
    leaf's gradient gap (as ``bench.check`` takes it) both ways, and the parameters' distance between the two
    trajectories after the step over the reference's change so far; the first step's row also counts the gradient
    entries whose signs differ, and how large the largest of them is against its leaf's root mean square."""
    cfg, tr, spec_ = cell.config, cell.traffic, _spec(cell, ctx)
    net, lr, wd = cfg["network_def"], cfg["learning_rate"], cfg["weight_decay"]
    ring = traffic.train_ring(tr, net, ctx.seed, ctx.device, ctx.held)
    batches = checked_batches(tr, ring)
    model = cells.program_network(cell, ctx, spec_, 0)
    state, step = program.train_state(model, lr, wd)
    before, grads, losses, m_prev = [], [], [], None
    for batch in batches:
        before.append({k: v.detach().clone() for k, v in model.named_parameters()})
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        m_now = {k: v.clone() for k, v in program.first_moments(state).items()}
        grads.append({k: (v - BETA1 * m_prev[k] if m_prev else v) / (1.0 - BETA1) for k, v in m_now.items()})
        m_prev = m_now
    after = {k: v.detach().clone() for k, v in model.named_parameters()}
    del state, step, model
    cells.free_memory()

    w0 = weights.make_weights(spec_, ctx.seed, 0, ctx.device, ctx.held)
    trainable = sorted(grads[0])

    def loss_and_grad(params: dict, batch: dict):
        leaves = {k: params[k].detach().clone().requires_grad_(True) for k in trainable}
        loss = ref_train.dice_ce_loss(ctx.reference.forward({**w0, **leaves}, batch["image"], net), batch["label"])
        return float(loss.detach()), dict(zip(trainable, torch.autograd.grad(loss, list(leaves.values()))))

    own = {k: w0[k].clone() for k in trainable}
    opt = ref_train.AdamW(own, lr, wd)
    rows = []
    for k, batch in enumerate(batches):
        loss_same, g_same = loss_and_grad(before[k], batch)
        loss_own, g_own = loss_and_grad(own, batch)
        opt.step(own, g_own)
        end = before[k + 1] if k + 1 < len(batches) else after
        moved = sum(float((own[n] - w0[n]).double().pow(2).sum()) for n in trainable) ** 0.5
        apart = sum(float((end[n] - own[n]).double().pow(2).sum()) for n in trainable) ** 0.5
        g_norms = check.leaf_norms(grads[k])
        row = {"step": k + 1, "loss_gap_same_state": abs(losses[k] - loss_same) / abs(loss_same),
               "loss_gap_own_states": abs(losses[k] - loss_own) / abs(loss_own),
               "grad_gap_same_state": check.worst_leaf(g_norms, check.leaf_norms(g_same), trainable),
               "grad_gap_own_states": check.worst_leaf(g_norms, check.leaf_norms(g_own), trainable),
               "params_apart_over_moved": apart / moved}
        if k == 0:
            flipped = {n: torch.sign(g_own[n]) != torch.sign(grads[0][n]) for n in trainable}
            row["flipped_entries"] = sum(int(f.sum()) for f in flipped.values())
            row["entries"] = sum(f.numel() for f in flipped.values())
            row["largest_flipped_over_leaf_rms"] = max(
                (float(g_own[n][f].abs().max()) / max(float(g_own[n].pow(2).mean().sqrt()), 1e-30)
                 for n, f in flipped.items() if f.any()), default=0.0)
        rows.append(row)
    return {"steps": rows}
