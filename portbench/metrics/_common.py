"""What the per-layer readers share: steps in the trace and the
yardstick's shares."""

from portbench import yardstick


def traced_steps(w):
    """Train steps the traced window holds."""
    if w.trace is None:
        return 0
    return w.trace.span_count("portbench.step")


def per_step_ms(w, span):
    n = traced_steps(w)
    return 1e3 * w.trace.span_s(span) / n if n else None


def entmax_share(w, pattern, passes):
    """% of the entmax kernels' device time per step that the bound of its
    passes ('fwd', 'bwd') at the configuration's shapes would take."""
    n = traced_steps(w)
    took = w.trace.kernel_s(pattern) / n if n else 0.0
    f, c = w.reference.entmax_shape(w.config)
    numel = w.rows_per_step * f * c
    alpha = w.config["alpha"]
    least = sum({"fwd": yardstick.entmax_fwd_bound_s,
                 "bwd": yardstick.entmax_bwd_bound_s}[p](numel, alpha)
                for p in passes)
    return yardstick.share(least, took)


def mfu(w, passes):
    """% of the devices' f32 peak that the model's product FLOPs (forward
    FLOPs per example times `passes`) at the traced window's rate take."""
    if w.trace is None or not w.trace.window_s:
        return None
    rate = traced_steps(w) * w.rows_per_step / w.trace.window_s
    flops = passes * w.reference.flops_per_example(w.config) * rate
    return 100.0 * flops / (yardstick.F32_FLOPS * w.cell.chips)


def idle_share(w):
    if w.trace is None or not w.trace.window_s:
        return None
    return 100.0 * (1.0 - w.trace.busy_s() / w.trace.window_s)
