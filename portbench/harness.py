"""One run of one cell: set-up from the seed, the measured window, the
check against the plain reference, and the numbers for the result line.

The traffic (its file's `kind` is `train`) drives the program's train
step (armnet_tpu_torch.train.step.make_train_step, dense Adam, the clamp)
over its BatchIterator, shuffled each epoch with the lookahead on the
card, the meters read every `report_every` batches of an epoch and at its
end, as the trainer's run_epoch reads them. Set-up drives the step
through its first `check_steps` steps on the feed's first rows; the
window goes on with the same objects.

The weights and the rows are made here from the seed and handed to the
program and, after the window, to the reference. The reference works out
the first steps again and the gaps are held to the cell's limits.
"""

import gc
import math
import os
import statistics
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from armnet_tpu_torch import set_matmul_precision
from armnet_tpu_torch.data.libsvm import BatchIterator
from armnet_tpu_torch.models import (ModelConfig, create_model,
                                     param_transform_for)
from armnet_tpu_torch.train.step import (create_train_state, init_meters,
                                         make_train_step)
from portbench import gen
from portbench import trace as tracing
from portbench.reference import common as ref

__all__ = ["Rows", "Window", "process_age_s", "draw_weights", "build_model",
           "TrainSession", "train_reference", "train_numbers", "run",
           "CONTROLS", "PROFILE_TRIES"]

# a profiler session now and then records no device event at all; the
# window is then run once more under a new session
PROFILE_TRIES = 2
BETA1 = 0.9
# the program's switch for each control precision: (matmul precision,
# activation dtype)
CONTROLS = {None: (None, torch.float32), "tf32": ("high", torch.float32),
            "bf16": (None, torch.bfloat16)}


def process_age_s():
    """Seconds since this process started (Linux: /proc/self/stat)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def note(what):
    """A line on stderr: what the run has done, at which process age."""
    print(f"portbench: {what} at {process_age_s():.3f} s", file=sys.stderr,
          flush=True)


class Rows:
    """The host dataset the program's BatchIterator reads: ids [N, F]
    int32, values [N, F] float32, labels [N] float32 (numpy)."""

    def __init__(self, ids, values, labels):
        self.ids, self.values, self.labels = ids, values, labels
        self.nfield = ids.shape[1]

    def __len__(self):
        return self.labels.shape[0]

    def batch(self, rows, device):
        """The rows at `rows` as the reference's batch on `device`."""
        return {"id": torch.from_numpy(self.ids[rows]).to(device),
                "value": torch.from_numpy(self.values[rows]).to(device),
                "y": torch.from_numpy(self.labels[rows]).to(device)}


def make_rows(cfg, traffic, seed, device):
    """The traffic's rows, made on `device` and copied once to the host."""
    ids, values, labels = gen.make_rows(cfg, traffic, seed, device)
    rows = Rows(ids.cpu().numpy(), values.cpu().numpy(),
                labels.cpu().numpy())
    del ids, values, labels
    return rows


def draw_weights(cell, seed, device):
    """{leaf: tensor} of the configuration's weights from the seed, with the
    traffic's `weight_scale` (leaf -> factor on its uniform bound)."""
    scale = cell.traffic.get("weight_scale", {})
    specs = [(n, s, k, a * scale.get(n, 1.0) if k == "uniform" else a)
             for n, s, k, a in cell.reference.specs(cell.config)]
    return ref.draw_params(specs, gen.stream_seed(seed, 2), device)


def trainable(cell):
    return [n for n, _, k, _ in cell.reference.specs(cell.config)
            if k != "buffer"]


def build_model(cell, weights, device, dtype=torch.float32):
    """The program's model of the configuration with `weights` copied into
    every leaf of its state dict (which must name the same leaves)."""
    cfg = cell.config
    fields = ModelConfig.__dataclass_fields__
    model = create_model(ModelConfig(**{k: v for k, v in cfg.items()
                                        if k in fields}),
                         device=device, kernels=cfg["kernels"], dtype=dtype)
    own = model.state_dict(keep_vars=True)
    if set(own) != set(weights):
        raise ValueError(f"the program's leaves {sorted(own)} are not the "
                         f"reference's {sorted(weights)}")
    with torch.no_grad():
        for name, t in own.items():
            t.copy_(weights[name])
    return model


def _endless(iterator):
    """(epoch, index in the epoch, batch), epoch after epoch."""
    epoch = 0
    while True:
        for i, batch in enumerate(iterator):
            yield epoch, i, batch
        epoch += 1


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _fetch(meters):
    """The meters on the host, as run_epoch reads them."""
    return {k: float(v) for k, v in meters.items()}


def _norms(tensors):
    return {k: float(torch.linalg.vector_norm(v.float()))
            for k, v in tensors.items()}


class TrainSession:
    """The program's training objects of one run: the model with the
    seed's weights, its TrainState and train step, and the feed (the
    BatchIterator, shuffled, on the card). `first_steps()` drives them
    through the check's steps and keeps what the check compares."""

    def __init__(self, cell, seed, device, rows, control=None, hooks=None):
        precision, dtype = CONTROLS[control]
        cfg, traffic = cell.config, cell.traffic
        if traffic["check_steps"] * traffic["batch"] > len(rows):
            raise ValueError("the check's first steps must lie in the first "
                             "epoch: rows < check_steps x batch")
        set_matmul_precision(precision or cfg["matmul_precision"])
        self.cell, self.device = cell, device
        self.batch = traffic["batch"]
        self.iter_seed = int(seed) % (2 ** 31)
        weights = draw_weights(cell, seed, device)
        self.model = build_model(cell, weights, device, dtype)
        names = trainable(cell)
        self.start = {n: weights[n] for n in names}
        self.state = create_train_state(self.model, cfg["lr"])
        generator = torch.Generator(device).manual_seed(self.iter_seed + 7)
        self.step = make_train_step(
            "binary", cfg["clip"], generator,
            param_transform=param_transform_for(cfg["model"]))
        if hooks and "step" in hooks:
            self.step = hooks["step"](self.step, self)
        self.iterator = BatchIterator(rows, self.batch, shuffle=True,
                                      seed=self.iter_seed, device=device)
        self.feed = _endless(self.iterator)
        self.meters = init_meters(device)
        self.epoch = 0
        self.spans = tracing.Spans()

    def named(self):
        return dict(self.model.named_parameters())

    def first_steps(self):
        """Run the check's steps; return the program's readings: the loss
        and AUC meter of each step, the first step's logits as the model
        returned them, the norm of each leaf's first gradient as Adam got
        it (its first moment after one step over 1 - beta1), and the norm
        of each leaf's change after the steps."""
        n = self.cell.traffic["check_steps"]
        losses, aucs, grad, logits = [], [], None, []
        hook = self.model.register_forward_hook(
            lambda module, args, out: logits.append(out.detach().float()))
        for k in range(n):
            _, _, batch = next(self.feed)
            self.meters = self.step(self.state, self.meters, batch)
            m = _fetch(self.meters)
            losses.append(m["loss_last"])
            aucs.append(m["auc_last"])
            if k == 0:
                hook.remove()
                grad = {name: float(torch.linalg.vector_norm(
                    self.state.optimizer.state[p]["exp_avg"])) / (1 - BETA1)
                    if p in self.state.optimizer.state else 0.0
                    for name, p in self.named().items()}
        params = self.named()
        change = _norms({k: params[k].detach() - v
                         for k, v in self.start.items()})
        self.start = None
        return {"loss": losses, "auc": aucs, "logits": logits[0],
                "grad": grad, "change": change}

    def window(self, seconds, report_every):
        """Train for `seconds` (host clock) from the next batch on; return
        (steps, seconds the window took)."""
        dev, span = self.device, self.spans
        steps = 0
        _sync(dev)
        t0 = time.perf_counter()
        with span(tracing.WINDOW_SPAN):
            while True:
                with span("portbench.data"):
                    epoch, i, batch = next(self.feed)
                if epoch != self.epoch:
                    with span("portbench.sync"):
                        _fetch(self.meters)           # the epoch's summary
                    self.meters, self.epoch = init_meters(dev), epoch
                with span("portbench.step"):
                    self.meters = self.step(self.state, self.meters, batch)
                steps += 1
                if i % report_every == 0:
                    with span("portbench.sync"):
                        _fetch(self.meters)
                if time.perf_counter() - t0 >= seconds:
                    break
            with span("portbench.sync"):
                _sync(dev)
        return steps, time.perf_counter() - t0

    def close(self):
        self.feed.close()
        self.model = self.state = self.step = self.feed = None
        self.iterator = None


def train_reference(cell, seed, rows, device, order):
    """The reference's readings of the check's steps on the rows `order`
    (the program's first epoch order, batch after batch), with the same
    keys as TrainSession.first_steps."""
    cfg, traffic = cell.config, cell.traffic
    b = traffic["batch"]
    with ref.no_tf32():
        p = draw_weights(cell, seed, device)
        names = trainable(cell)
        start = {n: p[n].clone() for n in names}
        for n in names:
            p[n].requires_grad_(True)
        opt = ref.Adam({n: p[n] for n in names}, cfg["lr"])
        losses, aucs, grad, first = [], [], None, None
        for k in range(traffic["check_steps"]):
            batch = rows.batch(order[k * b:(k + 1) * b], device)
            logits = cell.reference.forward(cfg, p, batch["id"],
                                            batch["value"], train=True)
            loss = ref.bce(logits, batch["y"])
            grads = dict(zip(names, torch.autograd.grad(
                loss, [p[n] for n in names])))
            losses.append(float(loss.detach()))
            aucs.append(ref.roc_auc(logits.detach(), batch["y"]))
            ref.clamp_(grads, cfg["clip"])
            if k == 0:
                grad = _norms(grads)
                first = logits.detach()
            opt.step(p, grads)
            del grads, logits, loss
        change = _norms({n: p[n].detach() - start[n] for n in names})
    return {"loss": losses, "auc": aucs, "logits": first, "grad": grad,
            "change": change}


def _worst(values):
    """The largest of `values`, or NaN where one is NaN (max() would skip
    it)."""
    values = list(values)
    return math.nan if any(math.isnan(v) for v in values) else max(values)


def _median(values):
    values = list(values)
    return (math.nan if any(math.isnan(v) for v in values)
            else statistics.median(values))


def _rel_gap(prog, refr):
    """||prog - ref|| / ||ref|| of two tensors of answers; inf where the
    program gave another number of answers."""
    prog, refr = prog.reshape(-1), refr.reshape(-1).to(prog)
    if prog.numel() != refr.numel():
        return math.inf
    return float(torch.linalg.vector_norm(prog - refr)
                 / torch.linalg.vector_norm(refr))


def _leaf_gaps(prog, refr, leaves):
    """{leaf: |prog - ref| / max(ref, the median leaf's ref)}."""
    med = statistics.median(refr[k] for k in leaves)
    return {k: abs(prog[k] - refr[k]) / max(refr[k], med, 1e-30)
            for k in leaves}


def train_numbers(prog, refr):
    """The numbers compared in a train cell (gaps between the program's
    readings and the reference's), the leaves left out of the change (those
    whose reference gradient is under a thousandth of the median leaf's:
    nought to rounding, so Adam moves them by round-off alone), and the
    worst leaves. A leaf's gap is taken against the larger of its reference
    norm and the median leaf's.

    `logit_gap` holds the first step's logits, every row of the batch, to
    the reference's by the norm of their difference over the reference's:
    steadier from seed to seed than a median of leaves, it parts the
    lower-precision paths from the program by a wide margin.

    The first gradient gives two numbers. `grad_gap_median`, the median
    leaf's gap: the worst leaf is always one of the gates' two small leaves
    (bilinear_w, query), whose gradient crosses entmax's support, where one
    ulp of a gate moves an entry in or out and swings that leaf's gap 10x
    from seed to seed (its gap is kept in `worst`). `nought_grad_gap`, the
    worst gap among the leaves left out: their gradients cancel to
    rounding (a BatchNorm downstream takes out what they add), and lower
    precision in the products before that BatchNorm leaves them a gradient
    hundreds of times larger."""
    med = statistics.median(refr["grad"].values())
    moved = [k for k, g in refr["grad"].items() if g >= 1e-3 * med]
    left_out = sorted(set(refr["grad"]) - set(moved))
    grad = _leaf_gaps(prog["grad"], refr["grad"], list(refr["grad"]))
    change = _leaf_gaps(prog["change"], refr["change"], moved)
    numbers = {
        "loss_gap": _worst(abs(a - b) / abs(b)
                           for a, b in zip(prog["loss"], refr["loss"])),
        "auc_gap": _worst(abs(a - b)
                          for a, b in zip(prog["auc"], refr["auc"])),
        "logit_gap": _rel_gap(prog["logits"], refr["logits"]),
        "grad_gap_median": _median(grad.values()),
        "change_gap": _worst(change.values()),
    }
    if left_out:
        numbers["nought_grad_gap"] = _worst(grad[k] for k in left_out)
    worst = {"grad": max(grad, key=grad.get),
             "grad_gap": max(grad.values()),
             "change": max(change, key=change.get)}
    return numbers, left_out, worst


class Window:
    """What a run measured, for the metric readers: the cell (config,
    traffic, reference), `steps` (train steps completed in the window),
    `rows_per_step`, `seconds` (host clock), `setup_s`, and `trace` (a
    trace.Trace in a traced run, else None)."""

    def __init__(self, cell, steps, rows_per_step, seconds, setup_s,
                 trace=None):
        self.cell, self.config, self.traffic = cell, cell.config, cell.traffic
        self.reference = cell.reference
        self.steps, self.rows_per_step = steps, rows_per_step
        self.seconds, self.setup_s = seconds, setup_s
        self.trace = trace
        self.busy_s = trace.busy_s() if trace is not None else None

    @property
    def rows_per_s(self):
        return self.steps * self.rows_per_step / self.seconds


class _Profiled:
    """Runs window() under a torch.profiler session of CUDA activity;
    keeps the Trace of the device's operations and the run's `spans`."""

    def __init__(self, enabled, spans):
        self.enabled, self.spans, self.trace = enabled, spans, None

    def __call__(self, window):
        if not self.enabled:
            return window()
        for _ in range(PROFILE_TRIES):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = window()
            self.trace = tracing.from_profiler(prof, self.spans)
            if self.trace is not None:
                first = min(s for _, _, s, _ in self.trace.ops)
                note(f"trace of {len(self.trace.ops)} device operations, the "
                     f"first {(first - self.trace.window[0]) / 1e6:.3f} ms "
                     f"after the window opened")
                return out
        return out


def _train_run(cell, seed, seconds, traced, device, hooks, control):
    rows = make_rows(cell.config, cell.traffic, seed, device)
    note(f"{len(rows)} rows made")
    session = TrainSession(cell, seed, device, rows, control, hooks)
    note("model built")
    prog = session.first_steps()
    note(f"{len(prog['loss'])} first steps taken")
    report = cell.traffic["report_every"]
    profiled = _Profiled(traced, session.spans)
    setup_s = process_age_s()
    steps, secs = profiled(lambda: session.window(seconds, report))
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    note(f"window of {steps} steps closed; host ms a step: "
         f"{_span_summary(session.spans, steps)}")
    w = Window(cell, steps, cell.traffic["batch"], secs, setup_s,
               trace=profiled.trace)
    order = gen.epoch_order(len(rows), session.iter_seed, 0)
    session.close()
    del session
    _free(device)
    refr = train_reference(cell, seed, rows, device, order)
    numbers, left_out, worst = train_numbers(prog, refr)
    note(f"reference done; worst leaves {worst}; left out of the change "
         f"{left_out}")
    return w, numbers, peak


def _span_summary(spans, steps):
    """{span: host ms per step} of the spans the window kept."""
    out = {}
    for name, s, e in spans.kept:
        if name != tracing.WINDOW_SPAN:
            out[name] = out.get(name, 0.0) + (e - s) / 1e6
    return {k: round(v / max(steps, 1), 3) for k, v in sorted(out.items())}


def _free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(cell, seed, seconds, traced, device, hooks=None, control=None):
    """(Window, numbers compared, memory peak bytes) of one run.
    `hooks` break the program underneath (tests of the check); `control`
    ('tf32', 'bf16') runs the program's own lower-precision path."""
    if cell.traffic["kind"] != "train":
        raise ValueError(f"no harness for traffic of kind "
                         f"{cell.traffic['kind']!r}")
    return _train_run(cell, seed, seconds, traced, torch.device(device),
                      hooks, control)


def finite(x):
    return isinstance(x, (int, float)) and math.isfinite(x)
