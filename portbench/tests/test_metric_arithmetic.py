"""The metric readers' arithmetic on canned traces: the idle share from the
union of device intervals, launches per step, the rooflines from the
yardstick's bounds, mfu and the rate over the whole window; and, on a CPU
profile of each configuration's own train step, a count that differs
between the two configurations."""

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import conftest
from portbench import harness, spec, yardstick
from portbench.trace import Spans, Trace, from_profiler, gaps, union

MS = 1_000_000          # ns


def read(name, w):
    return spec.load_reader(name).read(w)


def window(cell_name, ops, steps, seconds=1.0, rows=65536):
    cell = conftest.cell(cell_name)
    spans = {"portbench.window": [(0, int(seconds * 1e9))],
             "portbench.step": [(i * MS, i * MS + 100) for i in range(steps)],
             "portbench.data": [(i * MS + 200, i * MS + 700)
                                for i in range(steps)]}
    trace = Trace(ops, spans, (0, int(seconds * 1e9)))
    return harness.Window(cell, steps, rows, seconds, 12.5, trace=trace)


def test_union_and_gaps():
    merged = union([(5, 20), (0, 10), (30, 40), (40, 45)])
    assert merged == [(0, 20), (30, 45)]
    assert gaps(merged, 0, 50) == [(20, 30), (45, 50)]
    assert gaps(merged, 2, 35) == [(20, 30)]


def test_idle_share_counts_overlaps_once_and_clips_to_the_window():
    ops = [("k", "kernel", 0, 100 * MS), ("k", "kernel", 50 * MS, 200 * MS),
           ("Memcpy HtoD", "gpu_memcpy", 150 * MS, 300 * MS),
           ("k", "kernel", 900 * MS, 1500 * MS)]
    w = window("cr_armnet1h.train", ops, steps=10)
    assert w.trace.busy_s() == pytest.approx(0.4)
    assert read("idle_share.train", w) == pytest.approx(60.0)
    # gaps named by the innermost span that holds their middle
    assert w.trace.idle_gaps(1) == [["none", pytest.approx(0.6)]]


def test_launches_per_step_count_kernels_only():
    ops = [("a", "kernel", i * MS, i * MS + 10) for i in range(30)]
    ops += [("Memset", "gpu_memset", 0, 5)]
    w = window("cr_armnet1h.train", ops, steps=10)
    assert read("launches_per_step.train", w) == pytest.approx(3.0)


def test_host_spans_per_step():
    w = window("cr_armnet1h.train", [("a", "kernel", 0, 1)], steps=4)
    assert read("data_wait_ms.train", w) == pytest.approx(0.0005)
    assert read("host_step_ms.train", w) == pytest.approx(0.0001)


@pytest.mark.parametrize("cell_name", ["cr_armnet1h.train",
                                       "cr_armnet.train"])
def test_entmax_roofline_is_bound_over_kernel_time(cell_name):
    cell = conftest.cell(cell_name)
    f, c = cell.reference.entmax_shape(cell.config)
    numel = 65536 * f * c
    least = sum({"fwd": yardstick.entmax_fwd_bound_s,
                 "bwd": yardstick.entmax_bwd_bound_s}[p](numel, 2.0)
                for p in ("fwd", "bwd"))
    took = int(2 * least * 1e9)            # each step twice its bound
    ops = [("void armnet::entmax_fwd_kernel<40, 0>(float const*)", "kernel",
            i * MS, i * MS + took) for i in range(5)]
    ops += [("sm80_xmma_gemm", "kernel", 0, 10 ** 9)]
    w = window(cell_name, ops, steps=5)
    assert read("entmax_roofline.train", w) == pytest.approx(50.0, rel=1e-6)


def test_table_grad_roofline():
    least = yardstick.table_grad_bound_s(2_100_000, 65536 * 39, 10)
    # the dense table (84 MB) written once dominates
    assert least == pytest.approx((4 * 65536 * 39 * 11 + 84e6) / 3.35e12)
    names = ["(anonymous namespace)::zero_kernel(float*, long, int*, int)",
             "void (anonymous namespace)::radix_count_kernel<int>(int)",
             "(anonymous namespace)::segment_kernel(float const*)"]
    each = int(least * 1e9 / 3 * 4)        # 4x the bound a step
    ops = [(n, "kernel", 0, each) for n in names]
    ops += [("at::native::zero_like_kernel", "kernel", 0, 10 ** 8)]
    w = window("cr_armnet1h.train", ops, steps=1)
    assert read("table_grad_roofline.train", w) == pytest.approx(25.0,
                                                                 rel=1e-4)


def test_mfu_from_the_reference_flops():
    cell = spec.load_cell("cr_armnet1h.train")
    flops = cell.reference.flops_per_example(cell.config)
    # products: keys 2*39*10*10, gates and cross 2*39*10*128 each, MLP
    assert flops == (7800 + 2 * 99840
                     + 2 * (1280 * 500 + 500 * 500 + 500))
    w = window("cr_armnet1h.train", [("a", "kernel", 0, 1)], steps=20,
               seconds=1.0)
    rate = 20 * 65536 / 1.0
    assert read("mfu.train", w) == pytest.approx(
        100 * 3 * flops * rate / 67e12)
    mh = spec.load_cell("cr_armnet.train")
    assert mh.reference.flops_per_example(mh.config) > flops


@pytest.mark.parametrize("metric", [
    "data_wait_ms.train", "host_step_ms.train", "launches_per_step.train",
    "entmax_roofline.train", "table_grad_roofline.train", "mfu.train",
    "idle_share.train"])
def test_untraced_window_gives_no_per_layer_number(metric):
    w = harness.Window(conftest.cell("cr_armnet1h.train"), 100, 65536, 2.0,
                       10.0)
    assert read(metric, w) is None


def test_rate_over_the_whole_window():
    w = harness.Window(conftest.cell("cr_armnet1h.train"), 100, 65536, 2.0,
                       10.0)
    assert read("train_examples_per_s", w) == pytest.approx(
        100 * 65536 / 2.0)
    assert read("setup_s", w) == 10.0


def _profiled_step_ops(cell):
    rows = harness.make_rows(cell.config, cell.traffic, 1, "cpu")
    session = harness.TrainSession(cell, 1, torch.device("cpu"), rows)
    session.first_steps()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        session.window(0.0, cell.traffic["report_every"])
    trace = from_profiler(prof, session.spans, device_type=DeviceType.CPU)
    return {n for n, _, _, _ in trace.kernels()}, len(trace.kernels())


def test_each_configuration_counts_its_own_operations(small_cell):
    """The launch count reads the trace's own operations: on a CPU profile
    of one step each, the multi-head model's count differs from the
    one-head model's."""
    _, n_one = _profiled_step_ops(small_cell("cr_armnet1h.train"))
    _, n_multi = _profiled_step_ops(small_cell("cr_armnet.train"))
    assert n_one != n_multi


def test_spans_keep_the_real_time_clock():
    spans = Spans()
    with spans("portbench.step"):
        pass
    (name, start, end), = spans.kept
    assert name == "portbench.step" and 0 <= end - start < 10 ** 9
    assert start > 1.7e18                  # ns since the epoch
