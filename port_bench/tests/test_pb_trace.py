"""The reduction of a profiler trace: the device's busy time is the union
of its operations inside the traced window, the idle gaps are named by the
innermost span and host operation that hold them, and the metric readers
return nothing where no kernel of theirs ran."""

import pytest

from port_bench import trace
from port_bench.metrics import decode_roofline, flash_roofline, idle_share
from port_bench.tests.tiny import tiny_run


def ev(name, cat, ts, dur):
    return dict(name=name, cat=cat, ph="X", ts=ts, dur=dur)


EVENTS = [
    ev("pb.window", "user_annotation", 0, 1000),
    ev("pb.step", "user_annotation", 100, 800),
    ev("aten::mm", "cpu_op", 120, 50),
    ev("aten::item", "cpu_op", 600, 300),
    ev("flash_decode_kernel<64>", "kernel", 200, 100),
    ev("flash_decode_kernel<64>", "kernel", 250, 100),   # overlaps
    ev("gemm", "kernel", 400, 100),
    ev("Memcpy DtoH", "gpu_memcpy", 950, 100),           # runs past the end
    ev("gemm", "gpu_user_annotation", 0, 1000),          # not device work
]


def test_busy_idle_and_names():
    r = trace.reduce(EVENTS)
    assert r["window_s"] == pytest.approx(1e-3)
    # [200, 350] + [400, 500] + [950, 1000]
    assert r["busy_s"] == pytest.approx(300e-6)
    assert r["kernels"]["flash_decode_kernel<64>"] == pytest.approx(200e-6)
    gaps = r["breakdown"]["idle_gaps"]
    assert gaps[0] == ["pb.step/aten::item", pytest.approx(450e-6)]
    assert gaps[1] == ["pb.step", pytest.approx(200e-6)]
    assert gaps[2] == ["pb.step", pytest.approx(50e-6)]
    assert r["breakdown"]["device_ops"][0][0] == "flash_decode_kernel<64>"


def test_a_trace_without_device_work_is_refused():
    with pytest.raises(RuntimeError):
        trace.reduce(EVENTS[:4])


def test_readers_return_nothing_without_their_kernels():
    run = tiny_run("train-b1-l8192")
    run.traced = trace.reduce(EVENTS)
    run.counters.update(traced_steps=1, decode_bytes=1e6)
    assert flash_roofline.read(run) is None          # no flash_attention_*
    assert decode_roofline.read(run) == pytest.approx(
        100 * 1e6 / 3.35e12 / 200e-6)
    assert idle_share.read(run) == pytest.approx(70.0)
    run.traced = None
    assert decode_roofline.read(run) is None and idle_share.read(run) is None


class FakeTracer:
    """The profiler's part in a traced run, without the profiler."""

    def __init__(self, *args):
        self.prof, self.result, self.t0 = None, None, 0.0

    @property
    def active(self):
        return self.prof is not None

    def elapsed(self):
        import time

        return time.perf_counter() - self.t0

    def start(self):
        import time

        self.prof, self.t0 = object(), time.perf_counter()

    def stop(self):
        self.prof = None
        self.result = dict(window_s=1.0, busy_s=0.5, kernels={},
                           breakdown=dict(device_ops=[], idle_gaps=[]))


def test_decode_steps_start_and_stop_the_trace(monkeypatch):
    """A turn of the engine's loop can outlast the trace's start (one
    admission pass takes many long prompts): the decode steps inside it
    tick the trace, not only the driver's loop between turns."""
    from port_bench.drivers import _serve
    from port_bench.tests.tiny import drive

    monkeypatch.setattr(_serve, "Tracer", FakeTracer)
    monkeypatch.setattr(_serve.TracedPart, "tick",
                        _only_from_steps(_serve.TracedPart.tick))
    run = tiny_run("code-saturated", seconds=2.0)
    run.trace = True
    run.traffic.update(trace_s=0.2)
    monkeypatch.setattr(_serve, "LEAD_S", 0.5)
    drive(run)
    assert run.traced is not None
    assert 0.0 < run.counters["window_s"] < run.seconds
    assert run.counters["decode_bytes"] > 0
    assert run.correct, run.checks


def _only_from_steps(tick):
    """``TracedPart.tick`` answering only the calls that come from a
    decode step, as when every turn outlasts the trace's start."""
    import inspect

    def only(self, now):
        if inspect.stack()[1].function == "<lambda>":
            tick(self, now)

    return only
