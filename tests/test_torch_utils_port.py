"""The port's small utilities against the JAX package's, on the CPU:

* ``ops.registry``: the process default reaches every kernel wrapper
  through ``kernels.common.resolve_impl``; ``"kernel"`` raises on a CPU
  tensor, as a per-call ``impl="kernel"`` does; ``"plain"`` reaches the
  plain route and, as a forced impl, keeps the fused ops off their
  composed route above 512 (JAX's ``"reference"`` default does the same);
* ``nn.tree_cast`` against JAX's on a tree with integer leaves;
* ``utils.roofline`` (``RooflinePoint``'s properties and summary, the byte
  counts) and ``utils.timing.attention_flops`` against JAX's values;
* ``PhaseTimer``, ``benchmark``, ``compare`` and ``checked`` on the CPU;
* ``utils.profiling.trace`` writing a Chrome-format trace that holds an
  ``annotate`` range;
* the MT app's ``--profile``: two iterations on the CPU write the trace
  under ``<workdir>/profile`` and print JAX's profile line."""

import glob
import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash import ops as jops
from tpu_flash.nn.module import tree_cast as jtree_cast
from tpu_flash.utils import roofline as jroof
from tpu_flash.utils import timing as jtiming
from tpu_flash_torch import nn as tnn
from tpu_flash_torch import ops as tops
from tpu_flash_torch import utils as tutils
from tpu_flash_torch.apps import machine_translation as tapp
from tpu_flash_torch.kernels import common
from tpu_flash_torch.utils import roofline as troof
from tpu_flash_torch.utils import timing as ttiming

torch.set_num_threads(1)


@pytest.fixture
def default_impl():
    """Restores the process default after a test that sets it."""
    yield tops.set_default_impl
    tops.set_default_impl(None)


def test_registry_surface_matches_jax(default_impl):
    assert tops.get_default_impl() is None
    assert callable(jops.set_default_impl) and callable(jops.get_default_impl)
    for impl in ("kernel", "plain", None):
        default_impl(impl)
        assert tops.get_default_impl() == impl
        assert tops.resolve_impl(None) == impl
        assert tops.resolve_impl("plain") == "plain"
    for bad in ("pallas", "cuda", ""):
        with pytest.raises(ValueError, match="impl must be one of"):
            default_impl(bad)
        with pytest.raises(ValueError, match="impl must be one of"):
            tops.resolve_impl(bad)


def test_default_kernel_raises_on_a_cpu_tensor(rng, default_impl):
    x = torch.from_numpy(rng.standard_normal((1, 2, 8, 16)).astype(
        np.float32))
    assert common.resolve_impl(None, x) == "plain"
    default_impl("kernel")
    assert common.resolve_impl("plain", x) == "plain"   # a call overrides
    for call in (lambda: common.resolve_impl(None, x),
                 lambda: tops.flash_attention(x, x, x, causal=True),
                 lambda: tops.attn_softmax(x),
                 lambda: tops.layer_norm(x, torch.ones(16), torch.zeros(16))):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            call()
    out = tops.flash_attention(x, x, x, causal=True, impl="plain")
    assert torch.isfinite(out).all()


def test_default_plain_reaches_the_plain_route(rng, default_impl,
                                               monkeypatch):
    """Above 512 an unforced call takes the composed fp32 route (an fp32
    result from bf16 scores); under the ``"plain"`` default it stays on
    the kernel route's plain version, in bf16."""
    from tpu_flash_torch.ops import fused

    x = torch.from_numpy(rng.standard_normal((1, 1, 2, 640)).astype(
        np.float32)).to(torch.bfloat16)
    assert tops.attn_softmax(x).dtype == torch.float32
    calls = []
    real = fused.attn_softmax_forward
    monkeypatch.setattr(fused, "attn_softmax_forward",
                        lambda *a, **k: calls.append(k["impl"]) or real(*a,
                                                                        **k))
    default_impl("plain")
    y = tops.attn_softmax(x)
    assert y.dtype == torch.bfloat16 and calls == ["plain"]
    np.testing.assert_allclose(
        y.float().numpy(),
        torch.softmax(x.float(), -1).numpy(), atol=1e-2)


def test_tree_cast_matches_jax(rng):
    a = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    codes = rng.integers(-128, 128, (4, 6)).astype(np.int8)
    step = np.int32(7)
    jt = {"l": {"weight": jnp.asarray(a), "codes": jnp.asarray(codes)},
          "m": [jnp.asarray(b), jnp.asarray(step)]}
    tt = {"l": {"weight": torch.from_numpy(a),
                "codes": torch.from_numpy(codes)},
          "m": [torch.from_numpy(b), torch.tensor(step)]}
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float16, torch.float16)):
        want = jtree_cast(jt, jdt)
        got = tnn.tree_cast(tt, tdt)
        pairs = [(got["l"]["weight"], want["l"]["weight"]),
                 (got["l"]["codes"], want["l"]["codes"]),
                 (got["m"][0], want["m"][0]), (got["m"][1], want["m"][1])]
        for g, w in pairs:
            assert str(g.dtype).split(".")[1] == str(w.dtype)
            np.testing.assert_array_equal(
                g.float().numpy() if g.is_floating_point() else g.numpy(),
                np.asarray(w, np.float32) if g.is_floating_point()
                else np.asarray(w))
    # an optimizer state: the step count stays int32
    state = tnn.adam().init({"w": torch.from_numpy(a)})
    cast = tnn.tree_cast(state, torch.bfloat16)
    assert cast.step.dtype == torch.int32
    assert cast.exp_avg["w"].dtype == torch.bfloat16


def test_roofline_matches_jax():
    jceil = jroof.Ceiling("h100", tflops=989.0, gbs=3350.0)
    assert (troof.H100_SXM5.tflops, troof.H100_SXM5.gbs) == (989.0, 3350.0)
    assert troof.H100_SXM5_X6.tflops == 989.0 / 6
    assert troof.H100_SXM5_X3.tflops == 989.0 / 3
    cases = [(0.12514, jtiming.attention_flops(4, 8, 2048, 64, causal=True),
              jroof.attention_bytes(4, 8, 2048, 64)),
             (0.010468, 1e6, jroof.decode_attention_bytes(
                 8, 16, 1024, 64, cache_bytes=1, scale_heads=16)),
             (0.5, 1e12, 1e6), (1.0, 1e6, 1e10), (0.0, 1e9, 1e9)]
    for ms, flops, nbytes in cases:
        want = jroof.roofline(ms, flops, nbytes, jceil)
        got = troof.roofline(ms, flops, nbytes,
                             troof.Ceiling("h100", 989.0, 3350.0))
        for attr in ("ideal_ms", "fraction", "bound"):
            assert getattr(got, attr) == pytest.approx(getattr(want, attr),
                                                       rel=1e-12)
        if ms > 0:
            assert got.summary() == want.summary()
    # the default ceiling is the H100's; PERF.md's row 1 share
    p = troof.roofline(0.12514,
                       ttiming.attention_flops(4, 8, 2048, 64, causal=True),
                       troof.attention_bytes(4, 8, 2048, 64))
    assert p.ceiling == troof.H100_SXM5 and p.bound == "compute"
    assert p.fraction == pytest.approx(0.01737 / 0.12514, rel=1e-3)


@pytest.mark.parametrize("kw", [dict(), dict(dtype_bytes=4),
                                dict(fwd_and_bwd=True)])
def test_byte_and_flop_counts_match_jax(kw):
    for B, H, L, d in ((1, 1, 1, 1), (4, 8, 2048, 64), (2, 16, 777, 128)):
        assert troof.attention_bytes(B, H, L, d, **kw) == \
            jroof.attention_bytes(B, H, L, d, **kw)
        for causal in (False, True):
            fb = dict(fwd_and_bwd=kw.get("fwd_and_bwd", False))
            assert ttiming.attention_flops(B, H, L, d, causal=causal,
                                           **fb) == \
                jtiming.attention_flops(B, H, L, d, causal=causal, **fb)
    for args, kwargs in (((8, 16, 8192, 64), dict()),
                         ((8, 16, 1024, 64), dict(cache_bytes=1,
                                                  scale_heads=16))):
        assert troof.decode_attention_bytes(*args, **kwargs) == \
            jroof.decode_attention_bytes(*args, **kwargs)
    for wb in (1, 0.5, 2):
        assert troof.weight_matmul_bytes(8, 1024, 4096, weight_bytes=wb) == \
            jroof.weight_matmul_bytes(8, 1024, 4096, weight_bytes=wb)


def test_phase_timer_benchmark_and_compare_on_the_cpu():
    timer = tutils.PhaseTimer()
    x = torch.ones(64, 64)
    with timer.phase("sleep", out=x):
        time.sleep(0.01)
    y = timer.measure("matmul", torch.matmul, x, x)
    assert torch.equal(y, x @ x)
    assert timer.counts == {"sleep": 1, "matmul": 1}
    assert timer.summary()["sleep"] >= 0.01
    assert "sleep: " in timer.report() and "ms/call" in timer.report()

    r = tutils.benchmark(lambda a: time.sleep(0.002) or a, x, iters=3,
                         repeats=2, warmup=1, name="nap", flops=2e9)
    assert isinstance(r, ttiming.BenchResult) and r.iters == 3
    assert 2.0 <= r.mean_ms < 50.0
    assert r.tflops == pytest.approx(2e9 / (r.mean_ms * 1e-3) / 1e12)
    assert str(r).startswith("nap: ") and "TFLOP/s" in str(r)
    fast, slow, speedup = tutils.compare(lambda a: a, lambda a: (
        time.sleep(0.003), a)[1], {"x": [x]}, iters=2)
    assert (fast.name, slow.name) == ("custom", "baseline")
    assert speedup == pytest.approx(slow.mean_ms / fast.mean_ms)
    assert speedup > 1.0


def test_checked_raises_on_a_non_finite_output():
    f = tutils.checked(lambda a: {"y": a * 2.0, "n": a.long(),
                                  "z": [torch.log(a)]})
    out = f(torch.tensor([1.0, 2.0]))
    assert torch.equal(out["y"], torch.tensor([2.0, 4.0]))
    with pytest.raises(FloatingPointError, match="output 1 of 2"):
        f(torch.tensor([1.0, -2.0]))          # log(-2) is NaN
    with pytest.raises(FloatingPointError, match="output 0 of 2"):
        f(torch.tensor([float("inf"), 2.0]))
    assert torch.equal(tutils.checked(torch.argmax)(torch.tensor([1, 3])),
                       torch.tensor(1))       # no floating output


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "profile"
    with tutils.trace(str(logdir)) as path:
        with tutils.annotate("port_region"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    assert os.path.dirname(path) == str(logdir) and os.path.isfile(path)
    assert path.endswith(".pt.trace.json")
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "port_region" in names


def test_mt_profile_writes_its_trace(tmp_path, capsys):
    out = tapp.main(["--dataset", "local", "--max-iters-per-epoch", "2",
                     "--samples-per-epoch", "32", "--batch-size", "8",
                     "--model-max-length", "24", "--n-vocab", "300",
                     "--n-embd", "32", "--n-head", "2", "--n-layer", "1",
                     "--checkpoint-every", "0", "--skip-bleu", "--n-epochs",
                     "1", "--profile", "--workdir", str(tmp_path)],
                    device="cpu")
    assert [r["epoch"] for r in out["epochs"]] == [0]
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{"profile"')]
    assert lines == [{"profile": "tracing epoch 0 -> workdir/profile"}]
    (path,) = glob.glob(str(tmp_path / "profile" / "*.pt.trace.json"))
    events = json.load(open(path))["traceEvents"]
    assert any("addmm" in e.get("name", "") or "mm" in e.get("name", "")
               for e in events)
