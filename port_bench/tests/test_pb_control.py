"""The control must come out not correct where the program comes out
correct: the reference in float8_e4m3fn in the program's place, and for a
training cell the fault of half the batch left out, held by the same
numbers and limits as the program.  At the cells' own sizes this is
``python3 -m port_bench.control`` on the card; here at a size a test run
holds, on the CPU and (marked ``cuda``) on the card."""

import pytest
import torch

from port_bench import control
from port_bench.tests.tiny import LIMITS, drive, tiny_run

SEEDS = (7, 8, 9)


def _fails(numbers: dict) -> bool:
    return any(numbers[k] > LIMITS[k] for k in LIMITS if k in numbers)


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return name


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("seed", SEEDS)
def test_training_control_and_half_batch_fail(device, seed):
    device = _device(device)
    run = drive(tiny_run("train-b1-l8192", seed=seed, device=device))
    prog = {k: c["value"] for k, c in run.checks.items()}
    got = control.train_readings(tiny_run("train-b1-l8192", seed=seed,
                                          device=device))
    if device == "cpu":      # the tiny limits were read from these seeds
        assert run.correct, prog
        assert _fails(got["control_fp8"]), got
        assert _fails(got["half_batch"]), got
    keys = ("grad_gap", "change_gap", "grad_dist")
    assert any(got["control_fp8"][k] > prog[k] for k in keys), (prog, got)
    assert any(got["half_batch"][k] > 10 * prog[k] for k in keys), (prog, got)


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("seed", SEEDS)
def test_serving_control_fails(device, seed):
    device = _device(device)
    got = control.serve_readings(tiny_run("code-saturated", seed=seed,
                                          device=device))
    assert got["program"] < got["control_fp8"], got
    if device == "cpu":
        assert got["program"] <= LIMITS["token_gap"] < got["control_fp8"], got
