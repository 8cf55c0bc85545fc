"""A cell at a size the CPU runs in seconds: the drivers, the program's
plain paths and the reference, end to end, with ``device="cpu"``."""

from __future__ import annotations

import copy

import torch

from port_bench.harness import Run
from port_bench.spec import load_json, shape_of

CONFIG = dict(load_json("configs/starcoderbase-1b.json"), n_embd=64,
              n_head=4, n_inner=256, n_layer=2, n_positions=512,
              vocab_size=256)
MHA = dict(CONFIG, multi_query=False)
TRAFFIC = {
    "train-b1-l8192": dict(batch=1, seq_len=64),
    "code-saturated": dict(queue_depth=8, pool=16, slots=4, max_len=256,
                           prefill_chunk=32, warmup_prompts=[70],
                           prompt=dict(dist="log_normal", median=40,
                                       sigma=0.8, lo=8, hi=96),
                           max_new_tokens=16, check_requests=8),
}
LIMITS = dict(grad_gap=8e-3, change_gap=1.4e-2, grad_dist=3e-2, token_gap=5e-3)


def tiny_run(traffic: str, *, mha: bool = False, seed: int = 7,
             seconds: float = 1.0, device: str = "cpu") -> Run:
    cfg = copy.deepcopy(MHA if mha else CONFIG)
    tr = dict(load_json(f"traffic/{traffic}.json"), **TRAFFIC[traffic])
    return Run(workload=dict(name=f"tiny-{traffic}", chips=1), config=cfg,
               traffic=tr, limits=dict(LIMITS), shape=shape_of(cfg),
               seed=seed, seconds=seconds, trace=False,
               device=torch.device(device))


def drive(run: Run) -> Run:
    import importlib

    importlib.import_module(
        f"port_bench.drivers.{run.traffic['driver']}").run(run)
    return run
