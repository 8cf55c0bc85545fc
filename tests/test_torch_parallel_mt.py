"""The MT app on a mesh: each mesh flag through ``main()`` on 4 gloo ranks
(``--dp 4``, ``--tp 4``, ``--dcn-data 2 --tp 2``, ``--zero1 --dp 4`` with
and without ``--mixed-precision``, ``--sequence-parallel --dp 2 --tp 2``,
and a ZeRO-1 resume from the checkpoint the mesh wrote), from the JAX app's
initial parameters.  Each mesh's step and epoch losses are held against the
JAX app's ``main()`` on the same flags on its 8-device CPU mesh (1e-5), and
against the port's single-process ``main()`` on the same flags otherwise;
rank 0 alone writes; and ``ctx=`` on ``train_epoch``, ``evaluate_loss`` and
``generate_translations`` against the same calls without one.

The two apps draw their epoch's order from different generators (JAX's
from the epoch key, the port's from an integer seed): the JAX app is given
the training examples reordered so that its own draw takes the port's
batches, and nothing else of it changes.  ``--zero1 --mixed-precision``
is held against the single-process port only: the JAX app's own run of it
stops on its CPU mesh ("Attempt to donate the same buffer twice" from its
ZeRO-1 step's first call).  Dropout is
off, since the port's ``p_dropout`` masks come from a torch generator on
each rank's local shapes."""

import json
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from tpu_flash import nn as jnn
from tpu_flash.apps import machine_translation as japp
from tpu_flash_torch import nn as tnn
from tpu_flash_torch.apps import machine_translation as tapp
from tpu_flash_torch.parallel import dryrun
from tpu_flash_torch.utils.checkpoint import list_checkpoints

torch.set_num_threads(1)

BASE = ["--dataset", "local", "--max-iters-per-epoch", "3",
        "--samples-per-epoch", "64", "--batch-size", "8",
        "--model-max-length", "24", "--n-vocab", "300",
        "--n-embd", "32", "--n-head", "4", "--n-layer", "1",
        "--p-dropout", "0", "--checkpoint-every", "1"]
WIDTHS = dict(n_vocab=300, n_embd=32, n_head=4, n_positions=24, n_layer=1,
              p_dropout=0.0)
MESHES = {
    "dp": ["--dp", "4"],
    "tp": ["--tp", "4", "--chunked-loss", "2"],
    "dcn": ["--dcn-data", "2", "--tp", "2"],
    "zero1": ["--zero1", "--dp", "4"],
    "zero1_mp": ["--zero1", "--dp", "4", "--mixed-precision"],
    "sp": ["--sequence-parallel", "--dp", "2", "--tp", "2", "--pack"],
}
JAX_MESHES = [name for name in MESHES if name != "zero1_mp"]
# the port's train_epoch seed for epoch 0 at --seed 0 (seed * 100_003 +
# epoch + 1)
PORT_EPOCH_SEED = 1


def jax_init_params():
    """The JAX app's initial parameters at ``--seed 0``: its key split, as
    its ``main`` does."""
    _, pkey = jax.random.split(jax.random.key(0))
    params = jnn.DecoderLM(jnn.DecoderConfig(**WIDTHS)).init(pkey)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  params)


def aligned_train_epoch(model, opt, params, opt_state, examples, collate_fn,
                        batch_size, key, **kw):
    """The JAX app's ``train_epoch`` on the examples reordered so that its
    permutation of them is the port's permutation of the originals."""
    n = len(examples)
    mine = np.random.default_rng(
        np.asarray(jax.random.key_data(key)).ravel().tolist()).permutation(n)
    port = np.random.default_rng(PORT_EPOCH_SEED).permutation(n)
    moved = [None] * n
    for a, b in zip(mine, port):
        moved[a] = examples[b]
    return aligned_train_epoch.real(model, opt, params, opt_state, moved,
                                    collate_fn, batch_size, key, **kw)


aligned_train_epoch.real = japp.train_epoch


def jax_runs(root):
    """The JAX app's ``main`` on each mesh of ``JAX_MESHES`` (its CPU mesh
    of 8 devices; ``--dcn-data`` emulated by contiguous device blocks, as
    ``TPU_FLASH_PLATFORM`` asks): each run's metrics records."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(japp, "train_epoch", aligned_train_epoch)
        mp.setenv("TPU_FLASH_PLATFORM", "cpu")
        for name in JAX_MESHES:
            wd = root / f"jax_{name}"
            japp.main(BASE + MESHES[name] + ["--skip-bleu", "--workdir",
                                              str(wd)])
            out[name] = metrics(wd)
    return out


def metrics(workdir):
    return [json.loads(line) for line in
            (workdir / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4-rank world's runs (in a thread, while the JAX app's run here):
    ``(root, out, params, jax)``; ``out[rank][CALLS.index(name)]``."""
    root = tmp_path_factory.mktemp("mt_mesh")
    params = jax_init_params()
    calls = [("rank_mt_main", dict(argv=BASE + flags + [
        "--workdir", str(root / name)] + (["--skip-bleu"]
                                          if name != "dp" else []),
        params=params))
             for name, flags in MESHES.items()]
    resume = BASE + MESHES["zero1"] + ["--workdir", str(root / "zero1"),
                                       "--resume", "--n-epochs", "2",
                                       "--skip-bleu"]
    calls.append(("rank_mt_main", dict(argv=resume, params=params)))
    calls.append(("rank_mt_functions", dict(
        data=2, model=2, argv=BASE[:-2] + ["--max-iters-per-epoch", "2"])))
    with ThreadPoolExecutor(1) as pool:
        world = pool.submit(
            dryrun.run_world, "tpu_flash_torch.parallel.dryrun.rank_many",
            4, device="cpu", timeout=300, calls=calls)
        jax_out = jax_runs(root)
        out = world.result()
    return root, out, params, jax_out


CALLS = list(MESHES) + ["resume", "functions"]


# each mesh's flags that are not the mesh's: the single-process run's
SAME = {"dp": [], "tp": ["--chunked-loss", "2"], "dcn": [], "zero1": [],
        "zero1_mp": ["--mixed-precision"], "sp": ["--pack"]}


def single(tmp_path, params, name, extra=()):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tapp, "init_params",
                   lambda model, gen: tnn.load_jax_params(model, params))
        return tapp.main(BASE + SAME[name] + list(extra)
                         + ["--workdir", str(tmp_path)], device="cpu")


def step_losses(recs):
    return {r["step"]: r["loss"] for r in recs
            if "loss" in r and r.get("event") is None}


def first_run(recs):
    """The records of a workdir's first run (the ZeRO-1 resume appends a
    second)."""
    starts = [i for i, r in enumerate(recs) if r.get("event") == "run_start"]
    return recs[:starts[1]] if len(starts) > 1 else recs


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_flag_trains_as_single_process(runs, tmp_path, name):
    root, out, params, _ = runs
    i = CALLS.index(name)
    got = out[0][i]["epochs"][0]
    want = single(tmp_path, params, name,
                  [] if name == "dp" else ["--skip-bleu"])["epochs"][0]
    for k in ("train_loss", "validation_loss"):
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (k, got, want)
    for r in out[1:]:                       # every rank ran the same steps
        assert r[i]["epochs"][0]["train_loss"] == got["train_loss"]


@pytest.mark.parametrize("name", JAX_MESHES)
def test_mesh_flag_trains_as_the_jax_app(runs, name):
    """The logged step losses (steps 0 and 2 of 3) and the epoch's mean
    training and validation losses against the JAX app's run on the same
    mesh flags, parameters and batches."""
    root, out, _, jax_out = runs
    want = jax_out[name]
    got = first_run(metrics(root / name))
    assert step_losses(got).keys() == step_losses(want).keys() == {0, 2}
    for s, w in step_losses(want).items():
        assert abs(step_losses(got)[s] - w) <= 1e-5 * abs(w), (s, got, want)
    (w_epoch,) = [r for r in want if r.get("event") == "epoch"]
    g_epoch = out[0][CALLS.index(name)]["epochs"][0]
    for k in ("train_loss", "validation_loss"):
        assert abs(g_epoch[k] - w_epoch[k]) <= 1e-5 * abs(w_epoch[k]), (
            k, g_epoch, w_epoch)


def test_rank_zero_alone_writes(runs):
    root, out, _, _ = runs
    for name in MESHES:
        assert (root / name / "metrics.jsonl").exists()
        assert (root / name / "tokenizer.json").exists()
        recs = [json.loads(line) for line in
                (root / name / "metrics.jsonl").read_text().splitlines()]
        assert sum(r.get("event") == "run_start" for r in recs) == (
            2 if name == "zero1" else 1)
    assert out[0][0]["bleu"] and out[0][0]["bleu"] == out[1][0]["bleu"]


def test_zero1_resume_restores_the_gathered_checkpoint(runs):
    root, out, _, _ = runs
    resumed = out[0][CALLS.index("resume")]
    assert list_checkpoints(str(root / "zero1" / "checkpoints")) == [0, 1]
    assert [r["epoch"] for r in resumed["epochs"]] == [1]
    assert np.isfinite(resumed["epochs"][0]["train_loss"])


def test_ctx_on_train_epoch_matches_single_process(runs):
    fns = runs[1][0][CALLS.index("functions")]
    np.testing.assert_allclose(fns["sharded"]["losses"],
                               fns["single"]["losses"], rtol=1e-5)


def test_ctx_on_evaluate_loss_matches_single_process(runs):
    fns = runs[1][0][CALLS.index("functions")]
    assert abs(fns["sharded"]["validation_loss"]
               - fns["single"]["validation_loss"]) <= 1e-5


def test_ctx_on_generate_translations_matches_single_process(runs):
    for r in runs[1]:
        fns = r[CALLS.index("functions")]
        assert fns["sharded"]["hyps"] == fns["single"]["hyps"]


def test_mesh_flags_refuse_a_world_of_another_size(tmp_path):
    """Outside a 4-rank job the flags name the ranks they need."""
    import torch.distributed as dist

    from tpu_flash_torch import parallel

    parallel.initialize_distributed(f"file://{tmp_path}/store", 1, 0,
                                    device="cpu")
    try:
        with pytest.raises(SystemExit, match="needs 4 ranks, have 1"):
            tapp.main(BASE + ["--dp", "4", "--workdir", str(tmp_path)],
                      device="cpu")
        with pytest.raises(SystemExit, match="divisible by tp"):
            tapp.main(BASE + ["--tp", "3", "--n-head", "3",
                              "--workdir", str(tmp_path)], device="cpu")
    finally:
        dist.destroy_process_group()
