"""DP x TP x EP through ``tpu_flash_torch.parallel`` on 4 gloo ranks against
the JAX package's sharded step on its 4-device CPU mesh, from the same
JAX-initialized parameters (``load_jax_params``, then ``shard_params`` on
every rank) and the JAX dryrun's packed batch:

* mode (1), dp2 x tp2 with MoE 8 experts top-1, Megatron sequence
  parallelism and the vocab-parallel loss: the loss and the logits within
  1e-5, every gradient within 1e-5 + 1e-4 relative, and against the
  single-process port on rank 0;
* mode (2), attention dropout 0.1: the sharded loss and gradients against
  the single-process port's (the masks are the kernels' hash of the
  global batch and head, so they are the unsharded call's; the JAX
  package's seeds come from its own keys, so its values are not the port's);
* mode (6), DCN 2 x dp1 x tp2: the rank order of ``make_mesh(dcn_data=2)``
  against the JAX hybrid mesh's device order, and the loss;
* the vocab-parallel loss alone against ``parallel.vocab_parallel_softmax_
  loss``, and ``nn.functional.chunked_softmax_loss``'s ``axis_name`` /
  ``batch_axis`` forms against the single-device chunked loss.

Each world is spawned once (``parallel.dryrun.run_world``: ``file://``
store, ``spawn``, a join deadline that terminates the ranks and fails)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash import nn as jnn
from tpu_flash import parallel as jpar
from tpu_flash.parallel.context import parallel_context as jctx
from tpu_flash_torch import nn as tnn
from tpu_flash_torch.parallel import dryrun

torch.set_num_threads(1)

TIMEOUT = 240
CFG = dict(n_vocab=512, n_embd=128, n_head=8, n_positions=64, n_layer=2,
           p_dropout=0.0, attention_kind="flash")


def jax_model(**kw):
    return jnn.DecoderLM(jnn.DecoderConfig(
        **CFG, moe=jnn.MoEConfig(n_experts=8, top_k=1),
        sequence_parallel=True, **kw))


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def jax_loss_fn(model, ctx):
    def loss_fn(params, batch, key=None, training=False):
        hidden, aux = model(params, batch["input_ids"],
                            segment_ids=batch["segment_ids"],
                            positions=batch["positions"], key=key,
                            training=training, return_aux=True,
                            return_hidden=True)
        lm = params["lm_head"]
        losses = jpar.vocab_parallel_softmax_loss(
            hidden, lm["weight"], lm.get("bias"), batch["labels"],
            n_chunks=2, ctx=ctx)
        ce = jnp.mean(losses * batch["label_token_weights"])
        return ce + model.cfg.moe.aux_weight * aux
    return loss_fn


def jax_sharded(model, params, batch, *, data, dcn=1):
    """Loss, gradients and logits of the JAX dryrun's objective on the
    (dcn x data, 2) mesh, params in the Megatron layout."""
    ctx = jpar.make_mesh(data=data, model=2, devices=jax.devices()[:4],
                         dcn_data=dcn)
    sparams, _ = jpar.shard_params(ctx, model, params)
    sbatch = jpar.put_batch(ctx, batch)
    loss_fn = jax_loss_fn(model, ctx)

    def step(p, b):
        with jctx(ctx):
            return jax.value_and_grad(loss_fn)(p, b, key=jax.random.key(1),
                                               training=True)

    def logits(p, b):
        with jctx(ctx):
            return model(p, b["input_ids"], segment_ids=b["segment_ids"],
                         positions=b["positions"])

    loss, grads = jax.jit(step)(sparams, sbatch)
    lg = jax.jit(logits)(sparams, sbatch)
    return ctx, float(loss), np_tree(grads), np.asarray(lg, np.float32)


def leaves(tree):
    return dict(tnn.named_tree_leaves(tree))


MOE = dict(moe=dict(n_experts=8, top_k=1), sequence_parallel=True)


@pytest.fixture(scope="module")
def vocab():
    rng = np.random.default_rng(3)
    B, L, E, V = 4, 6, 16, 40
    return dict(hidden=rng.standard_normal((B, L, E)).astype(np.float32),
                weight=rng.standard_normal((V, E)).astype(np.float32) * 0.3,
                bias=rng.standard_normal((V,)).astype(np.float32) * 0.1,
                labels=rng.integers(0, V, (B, L)).astype(np.int32),
                cot=rng.random((B, L)).astype(np.float32))


@pytest.fixture(scope="module")
def world(vocab):
    """One world of 4 ranks: mode (1) from the JAX parameters, mode (2),
    mode (6), and the loss's three sharded forms."""
    model = jax_model()
    params = model.init(jax.random.key(0))
    batch = dryrun.dryrun_batch(4, 64, CFG["n_vocab"])
    tree = np_tree(params)
    calls = [
        ("rank_train", dict(config_kw=MOE, data=2, model=2, batch=batch,
                            params=tree, full=True)),
        ("rank_train", dict(config_kw={**MOE, "attn_dropout": 0.1}, data=2,
                            model=2, batch=batch, params=tree,
                            logits=False)),
        ("rank_train", dict(config_kw=MOE, data=1, model=2, dcn=2,
                            batch=batch, params=tree, logits=False)),
        ("rank_vocab_loss", dict(data=2, model=2, n_chunks=2,
                                 form="vocab_parallel", **vocab)),
        ("rank_vocab_loss", dict(data=2, model=2, n_chunks=2,
                                 form="axis_name", **vocab)),
        ("rank_vocab_loss", dict(data=4, model=1, n_chunks=3,
                                 form="batch_axis", **vocab)),
    ]
    r0 = dryrun.run_world("tpu_flash_torch.parallel.dryrun.rank_many", 4,
                          device="cpu", timeout=TIMEOUT, calls=calls)[0]
    return dict(model=model, params=params, batch=batch, mode1=r0[0],
                dropout=r0[1], dcn=r0[2],
                vocab={"vocab_parallel": r0[3], "axis_name": r0[4],
                       "batch_axis": r0[5]})


@pytest.fixture(scope="module")
def jax_mode1(world):
    return jax_sharded(world["model"], world["params"], world["batch"],
                       data=2)


def test_dp_tp_ep_loss_matches_jax_and_single_process(world, jax_mode1):
    port, jloss = world["mode1"], jax_mode1[1]
    assert abs(port["loss"][0] - jloss) <= 1e-5 * abs(jloss)
    assert abs(port["loss"][0] - port["ref_loss"]) <= 1e-5 * abs(jloss)


def test_dp_tp_ep_logits_match_jax(world, jax_mode1):
    np.testing.assert_allclose(world["mode1"]["logits"], jax_mode1[3],
                               atol=1e-5, rtol=0)


def test_dp_tp_ep_gradients_match_jax(world, jax_mode1):
    got, want = leaves(world["mode1"]["grads"]), leaves(jax_mode1[2])
    assert got.keys() == want.keys()
    for n in want:
        np.testing.assert_allclose(got[n], want[n], atol=1e-5, rtol=1e-4,
                                   err_msg=n)


def test_dp_tp_ep_gradients_match_single_process(world):
    assert world["mode1"]["grad_errors"]["worst_over_fp32_tol"] <= 1e-2


def test_dp_tp_ep_ranks_run_gloo_host(world):
    port = world["mode1"]
    assert port["transport"] == "gloo-host"
    assert port["mesh"] == ((0, 1), (2, 3))


def test_attention_dropout_matches_single_process(world):
    r0 = world["dropout"]
    assert abs(r0["loss"][0] - r0["ref_loss"]) <= 1e-5 * abs(r0["ref_loss"])
    assert r0["grad_errors"]["worst_over_fp32_tol"] <= 1e-2
    assert r0["loss"][0] != world["mode1"]["loss"][0]     # dropout acted


def test_dcn_mesh_order_and_loss_match_jax(world):
    r0 = world["dcn"]
    jctx_, jloss, _, _ = jax_sharded(world["model"], world["params"],
                                     world["batch"], data=1, dcn=2)
    ids = tuple(tuple(int(d.id) for d in row)
                for row in jctx_.mesh.devices)
    assert r0["mesh"] == ids
    assert abs(r0["loss"][0] - jloss) <= 1e-5 * abs(jloss)


def jax_vocab(vocab, n_chunks):
    ctx = jpar.make_mesh(data=2, model=2, devices=jax.devices()[:4])
    w = jnp.asarray(vocab["weight"].T)

    def f(x, w, b):
        losses = jpar.vocab_parallel_softmax_loss(
            x, w, b, jnp.asarray(vocab["labels"]), n_chunks=n_chunks,
            ctx=ctx)
        return jnp.sum(losses * vocab["cot"]), losses

    (_, losses), (dx, dw, db) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(vocab["hidden"]), w, jnp.asarray(vocab["bias"]))
    return {"losses": losses, "dx": dx, "dw": np.asarray(dw).T, "db": db}


@pytest.mark.parametrize("form", ["vocab_parallel", "axis_name"])
def test_vocab_parallel_loss_matches_jax(world, vocab, form):
    got = world["vocab"][form]
    want = jax_vocab(vocab, 2)
    for k in ("losses", "dx", "dw", "db"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-5,
                                   rtol=1e-5, err_msg=k)


def test_chunked_loss_batch_axis_form_sums_dw_over_data(world, vocab):
    """``batch_axis`` alone (the whole vocab on every rank, the tokens
    split over 4 data ranks): the losses and dx of the rank's rows, dW and
    db summed over every rank's tokens, as the single-device loss gives
    them."""
    got = world["vocab"]["batch_axis"]
    x = jnp.asarray(vocab["hidden"])

    def f(x, w, b):
        losses = jnn.functional.chunked_softmax_loss(
            x, w, b, jnp.asarray(vocab["labels"]), n_chunks=3)
        return jnp.sum(losses * vocab["cot"]), losses

    (_, losses), (dx, dw, db) = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(
        x, jnp.asarray(vocab["weight"].T), jnp.asarray(vocab["bias"]))
    for k, w in (("losses", losses), ("dx", dx), ("dw", np.asarray(dw).T),
                 ("db", db)):
        np.testing.assert_allclose(got[k], np.asarray(w), atol=1e-5,
                                   rtol=1e-5, err_msg=k)


def test_parallel_imports_leave_out_jax_and_the_jax_package():
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    code = ("import sys, tpu_flash_torch.parallel, "
            "tpu_flash_torch.parallel.dryrun, "
            "tpu_flash_torch.parallel.decode; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'tpu_flash')); "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    import re
    banned = re.compile(r"^\s*(from|import)\s+(jax|tpu_flash)\b", re.M)
    for f in [*(repo / "tpu_flash_torch").rglob("*.py"),
              *(repo / "tools").glob("torch_*.py"), repo / "chip_smoke.py"]:
        assert not banned.search(f.read_text()), f


def test_parallel_exports_the_jax_packages_names():
    from tpu_flash_torch import parallel

    for name in ("ParallelContext", "make_mesh", "initialize_distributed",
                 "current_context", "set_parallel_context",
                 "parallel_context", "decoder_param_specs", "shard_params",
                 "map_with_specs", "batch_specs", "put_batch",
                 "put_local_batch", "make_sharded_train_step",
                 "init_sharded", "init_zero1", "make_zero1_train_step",
                 "zero1_specs", "vocab_parallel_softmax_loss",
                 "allgather_attention", "ring_attention",
                 "sequence_parallel_attention", "make_pipeline_mesh",
                 "stack_layer_params", "pipelined_decoder_apply"):
        assert callable(getattr(parallel, name)), name


def one_rank_ctx(data=2, model=2, data_rank=1, model_rank=0):
    """A context as rank (data_rank, model_rank) of a data x model mesh
    would hold it, without process groups (for the functions that read
    only its sizes and coordinates)."""
    from tpu_flash_torch.parallel.context import ParallelContext

    return ParallelContext(
        data_size=data, model_size=model, dcn_data=1,
        rank=data_rank * model + model_rank, data_rank=data_rank,
        model_rank=model_rank, data_group=None, model_group=None,
        mesh=tuple(tuple(d * model + m for m in range(model))
                   for d in range(data)), device=torch.device("cpu"))


@pytest.mark.parametrize("moe", [False, True])
def test_decoder_param_specs_are_the_jax_specs_in_the_port_layout(moe):
    """Each parameter's spec is JAX's, with a Linear weight's two dims
    swapped (``[out, in]`` against JAX's ``[in, out]``)."""
    from tpu_flash_torch import parallel as tpar

    kw = dict(moe=jnn.MoEConfig(n_experts=8, top_k=1)) if moe else {}
    jm = jnn.DecoderLM(jnn.DecoderConfig(**CFG, **kw))
    params = jm.init(jax.random.key(0))
    want = dict(tnn.named_tree_leaves(jpar.decoder_param_specs(jm, params)))
    tkw = dict(moe=tnn.MoEConfig(n_experts=8, top_k=1)) if moe else {}
    tm = tnn.DecoderLM(tnn.DecoderConfig(**CFG, **tkw), device="cpu")
    got = tpar.decoder_param_specs(tm)
    from tpu_flash_torch.nn.module import _transposed

    swapped = _transposed(tm)
    assert got.keys() == want.keys()
    for n, spec in got.items():
        w = tuple(want[n]) + (None,) * (len(spec) - len(tuple(want[n])))
        assert (spec[::-1] if n in swapped else spec) == w, n


def test_put_batch_takes_this_ranks_rows():
    from tpu_flash_torch import parallel as tpar

    ctx = one_rank_ctx(data=2, data_rank=1)
    batch = dryrun.dryrun_batch(4, 8, 50)
    batch["loss_norm"] = np.float32(32.0)
    local = tpar.put_batch(ctx, batch)
    np.testing.assert_array_equal(local["input_ids"].numpy(),
                                  batch["input_ids"][2:])
    assert float(local["loss_norm"]) == 32.0
    assert float(tpar.local_loss_norm(ctx, local)["loss_norm"]) == 16.0
    specs = tpar.batch_specs(ctx, batch)
    assert specs["labels"] == ("data", None) and specs["loss_norm"] == ()
    again = tpar.put_local_batch(ctx, {k: v[:2] for k, v in batch.items()
                                       if np.ndim(v)})
    assert again["positions"].shape == (2, 8)
    doubled = tpar.map_with_specs({"a": {"b": 1}}, {"a": {"b": ("x",)}},
                                  lambda v, s: (v * 2, s))
    assert doubled == {"a": {"b": (2, ("x",))}}
    with pytest.raises(ValueError, match="not a multiple of data size"):
        tpar.put_batch(one_rank_ctx(data=3, data_rank=0), batch)
