"""ZeRO-1 with mixed precision through ``tpu_flash_torch.parallel`` on 4
gloo ranks (dp2 x tp2, the JAX dryrun's MoE + sequence-parallel model)
against the JAX package's ``make_zero1_train_step`` on its CPU mesh, from
the same JAX-initialized parameters: after two steps the losses, and the
Adam moments gathered to the full layout, within 1e-5; against the plain
DP x TP step in the same world, the parameters and moments equal and each
rank's state holding half of it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash import nn as jnn
from tpu_flash import parallel as jpar
from tpu_flash_torch import nn as tnn
from tpu_flash_torch.parallel import dryrun

torch.set_num_threads(1)

CFG = dict(n_vocab=512, n_embd=128, n_head=8, n_positions=64, n_layer=2,
           p_dropout=0.0, attention_kind="flash")


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def runs():
    model = jnn.DecoderLM(jnn.DecoderConfig(
        **CFG, moe=jnn.MoEConfig(n_experts=8, top_k=1),
        sequence_parallel=True))
    params = model.init(jax.random.key(0))
    batch = dryrun.dryrun_batch(4, 64, CFG["n_vocab"])
    port = dryrun.run_world(
        "tpu_flash_torch.parallel.dryrun.rank_train", 4, device="cpu",
        timeout=240,
        config_kw=dict(moe=dict(n_experts=8, top_k=1),
                       sequence_parallel=True),
        data=2, model=2, batch=batch, params=np_tree(params), mixed=True,
        zero1=True, steps=2, full=True)
    ctx = jpar.make_mesh(data=2, model=2, devices=jax.devices()[:4])
    opt = jnn.mixed_precision(jnn.adam(lr=1e-3))
    zparams, zstate, _, _ = jpar.init_zero1(ctx, model, opt,
                                            jax.random.key(0))

    def loss_fn(p, b, key=None, training=False):
        hidden, aux = model(p, b["input_ids"], segment_ids=b["segment_ids"],
                            positions=b["positions"], key=key,
                            training=training, return_aux=True,
                            return_hidden=True)
        lm = p["lm_head"]
        losses = jpar.vocab_parallel_softmax_loss(
            hidden, lm["weight"], lm.get("bias"), b["labels"], n_chunks=2,
            ctx=ctx)
        return (jnp.mean(losses * b["label_token_weights"])
                + model.cfg.moe.aux_weight * aux)

    step = jpar.make_zero1_train_step(ctx, model, opt, loss_fn)
    sbatch = jpar.put_batch(ctx, batch)
    jl = []
    for _ in range(2):
        zparams, zstate, loss = step(zparams, zstate, sbatch,
                                     jax.random.key(1))
        jl.append(float(loss))
    jpar.set_parallel_context(None)
    return port, jl, np_tree(zstate.inner)


def test_zero1_losses_match_jax(runs):
    port, jl, _ = runs
    np.testing.assert_allclose(port[0]["loss"], jl, rtol=1e-5)


@pytest.mark.parametrize("moment", ["exp_avg", "exp_avg_sq"])
def test_zero1_moments_gathered_match_jax(runs, moment):
    port, _, jstate = runs
    got = dict(tnn.named_tree_leaves(port[0][moment]))
    want = dict(tnn.named_tree_leaves(getattr(jstate, moment)))
    assert got.keys() == want.keys()
    for n in want:
        np.testing.assert_allclose(got[n], want[n], atol=1e-5, rtol=0,
                                   err_msg=n)


def test_zero1_equals_the_plain_dp_tp_step(runs):
    r0 = runs[0][0]
    assert r0["params_vs_plain"] == 0.0 and r0["moments_vs_plain"] == 0.0
    assert r0["loss"] == r0["plain_loss"]


def test_zero1_state_is_sliced_over_data(runs):
    """Every rank holds about half the plain step's moments (LayerNorm
    vectors and other leaves no data size divides stay whole)."""
    for r in runs[0]:
        assert r["state_bytes"] < 0.55 * r["plain_state_bytes"]


def test_zero1_specs_take_the_first_free_dim_the_data_size_divides():
    from tpu_flash_torch.nn import adam, mixed_precision, skip_nonfinite
    from tpu_flash_torch.parallel.context import ParallelContext
    from tpu_flash_torch.parallel.zero import state_shardings, zero1_specs

    ctx = ParallelContext(data_size=2, model_size=2, dcn_data=1, rank=0,
                          data_rank=0, model_rank=0, data_group=None,
                          model_group=None, mesh=((0, 1), (2, 3)),
                          device=torch.device("cpu"))
    params = {"w": torch.zeros(6, 4), "v": torch.zeros(3), "u":
              torch.zeros(3, 8)}
    specs = {"w": ("model", None), "v": (None,), "u": (None, None)}
    z = zero1_specs(ctx, params, specs)
    assert z == {"w": ("model", "data"), "v": (None,), "u": (None, "data")}
    opt = skip_nonfinite(mixed_precision(adam()))
    state = opt.init(params)
    sh = state_shardings(ctx, state, z)
    assert sh.inner.inner.exp_avg == z and sh.inner.master == z
    assert sh.skipped == () and sh.inner.inner.step == ()
