"""GPipe through ``tpu_flash_torch.parallel.pipeline`` on 4 gloo ranks (one
stage each, the JAX dryrun's model at 4 layers, 4 microbatches) against the
JAX package's ``pipelined_decoder_apply`` on its 4-device CPU mesh, from the
same JAX-initialized parameters: the loss within 1e-5, every gradient
within the dryrun's 1e-4, and both against the single-process port; the
layer stacking against the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash import nn as jnn
from tpu_flash.parallel import pipeline as jpipe
from tpu_flash_torch import nn as tnn
from tpu_flash_torch.parallel import dryrun
from tpu_flash_torch.parallel import pipeline as tpipe

torch.set_num_threads(1)

CFG = dict(n_vocab=512, n_embd=128, n_head=8, n_positions=64, n_layer=4,
           p_dropout=0.0, attention_kind="flash")


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def runs():
    model = jnn.DecoderLM(jnn.DecoderConfig(**CFG))
    params = model.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 512, (4, 32))
    tgt = rng.integers(0, 512, (4, 32))
    port = dryrun.run_world(
        "tpu_flash_torch.parallel.dryrun.rank_pipeline", 4, device="cpu",
        timeout=240,
        config_kw={"n_layer": 4}, ids=ids, tgt=tgt, params=np_tree(params),
        full=True)
    mesh = jpipe.make_pipeline_mesh(pipe=4, data=1,
                                    devices=jax.devices()[:4])

    def loss_fn(p):
        logits = jpipe.pipelined_decoder_apply(
            model, p, jnp.asarray(ids, jnp.int32), mesh=mesh, n_micro=4,
            data_axis=None)
        return jnp.mean(jnn.functional.softmax_loss(
            logits, jnp.asarray(tgt, jnp.int32)))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return port, float(loss), np_tree(grads), params


def test_pipeline_loss_matches_jax_and_single_process(runs):
    port, jloss, _, _ = runs
    for r in port:                       # every stage holds the loss
        assert abs(r["loss"] - jloss) <= 1e-5 * abs(jloss)
    assert abs(port[0]["loss"] - port[0]["ref_loss"]) <= 1e-5 * abs(jloss)


def test_pipeline_gradients_match_jax(runs):
    port, _, jgrads, _ = runs
    got = dict(tnn.named_tree_leaves(port[0]["grads"]))
    want = dict(tnn.named_tree_leaves(jgrads))
    assert got.keys() == want.keys()
    for n in want:
        np.testing.assert_allclose(got[n], want[n], atol=1e-4, rtol=0,
                                   err_msg=n)


def test_pipeline_gradients_match_single_process(runs):
    port = runs[0]
    assert port[0]["grad_max_dev"] < 1e-4
    assert all(r["stage_layers"] == 1 for r in port)


def test_stack_layer_params_matches_jax(runs):
    params = runs[3]
    m = tnn.DecoderLM(tnn.DecoderConfig(**CFG), device="cpu")
    tnn.load_jax_params(m, params)
    named = {n: p.detach() for n, p in m.named_parameters()}
    stacked = tpipe.stack_layer_params(named, 4)
    jst = jpipe.stack_layer_params(params, 4)
    w = stacked["attention.q_projection.weight"]
    np.testing.assert_array_equal(
        w.transpose(1, 2).numpy(),
        np.asarray(jst["attention"]["q_projection"]["weight"]))
    assert tpipe.unstack_layer_params(stacked, 4).keys() == {
        n for n in named if n.startswith("layers.")}
