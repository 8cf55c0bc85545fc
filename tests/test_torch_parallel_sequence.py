"""All-gather and ring attention through ``tpu_flash_torch.parallel.
sequence`` on 4 gloo ranks (the sequence split along L) against the JAX
package's ``sequence_parallel_attention`` under ``shard_map`` on its
4-device CPU mesh, on the JAX dryrun's inputs (2 x 4 x 128 x 32, fp32):
the loss within 1e-5 relative and dq within the dryrun's 1e-3, out, dk and
dv against float64; under a window the ring truncating to
``window_steps`` - 1 hops, and the output still float64's; in bf16, K/V
moving in bf16 (the all-gather's buffer and each hop two bytes a value)
with out, dq, dk and dv near float64's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from tpu_flash.parallel.sequence import sequence_parallel_attention as jspa
from tpu_flash_torch.parallel import dryrun
from tpu_flash_torch.parallel.sequence import window_steps

torch.set_num_threads(1)

N = 4
STRATEGIES = ("allgather", "ring")
BF16_SHAPE = (1, 2, 16 * N, 32)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return [rng.standard_normal((2, 4, 32 * N, 32)).astype(np.float32)
            for _ in range(4)]


@pytest.fixture(scope="module")
def port(inputs):
    q, k, v, w = inputs
    keys = [(s, win) for s in STRATEGIES for win in (None, 40)]
    calls = [("rank_sequence", dict(q=q, k=k, v=v, w=w, strategy=s,
                                    window=win, full=True))
             for s, win in keys]
    keys += [(s, "bf16") for s in STRATEGIES]
    calls += [("rank_sequence", dict(q=None, k=None, v=None, w=None,
                                     strategy=s, seed=3, shape=BF16_SHAPE,
                                     dtype=torch.bfloat16))
              for s in STRATEGIES]
    r0 = dryrun.run_world("tpu_flash_torch.parallel.dryrun.rank_many", N,
                          device="cpu", timeout=240, calls=calls)[0]
    return dict(zip(keys, r0))


def jax_sharded(inputs, strategy):
    q, k, v, w = (jnp.asarray(a) for a in inputs)
    mesh = Mesh(np.asarray(jax.devices()[:N]), ("seq",))
    spec = P(None, None, "seq", None)

    def loss(q, k, v):
        fn = jax.shard_map(
            lambda q, k, v, w: jax.lax.psum(jnp.sum(jspa(
                q, k, v, axis_name="seq", strategy=strategy,
                impl="reference") * w), "seq"),
            mesh=mesh, in_specs=(spec,) * 4, out_specs=P(), check_vma=False)
        return fn(q, k, v, w)

    l, gq = jax.jit(jax.value_and_grad(loss))(q, k, v)
    return float(l), np.asarray(gq)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_loss_and_dq_match_jax(port, inputs, strategy):
    r = port[(strategy, None)]
    jl, jdq = jax_sharded(inputs, strategy)
    assert abs(r["loss"] - jl) <= 1e-5 * abs(jl)
    np.testing.assert_allclose(r["got"]["dq"], jdq, atol=1e-3, rtol=0)


@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_outputs_and_gradients_match_float64(port, strategy, window):
    r = port[(strategy, window)]
    for name, e in r["errors"].items():
        assert e["max_abs_err"] <= 1e-5 * max(1.0, e["ref_max"]), (name, e)


def test_ring_truncates_under_a_window(port):
    """L_loc 32, window 40: only distances 0..2 have keys in a window, so
    the ring makes 2 hops where it makes 3 without one."""
    assert window_steps(N, 32, 40) == 3
    assert port[("ring", None)]["hops"] == N - 1
    assert port[("ring", 40)]["hops"] == 2
    # rank 0 merges only its diagonal chunk, the others up to 3
    assert port[("ring", 40)]["partials"] == 1


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_bf16_kv_move_in_bf16(port, strategy):
    """K/V cross ranks in their own dtype, as JAX's do: rank 0 receives
    the all-gather's n chunks of K and V, or one chunk of each a hop, at
    two bytes a value; the fp32 merge keeps out, dq, dk and dv within
    bf16's rounding of float64's (rms over rms)."""
    r = port[(strategy, "bf16")]
    B, H, L, d = BF16_SHAPE
    chunk = 2 * B * H * (L // N) * d * 2
    assert r["kv_bytes"] == chunk * (N if strategy == "allgather"
                                     else N - 1)
    for name, e in r["errors"].items():
        assert e["rms_rel"] <= 1e-2, (name, e)
