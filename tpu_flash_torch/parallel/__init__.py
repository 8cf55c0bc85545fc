"""The parallel layer on ``torch.distributed``, counterpart of
``tpu_flash/parallel/``: explicit SPMD, one process per rank.

  context.py    -- ``ParallelContext`` (the [dcn, data, model] mesh of
                   ranks and its process groups), ``make_mesh``,
                   ``initialize_distributed``
  comm.py       -- every collective, each differentiable one an
                   ``autograd.Function`` with its transpose as backward;
                   gloo groups stage CUDA tensors through host memory
  sharding.py   -- Megatron parameter specs, ``shard_params`` /
                   ``gather_params``, the batch over data
  vocab_loss.py -- the vocab-parallel fused lm_head + cross-entropy
  train.py      -- the sharded train step (gradients averaged over data)
  zero.py       -- ZeRO-1: optimizer state sliced over data
  sequence.py   -- all-gather and ring attention over a sequence split
  pipeline.py   -- GPipe over a pipe group
  decode.py     -- the rows of sharded decoding over data
  dryrun.py     -- the JAX package's eleven parallel modes at N ranks
"""

from tpu_flash_torch.parallel.context import (  # noqa: F401
    ParallelContext,
    current_context,
    initialize_distributed,
    make_mesh,
    parallel_context,
    set_parallel_context,
)
from tpu_flash_torch.parallel.sharding import (  # noqa: F401
    batch_specs,
    decoder_param_specs,
    gather_params,
    map_with_specs,
    put_batch,
    put_local_batch,
    shard_params,
)
from tpu_flash_torch.parallel.sequence import (  # noqa: F401
    allgather_attention,
    ring_attention,
    sequence_parallel_attention,
)
from tpu_flash_torch.parallel.train import (  # noqa: F401
    init_sharded,
    local_loss_norm,
    make_sharded_train_step,
)
from tpu_flash_torch.parallel.vocab_loss import (  # noqa: F401
    vocab_parallel_softmax_loss,
)
from tpu_flash_torch.parallel.zero import (  # noqa: F401
    gather_state,
    init_zero1,
    make_zero1_train_step,
    state_shardings,
    zero1_specs,
)
from tpu_flash_torch.parallel.pipeline import (  # noqa: F401
    make_pipeline_mesh,
    pipelined_decoder_apply,
    stack_layer_params,
    unstack_layer_params,
)
