"""Training on several ranks: data parallelism, spatial sharding of the
grid with halo rows, and tensor parallelism over conv channels.

Counterpart of :mod:`deepfluids_tpu.parallel`.  Every rank is one process
on one device (a chip and a host alike), joined by ``torch.distributed``:

- ``mesh``   — ``init_distributed`` (torchrun's variables), the (data,
               model) ``Layout`` of process groups, batch rows per rank,
               the gradient reduction rule and the channel-sharded
               parameters and their whole-model state;
- ``halo``   — sharded finite differences: the FD kernels run on haloed
               blocks of rows, bit for bit the whole-field kernels';
- ``layers`` — the model's convolutions and dense layers over sharded
               rows or channels;
- ``comm``   — the collectives and their autograd rules, over NCCL or
               gloo.
"""

from deepfluids_tpu_torch.parallel.comm import SINGLE, Shard
from deepfluids_tpu_torch.parallel.mesh import (
    Layout,
    init_distributed,
    local_rows,
    make_layout,
    reduce_grads_,
    world,
)

__all__ = ["SINGLE", "Layout", "Shard", "init_distributed", "local_rows",
           "make_layout", "reduce_grads_", "world"]
