"""Multi-process training on ``torch.distributed``.

Port of ``notorch_tpu.parallel``: one process per rank (gloo on the CPU,
NCCL on the card), launched by ``torchrun`` or any launcher that sets
``RANK``/``WORLD_SIZE`` (:mod:`.distributed`). JAX's named mesh axes become
a ``DeviceMesh`` with named dimensions (:mod:`.mesh`), and ``shard_map``'s
collectives become collectives on that mesh's per-axis groups
(:mod:`.collectives`), bound to the axis names while a trainer runs its
step. A rank holds only its own entry of JAX's stacked ``[n_data, n_graph,
...]`` batch (:func:`.partition.local_entry`).
"""
