"""repro_torch — ``repro`` ported to PyTorch and hand-written CUDA kernels for
an NVIDIA H100: the wait-free graph (one shard, hash-prefix shards, shards
on several devices), and every LM family's serving, training and dry run,
on one card or on the ranks of a ``torch.distributed`` mesh; the serving
path's KV page table is that graph.  Its seven CUDA kernels (``kernels/``) are the counterparts of
``repro``'s seven Pallas kernels; the last, ``paged_attention``, is decode
attention over K/V pages addressed through the block tables of that page
table.

It imports ``torch`` and never ``jax`` nor anything of ``repro``; ``repro``
stays the reference every result is held against (bit-identical for the
graph, since all its state is int32/bool; within the float tolerances of
``repro``'s own tests for attention, the scan and the LM).
"""
