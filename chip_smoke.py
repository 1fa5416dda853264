#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card: the wait-free graph (one
shard and hash-prefix sharded), the serving paths of seven LMs (one of each
family: dense, ssm, hybrid, two MoE, vlm and audio), the paged decode
attention on the serving page table's own block tables, training
(zamba2-1.2b at full width, gradients through the two LM kernels), the
dry run's counts held against what the card measured, and several ranks
on one mesh (NCCL with one rank, gloo with four sharing the card, graph
shards on the card and the host).

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits non-zero; nothing is caught and carried on):

1. The card: its name and power limit, and the build of the CUDA kernels
   from ``src/repro_torch/csrc`` (timed); the bf16 attention kernels' SASS
   must hold wgmma (``HGMMA``) and TMA (``UTMALDG``) and no ``mma.sync``,
   every bf16 chunk-state and chunk-output kernel of ``ssd_scan`` the
   tensor cores' ``mma.sync`` (``HMMA``), and the bf16 ``paged_attention``
   kernel at D 64 and 128 ``HMMA`` and cp.async (``LDGSTS``), each reported
   with ptxas's registers and spills.
2. The key hashes on the card against their numpy twins, and each graph
   kernel against its plain PyTorch version on small adversarial inputs
   (duplicates, contention, an all-false mask, sizes off every block size,
   the placement overflow, a compaction across thousands of 4,096-lane
   tiles; ``probe_place`` at m of 1, 515 and 2^20 + 3 and with every lane
   contending for 4 homes, 20 times in a row on one input, its claim rounds
   equal to those of the plain mirror of its rounds; ``frontier_expand`` at
   S of 33 and 256, with no edges, unsorted sources and the sentinel
   column), exact equality; ``masked_compact`` and ``probe_place`` must be
   one launch a call, ``frontier_expand`` two.
3. The graph's main path at the scale of the SNAP com-Youtube graph
   (1,134,890 vertices, 2,987,624 edges;
   snap.stanford.edu/data/com-Youtube.html) with synthetic uniform keys from
   ``--seed``: ``WaitFreeGraph(device="cuda")`` at its default capacities
   grows through the kernels while it takes every vertex and 80 batches of
   65,536 ops of the ``traversal`` mix, each batch checked against the
   sequential oracle; its snapshot maintenance is the default delta queue,
   which folds nothing here (no query caches a snapshot before the
   queries below).  Then ``apply`` is timed for the paper's Fig. 4 mixes,
   and one growth rehash, a full ``build_csr`` (called as such),
   ``reachable``, ``bfs_batch`` and ``get_path_batch`` are timed and checked
   against the oracle on a subset.  Every graph kernel's launch count is
   read around this phase and must be above 0.
4. Each graph kernel against its plain version at the main path's shapes,
   on the main path's own tables, with CUDA-event times taken with the L2
   cache flushed before each run, the kernel's bound (the bytes and
   operations this run's data needs) and the time of one PyTorch call
   computing the same function where there is one; ``probe_place``'s row
   gives its calls and claim rounds on the main path and the rounds of the
   timed call (read from its device counter, outside the timed window), and
   the time of a launch stopped after round 1 beside the whole call;
   ``frontier_expand`` has a row at S 16 (16 BFS sources) and one at
   ``reachable``'s S 256 (the 256 sources of phase 3's pairs), each with
   its atomics (the set bits of the edges' source columns) and the time of
   each of its two launches alone; ``hash_probe``'s row adds its time with
   the L2 warm (the main path's case), the latency floor of its grid (an
   empty kernel, and a key then one dependent load a thread) flushed and
   warm, and the queries resolved at their first probe, within their home
   slot's 32-byte sector and within probe steps 0-3 (what reading those
   sectors in one round trip could save).
5. ``flash_attention`` against its plain version on adversarial small
   shapes (MHA, GQA, MQA, window, Sq != Sk both ways, Sq and Sk of 1, 127,
   128, 129 and 4,100, D of 8 to 128, a GQA group of 7, rows whose keys
   are all masked, 1,200 blocks), f32 within 2e-5 and bf16 within 2e-2;
   and with ``q_offset`` (a q block whose rows sit at positions from
   ``q_offset``, the sequence-parallel layout's): offsets off the f32 and
   bf16 tiles (64 and 128 rows), a window of 4,096 and one narrower than a
   tile, GQA, Sq < Sk, non-causal, at the same limits and, where Sq >=
   1,024, bf16's per-block limit.
6. The LM's serving path at the full width of qwen2-7b (28 layers, d_model
   3584, GQA 28/4, vocab 152064; arXiv:2407.10671), bf16 parameters drawn on
   the card from ``--seed``: ``build_prefill_step`` on 2 prompts of 4,096
   tokens through the kernel, held within 3e-2 relative L2 (last-token
   logits) of the same prefill with the plain attention forced and timed
   (median of 3 after a warm-up); then ``ServingEngine`` (8 slots, 512
   positions, pages of 16) drains 16 requests of 16-64 prompt tokens and 32
   new tokens, half greedy and half at temperature 0.8, with its page table
   in the port's ``WaitFreeGraph(mode="fpsp")``.  ``failover()`` must give
   identical page tables and graph state, and two greedy requests decoded
   alone must give the batch's tokens.  A second wave of 8 requests gets
   the pages the first wave gave back; it is profiled for 6 ticks and then
   drained by hand, and at every 8th tick (at least 4 times, pages reused)
   ``paged_attention`` runs on the engine's own block tables, passed on the
   host as the engine holds them: each live slot's pages from
   ``eng.pages.block_table``, its cache rows of the first
   and last attention layer copied into those pages of a pool of random
   rows, q drawn from the seed; the kernel is held within 2e-2 (bf16) of
   the plain paged version and of the engine's dense decode attention.  The
   launch counts are read around this phase: the attention kernels and the
   page table's graph kernels must each run.
7. ``flash_attention`` at the prefill shapes of qwen2-7b (B 2, Hq 28, Hkv
   4, S 4096, D 128, bf16, causal) and zamba2-1.2b's shared block (B 2, Hq
   = Hkv = 32, D 64) against its plain version, timed as in phase 4,
   beside ``scaled_dot_product_attention`` as the library yardstick (its
   own max abs error against the plain version reported too), with
   TFLOP/s and the share of the bound; the zamba2-1.2b row's launches are
   those of phase 10.  A third row: qwen2-7b's last of 4 sequence blocks
   (Sq 1,024 at ``q_offset`` 3,072 against all 4,096 keys, the
   sequence-parallel layout's heaviest rank), beside SDPA with
   ``causal_lower_right`` (which keeps it on its flash backend); its
   launches are phase 22's at an offset.
8. ``ssd_scan`` against its plain version on small shapes (the reference
   sweep's, K = V = 128, S = 100 at chunk 4, an odd S at chunk 1), in both
   decay modes, both readouts, f32 within 1e-4 and bf16 within 5e-2, with
   decays of 1, 0 and 1e-30 and a nonzero initial state whose final state is
   compared too; in scalar mode a one-column decay must give the kernel's
   result bit for bit.
9. rwkv6-3b (ssm; arXiv:2404.05892) at full width (d_model 2560, 40 heads
   of 64, d_ff 8960, vocab 65536, bf16), 4 of its 32 layers (all 32 before
   phase 22's sequence-parallel run came, then 8 until its decode came), as
   phase 6: the prefill of
   2 x 4,096 tokens runs ``ssd_scan`` once per layer.  The kernel is held
   to the plain scan on the bf16 inputs that the prefill gave the first and
   last layer's scan (within 5e-2, outputs and final states), and the whole
   prefill, on an f32 copy of the weights, within 3e-2 relative L2 of the
   plain scan's (in bf16 the random stack amplifies rounding chaotically
   through its depth, so the bf16 logits' distance is reported, not held);
   the prefill's recurrent states continued by one ``decode_step`` must give
   the logits of a 4,097-token prefill; the serving engine drains phase 6's
   traffic with the same checks.  Launches made only to compare are not
   counted.
10. zamba2-1.2b (hybrid; arXiv:2411.15242) at full width (d_model 2048,
   mamba2 with 64 heads, N 64, conv 4, the shared MHA block after every 6
   layers), 14 of its 38 layers (2 groups and a tail of 2, as at full width;
   all 38 before phase 22's sequence-parallel run came, then 20 until its
   decode came), the same way: ``ssd_scan`` (scalar decay) 14 times and
   ``flash_attention`` twice a prefill, and ``paged_attention`` in the
   drain on the first and last occurrence of the shared block (MHA, 32
   heads of 64).  The prefill does not produce the
   shared block's KV cache (nor does the reference's), so the handoff is
   checked on the first and last mamba2 layers: a 4,096-token block run's
   state continued by one decode step against the 4,097-token block run.
11. ``ssd_scan`` at both prefill shapes (rwkv6: B 2, H 40, S 4096, K = V =
   64, bf16, strict, per-channel, chunk 64; zamba2: B 2, H 64, the same S,
   K, V, bf16, scalar, one decay a step), timed as in phase 4 beside its
   plain version and its bound (the least the function needs, whatever the
   chunk), with each of its three passes timed alone the same way (one
   launch each), the bytes of the scratch it allocates, and its calls beside
   its launches on the model's path (three a call); no single PyTorch call
   computes it.  How close y and the final state came to the limit (the
   largest share of it, and the relative L2) is reported beside the same
   readings for the f32 kernel on the same values with y rounded once to
   bf16 (f32 arithmetic throughout); phases 9 and 10 report them for the
   layers' own scans.
12. ``paged_attention`` against its plain version on small shapes (the
   reference sweep's, a GQA group of 7 at D 128, a group of 1 at D 64, long
   sequences over many splits; lengths 0, 1, a page boundary and the full
   table, repeated page ids, zero-filled table tails), f32 within 2e-5 and
   bf16 within 2e-2, and bit for bit the same with the tables on the host;
   a length of 0 gives 0; a live page id past the pool or negative, a length
   past the table or negative, D 136 and a group of 17 are refused with the
   tables on the card and on the host, with nothing launched.
13. ``paged_attention`` at one decode step at full width, bf16, pages of 16,
   16 sequences: qwen2-7b (28/4 heads of 128, lengths 4,096-32,768) and
   zamba2-1.2b's shared block (32 heads of 64, lengths 1,024-4,096), on
   block tables from a ``PagedKVManager`` on the card (24 sequences
   admitted, every third finished, then the 16 admitted into the pages
   given back), passed on the host as the manager gives them (a call under
   sync debug mode "error" shows that none reads from the device; the same
   tables on the card give the same output bit for bit), held to its plain
   version in bf16 within 2e-2 and within 1e-2 of the largest output, and
   on the same tables in f32 within 2e-5; timed as in phase 4 with host and
   with card tables, its two kernels alone (the launch that ``prepare``
   gives) and the wrapper's host time, beside its plain version, its bound
   (K and V of the live rows, q, out and the page ids at 3.35 TB/s) and
   ``scaled_dot_product_attention`` over the same K/V gathered into a
   contiguous cache (no PyTorch call reads paged K/V).  Its ``launches``
   are those of the drain checks of phases 6 and 10: the engine itself
   decodes over a dense cache.
14. Run right after phase 4, on phase 3's graph and oracle (Cv = Ce =
   2^23): the delta CSR maintenance and the baseline engines.  Four fold
   epochs (eight before phase 22 came), one 65,536-op batch each
   (``traversal`` and ``update`` mixes in turns), queued on the cached
   snapshot and folded by the next
   ``traversal_csr()`` (timed, host clock ended by a sync, beside
   ``build_csr``), which must take the device merge (``masked_compact`` and
   ``hash_probe`` launched, no host splice) and equal ``build_csr`` and the
   host splice field for field, with ``reachable`` on 32 pairs equal to the
   oracle (each epoch also times the fold's host dedup alone); one more
   fold runs under the profiler.  A growth epoch: one batch of edge adds
   past the edge table's load factor (its dedup timed beside ``np.unique``
   of its edge codes); the grown snapshot must be the queue's base, the next
   ``traversal_csr()`` equal ``build_csr``, and ``rehash(with_csr=True)``
   from the final size (timed in turns with the plain rehash) equal the host
   rehash and ``build_csr`` of its state.  Then the engines from one
   pre-state (the grown state), per Fig. 4 mix: ``apply_lockfree`` at
   65,536 lanes, ``apply_serial`` and ``apply_coarse`` at 128 (serial at
   512, the cap of ``benchmarks/graph_throughput.py``, before phase 22
   came), the wait-free and FPSP engines at 128, 512 and 65,536, each timed
   (ops/s), its bits and live set equal to the oracle after the same lanes,
   and the lock-free rounds reported.  The
   launch counts are read around this phase: every graph kernel must run.
   The ``kernels`` line gains a ``masked_compact`` row at the fold's shape
   (the survivors' 3 rows of 2^23 lanes), and each graph row the launches
   of this phase (``launches_delta_path``).
15. Run right after phase 14: the hash-prefix sharded graph at the same
   scale, four logical shards on the card.  ``WaitFreeGraph(n_shards=4)``
   at its default capacities (256 vertex and 1,024 edge slots a shard)
   takes phase 3's build stream from the same seed, its vertex loads and
   first 16 traversal batches (all 80 before phase 22 came), every batch's bits
   checked against a sequential oracle fed the same batches; it grows
   shard by shard through the endpoint rehash.  The growth steps, the
   sub-batch balance, the build's ``apply`` time and one timed window of
   ``apply`` a Fig. 4 mix (with a profile of three balanced batches) are
   printed, and the snapshot must equal the oracle's.  Then the fused
   snapshot: ``traversal_csr()`` (the device fuse), then the device and the
   host fuse (``impl="host"``) timed once each and equal field for field,
   ``n_edges`` and ``n_live`` equal to the oracle, and the queries of phase
   3 checked the same way.  ``WaitFreeGraph(n_shards=2, mode="fpsp")`` on
   the stream's first 30 batches must give the 4-shard bits.  Telemetry:
   one- and four-shard FPSP graphs with ``obs=True`` (edge tables of 2^21
   slots, which must not grow after the vertex loads) on the first 26
   batches (the vertex loads and 8 traversal batches; the vertex loads
   alone would leave the stab and edge phases nothing to do) give the
   4-shard bits, equal shard-invariant counters and equal directory probe
   histograms, and the four-shard graph's span table (host wall ms of each
   pipeline phase and of ``csr.fuse``) is printed.  Every graph kernel must
   launch in the phase; each graph row of the ``kernels`` line gains its
   launches here (``launches_sharded_path``).
16. granite-moe-3b-a800m (moe; hf:ibm-granite/granite-3.0-1b-a400m-base) at
   full width (32 layers, d_model 1536, GQA 24/8 of 64, 40 experts top-8 of
   width 512, vocab 49155), as phase 6 with these changes.  The MoE
   dispatch of the prefill's first and last layer, on their own inputs, must
   equal a numpy twin on the card's router probabilities (top-k with ties to
   the lower index, slots in (expert, phase) order, drops past the capacity)
   int for int in ``gate_idx``, ``keep`` and the slots; the share of pairs
   dropped is reported for the prefill and for each serving tick.  In place
   of "decoded alone" (a request alone meets other capacity drops than in a
   batch, as in the reference), the same traffic on a second fresh engine
   must give the same tokens.  ``flash_attention`` is then timed at the
   prefill's shape (B 2, Hq 24, Hkv 8, S 4,096, D 64, causal) as in phase 7.
17. mixtral-8x7b (moe; arXiv:2401.04088) at full width (d_model 4096, GQA
   32/8 of 128, 8 experts top-2 of width 14,336, window 4,096), 8 of its 32
   layers (about 24 GB; 16 before phase 22 came; all 32 would be about 93
   GB, past the card's 80), as
   phase 16, with a prefill of 2 x 8,192 tokens so that the window masks
   keys; ``flash_attention`` timed at B 2, Hq 32, Hkv 8, S 8,192, D 128,
   causal, window 4,096, beside SDPA with the window's boolean mask.
18. llama-3.2-vision-11b (vlm; hf:meta-llama/Llama-3.2-11B-Vision) at full
   width (a gated cross-attention block after every 5 layers, GQA 32/8 of
   128, vocab 128256), 5 of its 40 layers (all 40 before phase 22's
   sequence-parallel run came, then 10 until its decode came), both tanh
   gates and 4,096 image tokens of d_model drawn nonzero from the seed: the
   prefill (with the image tokens) launches ``flash_attention`` non-causal
   at Sq = Sk = 4,096 once beside the 5 causal self-attention launches.
   16 prompt tokens decoded one at a time over the cross K/V that
   ``decode_init`` precomputes must give the prefill's logits at every
   position within 3e-2 relative L2 on an f32 copy of the first group (5
   layers, its cross block, ``ln_f`` and the head; the decode launches the
   kernel at Sq 1 against 4,096 keys); the whole bf16 model's figure is
   reported.  Serving is text-only, as in the
   reference, with all of phase 6's checks; ``flash_attention`` is timed at
   the cross-attention shape (B 2, Hq 32, Hkv 8, Sq = Sk = 4,096, D 128,
   non-causal).
19. musicgen-medium (audio; arXiv:2306.05284) at full width (6 of its 48
   layers, all 48 before phase 22's sequence-parallel run came, then 12,
   d_model 1536, MHA 24 of 64, 4 codebooks of 2,048, layernorm with bias,
   GeLU, sinusoid positions): a prefill of 2 x 4,096 frames x 4 codebooks,
   whose (B, 1, 4, Vp) logits are held as phase 6 holds its own; serving
   with (P, 4) prompts and all of phase 6's checks; ``flash_attention``
   timed at B 2, H 24, S 4,096, D 64, causal.
20. Training zamba2-1.2b at full width (20 of its 38 mamba2 layers: 3
   groups of 6, each followed by the shared block, and a tail of 2, as at
   full width; all 38 before phase 22's recurrent runs came; vocab
   32,000), weights drawn on the card from
   ``--seed``.  Both kernels run forward under autograd, inside the
   ``torch.autograd.Function`` of their ``ops.py``, whose backward
   recomputes and differentiates the plain version (``repro`` has no
   backward kernel; XLA differentiates its plain code).  (a) The f32
   gradient gate: on an f32 copy of the first 6 layers' weights (one
   group and its application of the shared block), one microbatch of 1 x
   4,096 tokens of ``LM.loss`` and its backward through the kernels and
   with both plain versions forced: the loss within 1e-5 relative and every
   parameter leaf's gradient within 1e-3 relative L2 (the worst leaf
   printed).  (b) bf16 training: ``TrainRunner``'s step function
   (``build_train_step``, accum 2, ``AdamWConfig(warmup_steps=1)``) for 2
   steps of 4 x 4,096 tokens from ``SyntheticTokenStream``; every loss and
   gradient norm finite, a line a step (loss, grad_norm, lr, s, tokens/s),
   step 1 under the profiler (the card's activity only: busy share,
   launches, heaviest kernels) and step 2 timed; each step's
   ``flash_attention`` and ``ssd_scan`` launches equal to the count the code
   derives (each call twice under remat: the forward and the backward's
   recompute); the loss of step 1's batch lower after the 2 steps than at
   step 1; the peak device memory.  (c) Resume, bit for bit, under
   ``torch.use_deterministic_algorithms(True)`` (``CUBLAS_WORKSPACE_CONFIG``
   is set before CUDA starts), cut to the first group (6 mamba2 layers and
   one shared-block application; the whole state would be a 17 GB
   checkpoint on disk): run A trains 2 steps and saves its state at step 1
   into a directory under ``build/`` that the phase deletes, run B, a fresh
   ``TrainRunner``, restores it and trains to step 2; parameters, m, v,
   master, count and the data step equal; the checkpoint's bytes and save
   and restore seconds printed.  The zamba2-1.2b ``flash_attention`` and
   ``ssd_scan`` rows of the ``kernels`` line gain the phase's launches
   (``launches_train_path``; the f32 gate's are not counted) and the time of
   one call of their backward, the plain version's gradient, at a
   microbatch's shapes (``plain_backward_ms``).
21. The dry run (``repro_torch.launch.dryrun.run_cell``) of the steps that
   phases 6 and 20 ran: qwen2-7b's prefill of 2 x 4,096 and zamba2-1.2b's
   train step (20 layers) of 4 x 4,096 at accum 2, bf16, counted on ``meta`` in a worker
   process on the host while the card runs phase 20 (it needs no card).
   Its argument bytes must equal the bytes of the tensors the phase passed
   to its step (the parameters, the optimizer state, the batch), its
   arguments plus temporaries be within 15% of the phase's
   ``max_memory_allocated``, and its budget (``dryrun.H100_BYTES``) within
   the card's ``total_memory``.  Printed beside them: its ops against the
   phase's launches, and its flops over the phase's median time as TFLOP/s
   and a share of 989 TFLOP/s bf16 dense, with the card's name and power
   limit.

22. Several ranks on one mesh (``parallel/mesh.py``, ``parallel/spec.py``,
   ``parallel/collectives.py``, ``launch/shardings.py``), every launch count
   read around the phase ((b)'s summed over its ranks).  (a) A world of one rank on NCCL, a (1, 1)
   ("data", "model") mesh: granite-moe-3b-a800m at full width and depth on
   phase 16's prefill (2 x 4,096, parameters and prompt from the seed): the
   ``sp`` prefill through ``moe_apply_shardmap`` on the rank's blocks gives
   the one-device prefill's hidden states, balancing loss and logits bit for
   bit, two ``decode_moe_shardmap`` decode steps the same logits, and
   ``compressed_psum`` over the NCCL world its quantized mean and residual;
   a list all-gather of 256 MiB issued as ``parallel/collectives.py``
   issues it must stage exactly the result's size on the card (what the dry
   run on a description counts; gloo's staging is held by (b)'s dry run).
   (b) Four ranks, one process each, sharing the card over gloo (NCCL takes
   one rank a card), a (2, 2) mesh: granite at full width cut to 1 layer,
   a global batch of 4 x 4,096, every rank holding its FSDP/TP blocks.  Each
   data shard's ``sp`` prefill (the sequence-parallel layout: each rank
   2,048 tokens of its rows) against the one-device prefill of its rows: an
   f32 copy within 1e-5 relative L2 of the logits, bf16 within 2e-2; layer
   0's dispatch against the one-device dispatch, a token's top-k (in order)
   allowed to differ only where the one-device router's first k + 1
   probabilities come within 1e-5 of one another (the layout runs the
   projections on the rank's tokens, so the router's input may round
   otherwise and a near tie fall the other way; the widest such margin that
   differed is printed), and every layer's dispatch int for int with the
   numpy twin on the rank's own router probabilities (with more layers,
   the later layers' differences from one device are printed); an f32
   train step (``build_train_step(mesh=...)``, accum 1, the token
   stream's rows of the rank's data coordinate), every gradient leaf within
   1e-3 relative L2 of one device (phase 20's gate; the oracle, on rank 0,
   runs each data shard's rows alone, as the sharded MoE dispatches
   token-locally, and steps its own whole state with the gathered
   gradients),
   under the profiler (the ranks' kernel time summed over the
   slowest rank's wall time) with its collectives timed; that step's
   ``compressed_psum`` of three gradient leaves over the world, alike on
   every rank and equal to numpy on the host bit for bit; a checkpoint (the
   f32 parameters and the optimizer state: m, v, master and the count)
   saved on (2, 2), a leaf and a layer at a time, and restored on a (4, 1)
   mesh of the same world and on one device, bit for bit.  (c) The 4-shard
   graph on the mesh [cuda:0, cpu] against the 4 shards on the card, over
   the first 8 batches of phase 15's stream and its first 2 traversal
   batches: each batch's answers and every shard's tables, then the fused
   snapshot and ``reachable`` on 256 pairs, bit for bit.  (b)'s ranks then
   run the sequence-parallel layout of a dense model: qwen2-7b at full
   width cut to 2 layers, a global batch of 2 x 4,096, on the (2, 2) mesh
   (each rank 2,048 tokens of one row) and a (1, 4) mesh of the same world
   (1,024 tokens of each row): the prefill in bf16 on (2, 2), within 3e-2
   relative L2 of the one-device prefill of the rank's rows, and in f32 on
   (1, 4), within 1e-5; the f32 loss within 1e-5 relative and every
   gradient leaf within 1e-3 relative L2 of one device on the global batch
   (each rank's blocks; the one-device oracle runs on one rank at a time);
   the attention kernel launched at ``q_offset`` != 0 (counted); each
   rank's card memory above its resident state at the peak of the bf16
   prefill beside the same prefill with ``sp`` off (every dense weight
   gathered whole for the step), and of the f32 loss and gradients; and
   the dry run (``launch/dryrun.py`` on a (2, 2) ``MeshDescription``
   standing for each rank, counted in phase 21's worker processes while the
   card runs phase 20)
   predicting each rank's argument bytes of the bf16 prefill on (2, 2)
   exactly, and its arguments plus temporaries within 15% of the measured
   peak.  Then decode on (2, 2) in the striped-cache layout
   (``build_decode_step(mesh=)``: the cache's T striped over "model", the
   partial softmaxes merged, one layer's weights gathered at a time): the
   same qwen2-7b from one random cache at len 4,096 of T 8,192 drawn from
   the seed (each rank its stripe of 4,096 rows of its row), 3 bf16 and 3
   f32 steps against one device's decode of the rank's rows (its greedy
   tokens fed to both; in f32 on one rank at a time): f32 logits within
   2e-5 relative L2 and greedy tokens equal (a one-device top-2 margin
   below 1e-5 excepted, and printed), bf16 within 3e-2, the rank's cache
   blocks after the steps within the same limits, and every model rank's
   logits bit for bit; each rank's memory at the first bf16 step beside the
   same step with every weight gathered whole and the cache's T whole, and
   the dry run of that step (counted with the prefill's) held as the
   prefill's is; then zamba2-1.2b's first group (6 mamba2 layers and the
   shared block) at full width in f32, 3 steps from random states and a
   random ``shared_kv`` of the same lengths, the states on their blocks,
   within 2e-5 of one device.  Then the recurrent stacks in the d-sharded
   layout (``models/lm.py``: the residual's d over "model" between layers,
   each layer's heads dealt over it), f32, parameters and a global batch
   of 2 x 4,096 from the seed: zamba2-1.2b's first group on (2, 2) (32 of
   its 64 heads a rank) and rwkv6-3b at 2 of its 32 layers on (1, 4) (10 of
   its 40 heads a rank): the prefill of each rank's rows within 1e-5
   relative L2 of one device's (and with ``sp`` off, every dense weight
   gathered whole, the same), ``ssd_scan`` on each rank's first and last
   scan inputs at its head count held to its plain version within 1e-4,
   the loss on the global batch within 1e-5 relative, and every gradient
   leaf of each within 1e-3 relative L2 (the one-device oracles on one
   rank at a time); each rank's card memory at the prefill's peak beside
   the same prefill with ``sp`` off, and the dry run of zamba2's prefill
   on a (2, 2) description held as the dense prefill's.  The ``kernels``
   line gains ``flash_attention`` timed at the last
   of 4 blocks of qwen2-7b's prefill (Sq 1,024 at ``q_offset`` 3,072
   against 4,096 keys), with phase 22's launches at an offset.

The last line is ``{"ok": true, "device": {...}}``; the line before it the
``kernels`` record.  Without a card, or outside a checkout of the repository,
it exits non-zero and prints no result.
"""

from __future__ import annotations

import os

# cuBLAS needs a fixed workspace for deterministic products (phase 20's
# resume runs under torch.use_deterministic_algorithms), set before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import argparse  # noqa: E402
import contextlib  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import multiprocessing  # noqa: E402
import re  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.attention.bias  # noqa: E402

ROOT = Path(__file__).resolve().parent
if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
    sys.exit(f"chip_smoke: {ROOT} is not a checkout of the repository")
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (  # noqa: E402
    OP_ADD_EDGE, OP_ADD_VERTEX, GraphState, SequentialGraph, WaitFreeGraph, baselines, engine,
    fastpath, hashing, maintenance, run_sequential, traversal,
)
from repro_torch.core.graph import _used_slots  # noqa: E402
from repro_torch.core.hashing import hash_vertex, probe_slot  # noqa: E402
from repro_torch.core.locate import claim_vertex_slots  # noqa: E402
from repro_torch.core.traversal import _edge_validity, bfs_levels, build_csr  # noqa: E402
from repro_torch.core.types import GROW_LOAD_FACTOR, MAX_PROBES, make_batch  # noqa: E402
from repro_torch.core import sharding  # noqa: E402
from repro_torch.core.workloads import sample_batch, shard_balance  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.compact import kernel as ck  # noqa: E402
from repro_torch.kernels.compact import masked_compact, probe_place  # noqa: E402
from repro_torch.kernels.compact import ops as compact_ops  # noqa: E402
from repro_torch.kernels.compact.ref import probe_place_device_rounds  # noqa: E402
from repro_torch.kernels.flash_attention import attention  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fak  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402
from repro_torch.kernels.frontier import frontier_expand  # noqa: E402
from repro_torch.kernels.frontier import kernel as fk  # noqa: E402
from repro_torch.kernels.hash_probe import hash_probe  # noqa: E402
from repro_torch.kernels.hash_probe import kernel as hk  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as pak  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as ssk  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as ssd_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.data import DataConfig, SyntheticTokenStream  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.shardings import cache_pspecs, data_rows  # noqa: E402
from repro_torch.parallel import collectives as mesh_collectives  # noqa: E402
from repro_torch.parallel.mesh import MeshDescription, make_host_mesh  # noqa: E402
from repro_torch.parallel.spec import local_shard  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    build_decode_step, build_prefill_step, build_run, build_train_step)
from repro_torch.launch.train import TrainRunner  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import blocks as model_blocks  # noqa: E402
from repro_torch.models import layers as model_layers  # noqa: E402
from repro_torch.models.lm import ring_record  # noqa: E402
from repro_torch.models.module import param_bytes, param_count, tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, opt_pspecs  # noqa: E402
from repro_torch.optim.compress import compressed_psum, ef_init  # noqa: E402
from repro_torch.obs import probes as obs_probes  # noqa: E402
from repro_torch.serving import PagedKVManager, Request, ServingEngine  # noqa: E402

# the kernel wrappers, whose launch and call counts the main paths are read by
WRAPPERS = {
    "hash_probe": hk.hash_probe, "masked_compact": ck.masked_compact,
    "probe_place": ck.probe_place, "frontier_expand": fk.frontier_expand,
    "flash_attention": fak.flash_attention, "ssd_scan": ssk.ssd_scan,
    "paged_attention": pak.paged_attention,
}
GRAPH_PATH = ("hash_probe", "masked_compact", "probe_place", "frontier_expand")
# serving: the page table's locate and growth rehash, each model's prefill
# kernels, and the paged decode on the drain's block tables
PAGE_TABLE = ("hash_probe", "masked_compact", "probe_place")
SERVE_PATH = ("flash_attention", "paged_attention") + PAGE_TABLE
RWKV_PATH = ("ssd_scan",) + PAGE_TABLE
ZAMBA_PATH = ("ssd_scan", "flash_attention", "paged_attention") + PAGE_TABLE
TRAIN_PATH = ("flash_attention", "ssd_scan")  # phase 20: training zamba2-1.2b

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
ALU_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores, the
                            # integer lanes' stand-in (the sheet has no int32 row)
BF16_OPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
TF32_OPS_PER_S = 495e12     # H100 SXM TF32 tensor cores, dense
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
EXP_PER_S = F32_OPS_PER_S / 16  # the SFUs: 16 exps a clock per SM against the
                                # 128 f32 lanes' 256 flops a clock behind 67e12

COM_YOUTUBE_VERTICES = 1_134_890
BATCH = 65_536
TRAVERSAL_BATCHES = 80
TIMED_BATCHES = 10
FIG4_MIXES = ("lookup", "balanced", "update")
FOLD_EPOCHS = 2             # 8 before phase 22 came, then 4: cut for its time
FOLD_MIXES = ("traversal", "update")  # in turns, epoch by epoch
FOLD_PAIRS = 32
# phase 14's engines, each at its lanes from one pre-state: lock-free at the
# batch, coarse and serial at 128 (one op at a time; coarse pays a read back
# an op; serial ran at 512 before phase 22 came, 9 s a mix, cut for its time),
# and the wait-free and FPSP engines at 128, 512 and the batch
BASELINE_LANES = {"lockfree": BATCH, "serial": 128, "coarse": 128}
ENGINE_FNS = dict(baselines.ENGINES, waitfree=engine.apply_batch,
                  fpsp=fastpath.apply_batch_fpsp)
ENGINE_RUNS = [(name, lanes) for name, lanes in BASELINE_LANES.items()] + [
    (name, lanes) for name in ("waitfree", "fpsp") for lanes in (128, 512, BATCH)]
PLACE_M, PLACE_CAP = 1 << 21, 1 << 22  # the vertex rehash from 2^21 to 2^22 slots
SHARDS = 4                   # phase 15's shard count, logical shards on one card
SHARDED_TRAVERSAL_BATCHES = 16  # phase 15's build: phase 3's first 16 traversal
                                # batches (80 before phase 22 came, then 32: cut for
                                # its time)
SHARDED_FPSP_BATCHES = 30    # phase 15's 2-shard FPSP run: the stream's first batches
OBS_BATCHES = 26             # phase 15's telemetry: the vertex loads and 8 traversal batches
# ... on edge tables (2^21 slots in all) that those 8 batches' ~315,000 edge
# adds do not outgrow: a growth after the first removal drops tombstones, so
# ``engine.inserted`` (new physical slots) would then depend on when each
# shard count grew; growth during the vertex loads reclaims nothing, and the
# phase fails if either graph grows after them
OBS_E_CAPACITY = 1 << 21
# tests/test_obs.py's counters that do not depend on the shard count
SHARD_INVARIANT_COUNTERS = ("apply.batches", "apply.ops", "engine.vops", "engine.eops",
                            "engine.inserted", "fastpath.eops", "fastpath.edge_dup")
SPAN_TABLE = ("graph.apply_sharded", "phase.route", "phase.settle_vertices",
              "phase.answer_stabs", "phase.gather", "phase.settle_edges", "phase.compact",
              "csr.fuse")
FRONTIER_DEPTH = 3           # phase 4's frontiers: the BFS level 3 of their sources
L2_FLUSH_BYTES = 256 << 20  # five times the H100's 50 MB L2
SECTOR_BYTES = 32           # the unit a gather moves from device memory
PROBE_SECTOR = SECTOR_BYTES // 4  # int32 slots of a sector
HOLD_CYCLES = 400_000       # about 0.2 ms of the card's clock: longer than a wrapper's host time

# flash attention against its plain version: tests/test_kernels.py's sweep
# and tolerances, plus a GQA group of 7 at D = 128 off the 64-row tile, rows
# whose window lies wholly past Sk (every key masked), and the edges of the
# bf16 kernel's 128-row tiles and 64-column boxes: Sq and Sk of 1, 127, 128,
# 129 and 4,100, Sq != Sk both ways, D of 8, 64, 72, 120 and 128, and 1,200
# blocks of (q tile, head, batch)
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
FLASH_SHAPES = [  # (B, Hq, Hkv, Sq, Sk, D, causal, window)
    (1, 2, 2, 32, 32, 16, True, None),
    (2, 4, 2, 64, 64, 32, True, None),
    (1, 8, 1, 32, 32, 64, True, None),
    (2, 4, 2, 64, 64, 32, True, 16),
    (1, 2, 2, 16, 48, 32, False, None),
    (1, 2, 2, 32, 40, 16, True, None),
    (1, 14, 2, 100, 100, 128, True, None),
    (1, 2, 1, 64, 16, 32, True, 8),
    (1, 2, 2, 1, 1, 64, True, None),
    (1, 2, 2, 127, 127, 128, True, None),
    (1, 2, 2, 128, 128, 72, True, None),
    (1, 4, 4, 129, 129, 8, True, None),
    (1, 7, 1, 4100, 4100, 128, True, None),
    (1, 2, 2, 129, 300, 120, False, None),
    (1, 2, 2, 300, 129, 64, True, None),
    (1, 14, 2, 1, 4100, 128, False, None),
    (1, 2, 1, 200, 60, 64, True, 16),
    (2, 600, 600, 16, 16, 64, True, None),
]
# the bf16 kernel is also held per block of 128 q rows of one head (its q
# tile): the relative L2 error of the block against the plain version.  At
# S 4096 a late row's outputs are about as small as the 2e-2 limit above, so
# a tile of stale K/V there could pass it; a right kernel reads 2e-3 to 3e-3
# here (bf16 rounding of P and of the output).  Applied where Sq >= 1,024.
FLASH_BLOCK_REL_TOL = 1e-2
FLASH_BLOCK_ROWS = 128
# q blocks at an offset, (B, Hq, Hkv, Sq, Sk, D, causal, window, q_offset):
# offsets off the f32 (64-row) and bf16 (128-row) tiles, on a tile, a window
# of 4,096 crossing tiles and one narrower than a tile, a group of 7 at the
# last of 4 blocks of 4,096, Sq < Sk at offset 0, non-causal
FLASH_OFFSET_SHAPES = [
    (1, 2, 2, 100, 300, 64, True, None, 200),
    (1, 4, 2, 129, 700, 128, True, None, 517),
    (1, 14, 2, 1024, 4096, 128, True, None, 3072),
    (1, 7, 1, 1100, 5000, 128, True, None, 3839),
    (1, 4, 1, 1100, 9000, 128, True, 4096, 7900),
    (2, 4, 4, 64, 1000, 72, True, 100, 63),
    (1, 2, 2, 64, 300, 64, True, 16, 0),
    (1, 2, 2, 77, 500, 64, False, None, 11),
]
# masked_compact across many of the kernel's 4,096-lane tiles (the look-back)
COMPACT_MANY_TILES = [(1, (1 << 23) + 17, 0.5), (6, 4097, 0.01), (1, 4095, 1.0), (6, 1, 1.0)]
# probe_place's adversarial cases (cap, m, homes, max_probes, active share):
# contention over 4 homes, partial activity, the overflow at 2 probes, m off
# every block size, m of 1, 2^20 + 3 lanes (called 20 times in a row)
PLACE_SMALL = [(1024, 500, None, 32, 0.9), (256, 60, 4, 32, 0.9), (32, 40, None, 2, 1.0),
               (1024, 515, None, 32, 0.9), (64, 1, None, 32, 1.0), (256, 256, 4, 32, 1.0),
               (1 << 21, (1 << 20) + 3, None, 32, 0.9)]
PLACE_REPEAT_M, PLACE_REPEATS = (1 << 20) + 3, 20

LM_ARCH = "qwen2-7b"
SSM_ARCH, HYBRID_ARCH = "rwkv6-3b", "zamba2-1.2b"
PREFILL_BATCH, PREFILL_LEN, PREFILL_RUNS = 2, 4096, 3
LOGITS_REL_L2 = 3e-2        # kernel prefill against plain-attention prefill
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_PAGE = 8, 512, 16
SERVE_REQUESTS, SERVE_NEW, SERVE_PROMPT = 16, 32, (16, 64)
SERVE_ALONE = (0, 2)        # greedy requests admitted at tick 0, in slots 0 and 2
PROFILE_TICKS = 6
# phases 16-19: the moe, vlm and audio families at published width
GRANITE_ARCH, MIXTRAL_ARCH = "granite-moe-3b-a800m", "mixtral-8x7b"
VLM_ARCH, AUDIO_ARCH = "llama-3.2-vision-11b", "musicgen-medium"
# mixtral's 32 layers are about 93 GB in bf16, past the card's 80: 8 of them
# (about 24 GB) are run, a cut in depth only (16 before phase 22 came, cut
# for its time; at 4 layers the bf16 prefill missed its plain version by
# 0.589 relative L2, a top-1 flipped: random routing amplifies rounding)
MIXTRAL_LAYERS = 8
MIXTRAL_PREFILL_LEN = 8192  # twice its 4,096 window, so the window masks keys
# cut for the time of phase 22's sequence-parallel run, where the gates are
# on an f32 copy (rwkv6-3b, zamba2-1.2b) or on dense bf16 stacks that do not
# amplify rounding (llama-3.2-vision, musicgen): rwkv6-3b 32 -> 8 layers,
# zamba2-1.2b 38 -> 20 (3 groups of 6, each with the shared block, and a
# mamba2 tail of 2, as at full width), llama-3.2-vision 40 -> 10 (2 groups
# of 5 and their cross blocks), musicgen 48 -> 12; and for the time of its
# decode runs: rwkv6-3b 8 -> 2, zamba2-1.2b 20 -> 14 (2 groups and the
# tail), musicgen 12 -> 6 (at 3 one of its 8 prefill top-1s flipped
# against the plain version's); llama-3.2-vision keeps its 2 groups, so
# that the walk from one group's cross block into the next runs
SSM_LAYERS, HYBRID_LAYERS, VLM_LAYERS, AUDIO_LAYERS = 2, 14, 10, 6
XATTN_DECODE_TOKENS = 16    # phase 18's decode over the cross K/V against the prefill

# ssd_scan against its plain version: tests/test_kernels.py's sweep and
# tolerances, plus K = V = 128, S = 100 (chunk 4), an odd S (chunk 1) and S
# of one chunk (no state carried between chunks)
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
SSD_SHAPES = [  # (B, H, S, K, V, chunk)
    (1, 2, 64, 8, 8, 16),
    (2, 3, 128, 16, 24, 32),
    (2, 2, 128, 32, 32, 64),
    (1, 1, 256, 64, 64, 64),
    (1, 2, 128, 128, 128, 64),
    (2, 2, 100, 16, 16, 4),
    (1, 3, 37, 8, 24, 1),
    (2, 2, 64, 64, 64, 64),
]

# paged_attention against its plain version: tests/test_kernels.py's sweep
# and tolerances, plus a GQA group of 7 at D = 128, a group of 1 at D = 64,
# and sequences over many tiles and splits
PAGED_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
PAGED_SHAPES = [  # (B, Hq, Hkv, D, P, page_size, pages_per_seq)
    (2, 4, 4, 16, 8, 8, 2),
    (3, 8, 2, 32, 16, 8, 4),
    (1, 12, 1, 64, 8, 16, 3),
    (2, 14, 2, 128, 16, 16, 4),
    (3, 4, 4, 64, 12, 16, 3),
    (4, 28, 4, 128, 1100, 16, 260),
]
PAGED_EVERY, PAGED_MIN_CHECKS = 8, 4  # the drain's checks: every 8th tick, at least 4
# at phase 13's lengths an output is about sqrt(e / S), 0.01-0.02: as small as
# the bf16 limit, so there the bf16 error is also held to the outputs' scale
# (max abs err over max |plain|), and the same tables run once in f32
PAGED_FULL_REL_TOL = 1e-2
# phase 13: one decode step's attention at full width, 16 sequences, on
# block tables of the port's page table; lengths up to qwen2-7b's native
# context of 32,768 (arXiv:2407.10671), and 1,024-4,096 for zamba2-1.2b
PAGED_DECODE_BATCH, PAGED_PRELOAD = 16, 24
PAGED_LENS = {LM_ARCH: (4096, 32768), HYBRID_ARCH: (1024, 4096)}

# phase 20: training zamba2-1.2b at full width (its train state, about 17 GB
# of bf16 weights and f32 m, v and master, fits one card; the reference's
# TRAIN_ACCUM of 2), from the token stream of --seed
TRAIN_ARCH = HYBRID_ARCH
# 20 of its 38 layers (3 groups of 6, each with the shared block, and a
# mamba2 tail of 2, as at full width): cut from 38 for the time of phase 22
# (b)'s recurrent runs (about 46 s); the phase's gates do not amplify
# rounding (finite losses, the loss lower after the steps, launch counts)
TRAIN_LAYERS = 20
# a step took 26-30 s on the card, the plain backward most of it; 2 steps (3
# before phase 22 came: cut for its time), the first profiled, so the second,
# timed alone, is a step past the first call's warm-ups
TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM, TRAIN_STEPS = 4, 4096, 2, 2
TRAIN_PROFILE_STEP = 1          # the step run under the profiler
TRAIN_OPT = dict(warmup_steps=1)
GATE_BATCH = 1                  # the f32 gradient gate's microbatch: 1 x 4,096
# the gate runs the first group (6 mamba2 layers and an application of the
# shared block): both kernels' backward at the step's shapes (all 38 layers
# before phase 22's checkpoint grew, then 12: cut for phase 22's time)
GATE_LAYERS = 6
GATE_LOSS_RTOL, GATE_GRAD_REL_L2 = 1e-5, 1e-3
# the resume runs are cut to the first group (6 mamba2 layers and one
# shared-block application): the whole model's state would be a 17 GB
# checkpoint on disk, twice
# (run A 2 steps saving step 1, run B 1 step; 4 and 2 before phase 22 came)
RESUME_LAYERS, RESUME_AT, RESUME_STEPS = 6, 1, 2

# phase 21: the dry run (``repro_torch.launch.dryrun``) of the steps that
# phases 6 and 20 ran, counted on the host in a worker process while the
# card runs phase 20 (the count needs no card, and takes about a minute)
DRYRUN_CELLS = {
    "prefill": (get_config(LM_ARCH), dict(seq_len=PREFILL_LEN, global_batch=PREFILL_BATCH,
                                          kind="prefill")),
    "train": (get_config(TRAIN_ARCH).scaled(n_layers=TRAIN_LAYERS),
              dict(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, kind="train")),
}
DRYRUN_PEAK_RTOL = 0.15  # its arguments and temporaries against the phase's peak
DRYRUN_WAIT_S = 600

# phase 22: several ranks on one mesh.  (a) one rank on NCCL, a (1, 1) mesh,
# granite at full width and depth on phase 16's prefill; (b) four ranks
# sharing the card over gloo, a (2, 2) ("data", "model") mesh, granite at
# full width cut to 2 layers (4 until its checkpoint took the optimizer
# state too: 8.87 GB written and read three times), a global batch of
# 4 x 4,096; (c) the 4-shard graph on the mesh [cuda:0, cpu]
MESH_ARCH = GRANITE_ARCH
MESH_SHAPE, MESH_LAYERS, MESH_BATCH = (2, 2), 1, 4
MESH_ROUTER_TIE = 1e-5       # (b): a near tie of router probabilities rounding may break
MESH_STAGING_BYTES = 256 << 20  # a list all-gather's result whose staging is measured
MESH_RANKS = MESH_SHAPE[0] * MESH_SHAPE[1]
MESH_F32_REL_L2, MESH_BF16_REL_L2 = 1e-5, 2e-2   # (b)'s prefill against one device
# one f32 step (2 until phase 22's decode came: cut for its time), one
# microbatch a step: half the gathers; the step's gradients are held to one
# device, and the parameters it leaves to a one-device AdamW on the same
# gradients (tests/test_torch_tp.py's rule against repro)
MESH_TRAIN_STEPS, MESH_ACCUM = 1, 1
MESH_PARAMS_REL_L2, MESH_PARAMS_SMALL = 2e-4, 1e-6
MESH_COMPRESS_LEAVES = ("blocks/attn/wq", "blocks/ffn/router", "ln_f/scale")
MESH_TIMEOUT_S = 300         # a collective that waits longer raises
MESH_GRAPH_LOADS, MESH_GRAPH_TRAVERSALS = 8, 2  # (c): phase 15's first batches
MESH_PATH = ("flash_attention", "ssd_scan") + GRAPH_PATH
# (b)'s dense run in the sequence-parallel layout: qwen2-7b at full width
# cut to 2 layers, a global batch of 2 x 4,096, on the (2, 2) mesh and, for
# the prefill, a (1, 4) mesh of the same world
MESH_DENSE_ARCH, MESH_DENSE_LAYERS, MESH_DENSE_BATCH = LM_ARCH, 2, 2
MESH_SEQ_SHAPE = (1, 4)
MESH_DENSE_BF16_REL_L2 = 3e-2
SP_BLOCKS = MESH_SEQ_SHAPE[1]  # the kernels line's row at an offset: the last of 4 blocks
# (b)'s decode in the striped-cache layout on (2, 2): qwen2-7b (the dense
# run's 2 layers) and zamba2-1.2b's first group (6 mamba2 layers and the
# shared block, f32), each from a random cache at len 4,096 of T 8,192
MESH_DECODE_T, MESH_DECODE_LEN, MESH_DECODE_STEPS = 8192, 4096, 3
MESH_DECODE_F32_REL_L2 = 2e-5  # f32 logits against one device (bf16: MESH_DENSE_BF16_REL_L2)
MESH_DECODE_TIE = 1e-5       # a greedy token may differ only below this top-2 margin
MESH_HYBRID_LAYERS = 6       # zamba2-1.2b's first group
# (b)'s recurrent runs in the d-sharded layout, f32: zamba2-1.2b's first
# group on the (2, 2) mesh (32 of its 64 heads a rank) and rwkv6-3b at 2 of
# its 32 layers on the (1, 4) mesh (10 of its 40 heads a rank), a global
# batch of 2 x 4,096; the limits of the dense run's f32 gates
MESH_SSM_LAYERS, MESH_RECURRENT_BATCH = 2, 2
BF16_DENSE_FLOPS = 989e12  # H100 SXM, bf16 dense, at 700 W (NVIDIA data sheet)


def log(msg: str) -> None:
    print(msg, flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def cuda_ms(fn, reps: int, warmup: int = 1, setup=None, flush: bool = True) -> float:
    """Median CUDA-event time of one ``fn(*setup())`` in milliseconds, with
    the L2 cache flushed before each run, so every input comes from device
    memory as the bounds assume.  The flush is still running on the card
    while the host enters ``fn``, so the window holds the device's work, not
    the wrapper's host time (where that is shorter than the flush).
    ``flush=False`` keeps the L2 as the previous run left it (warm) and
    holds the card in a spin of ``HOLD_CYCLES`` instead, which touches no
    memory, for the same reason."""
    scrub = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn(*(setup() if setup else ()))
    times = []
    for _ in range(reps):
        args = setup() if setup else ()
        if flush:
            scrub.zero_()
        else:
            torch.cuda._sleep(HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_s(fn):
    """(result, seconds) of ``fn()`` on the host clock, ended by a sync."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def max_abs_err(got, want) -> int:
    """Largest absolute difference over a tuple of integer outputs."""
    err = 0
    for g, w in zip(got, want):
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def require_equal(name: str, got, want) -> int:
    err = max_abs_err(got, want)
    if err != 0:
        raise SystemExit(f"{name}: kernel disagrees with its plain version (max abs err {err})")
    return err


# ---------------------------------------------------------------------------
# phase 2: kernels against plain versions, adversarial small inputs
# ---------------------------------------------------------------------------


def hash_checks(dev) -> None:
    """The int64 tensor hashing on the card against its numpy twins, at the
    edge values of int32 and on random keys."""
    rng = np.random.default_rng(0)
    i32 = np.iinfo(np.int32)
    special = np.array([0, -1, i32.min, i32.max, 1, -2], np.int32)
    us = np.concatenate([special, rng.integers(i32.min, i32.max, 1 << 16, np.int32)])
    vs = np.concatenate([special[::-1], rng.integers(i32.min, i32.max, 1 << 16, np.int32)])
    tu, tv = torch.as_tensor(us, device=dev), torch.as_tensor(vs, device=dev)
    if not np.array_equal(hashing._mix32(tu).cpu().numpy(), hashing._mix32_np(us)):
        raise SystemExit("mix32 on the card differs from its numpy twin")
    if not np.array_equal(hashing.edge_hash32(tu, tv).cpu().numpy(),
                          hashing.edge_hash32_np(us, vs)):
        raise SystemExit("edge_hash32 on the card differs from its numpy twin")


def small_kernel_checks(dev) -> None:
    hash_checks(dev)
    rng = np.random.default_rng(1)
    # hash_probe: a table built by the engine's claim path, duplicate and
    # absent queries, a full table with no empty slot, n off the block size
    for cap, n in ((1024, 257), (64, 64)):
        table = torch.full((cap,), -1, dtype=torch.int32, device=dev)
        keys = torch.as_tensor(rng.choice(10_000, cap // 4, replace=False).astype(np.int32),
                               device=dev)
        table, _, over, _ = claim_vertex_slots(
            table, keys, torch.ones(cap // 4, dtype=torch.bool, device=dev))
        if bool(over):
            raise SystemExit("hash_probe check: the test table overflowed")
        q = torch.cat([keys[: n // 2], keys[: n // 4],
                       torch.as_tensor(rng.integers(10_000, 20_000, n - n // 2 - n // 4)
                                       .astype(np.int32), device=dev)])
        require_equal("hash_probe", hk.hash_probe(table, q),
                      hash_probe(table, q, impl="reference"))
    full = torch.arange(64, dtype=torch.int32, device=dev)
    q = torch.tensor([5, 100, -1], dtype=torch.int32, device=dev)
    require_equal("hash_probe", hk.hash_probe(full, q), hash_probe(full, q, impl="reference"))

    # masked_compact: densities 0, 0.3, 1; N off the 4,096-lane tile; then
    # thousands of tiles, so the look-back crosses many; one launch a call
    for rows, n, density in ((2, 1000, 0.0), (4, 100_003, 0.3), (1, 1025, 1.0), (6, 4096, 0.8),
                             *COMPACT_MANY_TILES):
        vals = torch.as_tensor(rng.integers(-5, 1000, (rows, n)).astype(np.int32), device=dev)
        mask = torch.as_tensor(rng.random(n) < density, device=dev)
        before = ck.masked_compact.launches
        require_equal("masked_compact", ck.masked_compact(vals, mask, fill=-1),
                      masked_compact(vals, mask, fill=-1, impl="reference"))
        if ck.masked_compact.launches != before + 1:
            raise SystemExit("masked_compact: not one launch a call")

    # probe_place: contended homes, partial activity, the overflow case, m
    # off every block size and of 1; one launch a call, its rounds those of
    # the plain mirror of its rounds
    for cap, m, homes, probes, density in PLACE_SMALL:
        keys = torch.as_tensor(rng.choice(max(100_000, 4 * m), m, replace=False)
                               .astype(np.int32), device=dev)
        home = hash_vertex(keys, cap)
        if homes:
            home = home % homes
        active = torch.as_tensor(rng.random(m) < density, device=dev)
        want = probe_place(home, active, capacity=cap, max_probes=probes, impl="reference")
        rounds = probe_place_device_rounds(home, active, capacity=cap, max_probes=probes)[2]
        for _ in range(PLACE_REPEATS if m == PLACE_REPEAT_M else 1):
            before = ck.probe_place.launches
            r0 = place_rounds()
            got = ck.probe_place(home, active, capacity=cap, max_probes=probes)
            require_equal("probe_place", (got[0], got[1]), (want[0], want[1]))
            if ck.probe_place.launches != before + 1:
                raise SystemExit("probe_place: not one launch a call")
            if place_rounds() - r0 != rounds:
                raise SystemExit(f"probe_place: {place_rounds() - r0} claim rounds, the "
                                 f"plain mirror's {rounds}")
        if probes == 2 and not bool(got[1]):
            raise SystemExit("probe_place: overflow not flagged")

    # frontier_expand: one edge, a 65-column frontier, random sweeps; S of 33
    # and 256 (words of 32 sources), no edges, unsorted sources, the sentinel
    # column C - 1 on the frontier and on edges; two launches a call
    for s, c, ce in ((3, 65, 1), (16, 512, 4096), (8, 130, 1024), (33, 4099, 50_000),
                     (256, 4099, 50_000), (256, 70, 0), (33, 1, 7)):
        fr = torch.as_tensor(rng.random((s, c)) < 0.2, device=dev)
        fr[::3, c - 1] = True
        src = torch.as_tensor(rng.integers(0, c, ce).astype(np.int32), device=dev)
        dst = torch.as_tensor(rng.integers(0, c, ce).astype(np.int32), device=dev)
        src[::7], dst[::5] = c - 1, c - 1
        before = fk.frontier_expand.launches
        require_equal("frontier_expand", (fk.frontier_expand(fr, src, dst),),
                      (frontier_expand(fr, src, dst, impl="reference"),))
        if fk.frontier_expand.launches != before + 2:
            raise SystemExit("frontier_expand: not two launches a call")
    sync()
    log("phase 2: the hashes on the card equal their numpy twins; every kernel equals "
        "its plain version on the adversarial inputs")


# ---------------------------------------------------------------------------
# phase 3: the main path at com-Youtube scale
# ---------------------------------------------------------------------------


def _oracle_apply(oracle, ops, us, vs):
    exp, _ = run_sequential(ops, us, vs, graph=oracle)
    return np.asarray(exp, bool)


def _check_bits(got, exp, what):
    if not np.array_equal(got, exp):
        bad = int(np.flatnonzero(got != exp)[0])
        raise SystemExit(f"{what}: success bits diverge from the oracle at lane {bad}")


def profile_window(step, n: int, unit: str):
    """Where the time goes: ``step()`` run ``n`` times under torch.profiler
    (after the timed runs, so the timing carries no profiler cost).  Returns
    the results and the device's busy share of the wall time, kernel
    launches per step and the device time of the heaviest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        results = [step() for _ in range(n)]
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only: the host-side aten ops carry their kernels'
    # time too, and counting both would count it twice
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return results, {
        "steps": n,
        f"wall_us_per_{unit}": wall_us / n,
        "device_busy_share": device_us / wall_us if wall_us else None,
        f"kernel_launches_per_{unit}": sum(e.count for e in kernels) / n,
        f"top_kernels_us_per_{unit}": {e.key[:80]: e.self_device_time_total / n for e in top},
    }


def profile_device(step):
    """``step()`` once under torch.profiler recording the card's activity
    only, read from the profiler's raw events: a training step launches
    hundreds of thousands of kernels, and parsing their host-side events
    into ``key_averages`` took minutes.  Returns the result and the
    device's busy share of the wall time, its kernel launches and its
    heaviest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = step()
        sync()
        wall_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    by_name, launches = {}, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            by_name[e.name()] = by_name.get(e.name(), 0) + e.duration_ns()
            launches += 1
    busy_s = sum(by_name.values()) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return result, {"wall_s": wall_s, "device_busy_s": busy_s,
                    "device_busy_share": busy_s / wall_s, "kernel_launches": launches,
                    "top_kernels_ms": {name[:80]: ns / 1e6 for name, ns in top},
                    "read_s": time.perf_counter() - t0}


def fig4_windows(g, oracle, rng, n_keys, phase: int) -> dict:
    """``apply`` timed for each Fig. 4 mix: a warm-up batch, then
    TIMED_BATCHES - 1 batches of BATCH ops on the host clock ended by a
    sync; every batch's bits are checked against the oracle afterwards.
    Returns ops/s per mix."""
    rates = {}
    for mix in FIG4_MIXES:
        batches = [sample_batch(rng, BATCH, mix, key_space=n_keys) for _ in range(TIMED_BATCHES)]
        warm = g.apply(*batches[0])
        _check_bits(warm, _oracle_apply(oracle, *batches[0]), f"{mix} warm-up batch")
        results = []
        sync()
        t0 = time.perf_counter()
        for b in batches[1:]:
            results.append(g.apply(*b))
        sync()
        dt = time.perf_counter() - t0
        rate = (TIMED_BATCHES - 1) * BATCH / dt
        for j, (b, got) in enumerate(zip(batches[1:], results)):
            _check_bits(got, _oracle_apply(oracle, *b), f"{mix} batch {j}")
        rates[mix] = rate
        log(f"phase {phase}: apply {mix}: {rate:.0f} ops/s over {TIMED_BATCHES - 1} batches of "
            f"{BATCH} (host clock, ended by a sync); bits equal to the oracle")
    return rates


def profile_apply(g, oracle, rng, n_keys, n_batches: int = 3, phase: int = 3) -> dict:
    """The profile of ``apply`` on a few balanced batches, each checked
    against the oracle."""
    batches = iter([sample_batch(rng, BATCH, "balanced", key_space=n_keys)
                    for _ in range(n_batches)])
    used = []

    def step():
        used.append(next(batches))
        return g.apply(*used[-1])

    results, res = profile_window(step, n_batches, "batch")
    for j, (b, got) in enumerate(zip(used, results)):
        _check_bits(got, _oracle_apply(oracle, *b), f"profiled batch {j}")
    log(f"phase {phase}: apply profile (balanced): " + json.dumps(res))
    return res


def main_path(seed: int):
    rng = np.random.default_rng(seed)
    n_keys = COM_YOUTUBE_VERTICES
    g = WaitFreeGraph(device="cuda")
    oracle = SequentialGraph()
    out = {"v_capacity_start": g.state.v_capacity, "e_capacity_start": g.state.e_capacity}
    caps = {(g.state.v_capacity, g.state.e_capacity)}

    t0 = time.perf_counter()
    n_ops = 0
    for lo in range(0, n_keys, BATCH):
        us = np.arange(lo, min(lo + BATCH, n_keys), dtype=np.int32)
        ops = np.full(us.shape, OP_ADD_VERTEX, np.int32)
        got = g.apply(ops, us)
        _check_bits(got, _oracle_apply(oracle, ops, us, np.zeros_like(us)), "vertex load")
        n_ops += us.size
        caps.add((g.state.v_capacity, g.state.e_capacity))
    for i in range(TRAVERSAL_BATCHES):
        ops, us, vs = sample_batch(rng, BATCH, "traversal", key_space=n_keys)
        got = g.apply(ops, us, vs)
        _check_bits(got, _oracle_apply(oracle, ops, us, vs), f"traversal batch {i}")
        n_ops += BATCH
        caps.add((g.state.v_capacity, g.state.e_capacity))
    out["build_ops"] = n_ops
    out["build_s_with_oracle"] = time.perf_counter() - t0
    out["capacities_seen"] = sorted(caps)
    live_v, live_e = len(oracle.vertices), len(oracle.edges)
    log(f"phase 3: built {n_ops} ops, every batch equal to the oracle; live vertices "
        f"{live_v}, live edges {live_e}; tables Cv={g.state.v_capacity} Ce={g.state.e_capacity}; "
        f"capacities seen {sorted(caps)}")
    out.update(live_vertices=live_v, live_edges=live_e,
               v_capacity=g.state.v_capacity, e_capacity=g.state.e_capacity)

    out["apply_ops_per_s"] = fig4_windows(g, oracle, rng, n_keys, 3)
    out["apply_profile"] = profile_apply(g, oracle, rng, n_keys)

    # one growth rehash at the final size, held against the host reference
    state = g.state
    (grown, _, ok), dt = wall_s(lambda: maintenance.rehash(
        state, 2 * state.v_capacity, 2 * state.e_capacity, impl="device"))
    host, _, host_ok = maintenance.rehash(state, 2 * state.v_capacity, 2 * state.e_capacity,
                                          impl="host")
    if not (ok and host_ok):
        raise SystemExit("rehash at the final size overflowed")
    for f in GraphState._fields:
        if not torch.equal(getattr(grown, f), getattr(host, f)):
            raise SystemExit(f"device rehash differs from the host reference in {f}")
    del grown, host
    out["rehash_ms"] = dt * 1e3
    log(f"phase 3: growth rehash to Cv={2 * state.v_capacity} Ce={2 * state.e_capacity}: "
        f"{dt * 1e3:.3f} ms, equal to the host reference; snapshot equal to the oracle")

    if g.snapshot() != (oracle.vertices, oracle.edges):
        raise SystemExit("the graph's snapshot differs from the oracle")
    # a full rebuild, called as such (the graph's own snapshot below is one
    # too: no query has cached a snapshot for the delta queue yet)
    _, dt = wall_s(lambda: build_csr(g.state))
    out["build_csr_ms"] = dt * 1e3
    csr = g.traversal_csr()
    if int(csr.n_edges) != len(oracle.edges):
        raise SystemExit("CSR edge count differs from the oracle")

    queries, sources, r_us = query_checks(g, oracle, rng, n_keys)
    out.update(queries)
    log(f"phase 3: build_csr {out['build_csr_ms']:.3f} ms; " + query_summary(out))
    return out, g, oracle, (sources, r_us)


def query_checks(g, oracle, rng, n_keys):
    """``reachable`` on 256 pairs, ``bfs_batch`` on 16 sources and
    ``get_path_batch`` on 16 pairs, each timed (host clock ended by a sync);
    4 BFS maps, the 32 pairs and 16 paths drawn from them are checked
    against the oracle.  Returns (times, sources, the pairs' sources)."""
    out = {}
    live_keys = np.fromiter(oracle.vertices, np.int64, len(oracle.vertices)).astype(np.int32)
    sources = rng.choice(live_keys, 16, replace=False)
    checked = sources[:4]
    r_us = np.concatenate([np.repeat(checked, 8), rng.integers(0, n_keys, 224)]).astype(np.int32)
    r_vs = rng.integers(0, n_keys, 256).astype(np.int32)
    p_us = np.repeat(checked, 4).astype(np.int32)
    p_vs = rng.choice(live_keys, 16).astype(np.int32)

    reach, dt = wall_s(lambda: g.reachable(r_us, r_vs))
    out["reachable_256_ms"] = dt * 1e3
    levels, dt = wall_s(lambda: g.bfs_batch(sources.tolist()))
    out["bfs_batch_16_ms"] = dt * 1e3
    paths, dt = wall_s(lambda: g.get_path_batch(p_us, p_vs))
    out["get_path_batch_16_ms"] = dt * 1e3

    ref = {int(u): oracle.bfs(int(u)) for u in checked}
    for i, u in enumerate(checked):
        if levels[i] != ref[int(u)]:
            raise SystemExit(f"bfs from {u} differs from the oracle")
    for u, v, r in zip(r_us[:32], r_vs[:32], reach[:32]):
        if bool(r) != (int(v) in ref[int(u)]):
            raise SystemExit(f"reachable({u}, {v}) differs from the oracle")
    for u, v, p in zip(p_us, p_vs, paths):
        want = ref[int(u)].get(int(v))
        if (p is None) != (want is None):
            raise SystemExit(f"get_path({u}, {v}) differs from the oracle")
        if p is not None and (len(p) != want + 1 or p[0] != u or p[-1] != v or
                              any(e not in oracle.edges for e in zip(p, p[1:]))):
            raise SystemExit(f"get_path({u}, {v}) is not a shortest path")
    out["bfs_reached_mean"] = float(np.mean([len(x) for x in levels]))
    return out, sources, r_us


def query_summary(out) -> str:
    return (f"reachable on 256 pairs {out['reachable_256_ms']:.3f} ms; bfs_batch on 16 sources "
            f"{out['bfs_batch_16_ms']:.3f} ms (mean {out['bfs_reached_mean']:.0f} vertices "
            f"reached); get_path_batch on 16 pairs {out['get_path_batch_16_ms']:.3f} ms; 4 BFS "
            f"maps, 32 pairs and 16 paths equal to the oracle")


# ---------------------------------------------------------------------------
# phase 4: kernels at the main path's shapes
# ---------------------------------------------------------------------------


def _bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _probe_steps(home, slot, cap):
    """Probe steps each lane walked to reach ``slot`` (data-dependent work)."""
    steps = torch.full_like(home, MAX_PROBES)
    for s in range(MAX_PROBES - 1, -1, -1):
        steps = torch.where(probe_slot(home, s, cap) == slot, s + 1, steps)
    return steps


def _probe_sectors(home, steps, cap) -> int:
    """Distinct 32-byte sectors of the table that walks of ``steps`` steps
    from ``home`` touch: the table bytes the probes need."""
    per_slot = SECTOR_BYTES // 4
    touched = [probe_slot(home[steps > s], s, cap) // per_slot for s in range(MAX_PROBES)]
    return torch.unique(torch.cat(touched)).numel()


def full_shape_kernels(g, sources, launches, calls, place_rounds_main, dev) -> list:
    rng = np.random.default_rng(2)
    state = g.state
    csr = g.traversal_csr()
    rows = []

    def record(name, source, replaces, got, want, ms, plain_ms, bound, library_ms):
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": require_equal(name, got, want),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": library_ms,
        })

    # hash_probe: the final vertex table, 2^17 queries, half present
    table = state.v_key
    cap = table.shape[0]
    live = state.v_key[state.v_live]
    q = torch.cat([live[torch.randperm(live.numel(), device=dev)[: 1 << 16]],
                   torch.randint(COM_YOUTUBE_VERTICES, 2**31 - 1, (1 << 16,), device=dev,
                                 dtype=torch.int32)])
    got = hk.hash_probe(table, q)
    want = hash_probe(table, q, impl="reference")
    home = hash_vertex(q, cap)
    slot = torch.where(got[0] >= 0, got[0], got[1])
    steps = _probe_steps(home, slot, cap)
    sectors, probe_steps = _probe_sectors(home, steps, cap), int(steps.sum())
    record("hash_probe", "src/repro_torch/csrc/hash_probe.cu",
           "src/repro/kernels/hash_probe/kernel.py:62", got, want,
           cuda_ms(lambda: hk.hash_probe(table, q), 20),
           cuda_ms(lambda: hash_probe(table, q, impl="reference"), 5),
           _bound(SECTOR_BYTES * sectors + 12 * q.numel(),
                  16 * q.numel() + 10 * probe_steps),
           None)
    # beside the bound: the L2 warm (the main path's case: the key column
    # fits the L2 between calls), the latency floor of the same grid (an
    # empty kernel, and a key then one dependent load a thread, in the same
    # window), and the queries resolved at the first probe, in home's sector
    # and within steps 0-3
    with uncounted():
        rows[-1].update(
            warm_l2_ms=cuda_ms(lambda: hk.hash_probe(table, q), 20, flush=False),
            floor_ms={mode: {"flushed": cuda_ms(lambda: hk.latency_floor(table, q, mode), 20),
                             "warm_l2": cuda_ms(lambda: hk.latency_floor(table, q, mode), 20,
                                                flush=False)}
                      for mode in hk.FLOOR_MODES},
            resolved_at_step_0=int(((slot >= 0) & (steps <= 1)).sum()),
            resolved_in_steps_0_3=int(((slot >= 0) & (steps <= 4)).sum()),
            resolved_in_home_sector=int(((slot >= 0) & (
                home % PROBE_SECTOR + (steps - 1) * steps // 2 < PROBE_SECTOR)).sum()),
            queries=q.numel())

    # masked_compact: the edge rehash's compaction of the final edge table
    _, _, valid = _edge_validity(state)
    vals = torch.stack([state.e_key_u, state.e_key_v, state.e_inc_u, state.e_inc_v])
    r, n = vals.shape
    got = ck.masked_compact(vals, valid, fill=-1)
    want = masked_compact(vals, valid, fill=-1, impl="reference")
    record("masked_compact", "src/repro_torch/csrc/compact.cu",
           "src/repro/kernels/compact/kernel.py:61", got, want,
           cuda_ms(lambda: ck.masked_compact(vals, valid, fill=-1), 20),
           cuda_ms(lambda: masked_compact(vals, valid, fill=-1, impl="reference"), 5),
           _bound(2 * 4 * r * n + n + 4, (r + 4) * n),
           cuda_ms(lambda: vals[:, valid], 20))

    # probe_place: the vertex rehash from 2^21 to 2^22 slots, on the live keys
    m, pcap = PLACE_M, PLACE_CAP
    keys = torch.full((m,), -1, dtype=torch.int32, device=dev)
    keys[: live.numel()] = live[:m]
    active = torch.arange(m, device=dev) < min(live.numel(), m)
    home = torch.where(active, hash_vertex(keys, pcap), 0)
    got = ck.probe_place(home, active, capacity=pcap, max_probes=MAX_PROBES)
    want = probe_place(home, active, capacity=pcap, max_probes=MAX_PROBES, impl="reference")
    placed = got[0] >= 0
    place_steps = int(_probe_steps(home[placed], got[0][placed], pcap).sum())
    record("probe_place", "src/repro_torch/csrc/compact.cu",
           "src/repro/kernels/compact/kernel.py:106", got, want,
           cuda_ms(lambda: ck.probe_place(home, active, capacity=pcap,
                                                max_probes=MAX_PROBES), 20),
           cuda_ms(lambda: probe_place(home, active, capacity=pcap, max_probes=MAX_PROBES,
                                         impl="reference"), 2),
           _bound(9 * m + 1, 12 * place_steps + 8 * int(placed.sum())),
           None)
    place_row = rows[-1]
    # its ms is one call, every claim round of it; the rounds come from its
    # device counter, read outside the timed windows
    with uncounted():
        before = place_rounds()
        ck.probe_place(home, active, capacity=pcap, max_probes=MAX_PROBES)
        timed_rounds = place_rounds() - before
        # the launch alone, its buffers made beforehand: whole, and stopped
        # after round 1 (the fill and round 1)
        _, _, launch = ck.prepare_place(home, active, capacity=pcap, max_probes=MAX_PROBES)
        launch_ms = cuda_ms(lambda: launch(m), 20)
        first_ms = cuda_ms(lambda: launch(1), 20)
    place_row.update(calls=calls["probe_place"], rounds=place_rounds_main,
                     rounds_in_timed_call=timed_rounds, launch_ms=launch_ms,
                     pass_ms={"fill and round 1": first_ms,
                              "later rounds": launch_ms - first_ms})

    # frontier_expand: 16 BFS frontiers three levels deep in the final
    # snapshot, then reachable's 256 (the sources of phase 3's pairs)
    bfs_src, reach_src = sources
    ce = csr.src.numel()
    frontier_rows = []
    for what, keys_np in (("bfs_batch", bfs_src), ("reachable", reach_src)):
        src_keys = torch.as_tensor(keys_np.astype(np.int32), device=dev)
        lv = bfs_levels(csr, src_keys)
        frontier = torch.zeros((len(keys_np), csr.v_capacity + 1), dtype=torch.bool, device=dev)
        frontier[:, : csr.v_capacity] = lv == FRONTIER_DEPTH
        del lv
        s_n, c = frontier.shape
        atomics = int(frontier.sum(0, dtype=torch.int64)[csr.src.long()].sum())
        want = (frontier_expand(frontier, csr.src, csr.dst, impl="reference"),)
        got = (fk.frontier_expand(frontier, csr.src, csr.dst),)
        err = require_equal("frontier_expand", got, want)
        del got, want
        idx = csr.dst.long()[None, :].expand(s_n, -1)
        cand = torch.where(frontier[:, csr.src.long()], csr.src[None, :], 2**31 - 1)
        lib_ms = cuda_ms(lambda out: out.scatter_reduce_(1, idx, cand, "amin"), 5,
                         setup=lambda: (torch.full((s_n, c), 2**31 - 1, dtype=torch.int32,
                                                   device=dev),))
        del cand
        with uncounted():
            _, _, passes = fk.prepare(frontier, csr.src, csr.dst)
            pass_ms = {name: cuda_ms(fn, 10) for name, fn in zip(fk.PASSES, passes)}
            del passes
        bound = _bound(s_n * c + 8 * ce + 4 * s_n * c, 3 * s_n * ce)
        rows.append({
            "name": "frontier_expand", "route": "cuda",
            "source": "src/repro_torch/csrc/frontier.cu",
            "replaces": "src/repro/kernels/frontier/kernel.py:61",
            "launches": launches["frontier_expand"], "max_abs_err": err,
            "ms": cuda_ms(lambda: fk.frontier_expand(frontier, csr.src, csr.dst), 10),
            "plain_ms": cuda_ms(lambda: frontier_expand(frontier, csr.src, csr.dst,
                                                        impl="reference"), 2),
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib_ms,
            "calls": calls["frontier_expand"], "shape": f"{what}: S {s_n}, C {c}, Ce {ce}",
            "atomics": atomics, "pass_ms": pass_ms,
        })
        frontier_rows.append(f"S={s_n} ({what}, {atomics} atomics)")
        del frontier
    probe_row = rows[0]
    log(f"phase 4: every kernel equals its plain version at the main path's shapes "
        f"(hash_probe table {cap} / queries {q.numel()}, {sectors} table sectors "
        f"touched, {probe_steps} probe steps, queries resolved at their first probe "
        f"{probe_row['resolved_at_step_0']}, within the sector of their home slot "
        f"{probe_row['resolved_in_home_sector']}, within steps 0-3 "
        f"{probe_row['resolved_in_steps_0_3']}; {probe_row['ms']:.5f} ms flushed, "
        f"{probe_row['warm_l2_ms']:.5f} ms with the L2 warm, latency floor "
        f"{json.dumps(probe_row['floor_ms'])}; masked_compact {r} x {n}; "
        f"probe_place {m} into {pcap}, {int(placed.sum())} keys in {place_steps} steps, "
        f"{timed_rounds} claim rounds a call, {calls['probe_place']} calls and "
        f"{place_row['rounds']} rounds on the main path; "
        f"frontier_expand C={c} Ce={ce}, depth {FRONTIER_DEPTH}, {', '.join(frontier_rows)})")
    return rows


# ---------------------------------------------------------------------------
# phase 14: delta CSR maintenance and the baseline engines, on phase 3's graph
# ---------------------------------------------------------------------------


def require_csr_equal(what: str, got, want) -> None:
    for f in traversal.TraversalCSR._fields:
        if not torch.equal(getattr(got, f), getattr(want, f)):
            raise SystemExit(f"{what}: snapshots differ in {f}")


@contextlib.contextmanager
def spying(module, name: str, seen: list, keep=None):
    """``module.name`` wrapped, while the block runs, to append to ``seen``
    its arguments, or what ``keep`` makes of them where that is not None."""
    real = getattr(module, name)

    def spy(*args, **kwargs):
        item = keep(*args, **kwargs) if keep else args
        if item is not None:
            seen.append(item)
        return real(*args, **kwargs)

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, real)


def _launch_counts() -> dict:
    return {name: w.launches for name, w in WRAPPERS.items()}


def _oracle_keys(oracle):
    """The oracle's live vertex keys and edge keys (``u << 32 | v``), sorted
    int64 numpy."""
    verts = np.sort(np.fromiter(oracle.vertices, np.int64, len(oracle.vertices)))
    uv = np.fromiter(itertools.chain.from_iterable(oracle.edges), np.int64,
                     2 * len(oracle.edges)).reshape(-1, 2)
    return verts, np.sort((uv[:, 0] << 32) | (uv[:, 1] & 0xFFFFFFFF))


def _state_keys(state):
    """The same two arrays for a state on the card (its snapshot masks)."""
    v_mask, e_mask = traversal.snapshot_live(state)
    verts = torch.sort(state.v_key[v_mask].long()).values
    edges = (state.e_key_u[e_mask].long() << 32) | (state.e_key_v[e_mask].long() & 0xFFFFFFFF)
    return verts.cpu().numpy(), torch.sort(edges).values.cpu().numpy()


def _reach_check(g, oracle, rng, n_keys, what: str) -> None:
    """``reachable`` on FOLD_PAIRS pairs from one live source, half of the
    targets reached by the oracle's BFS and half drawn at random."""
    src = int(rng.integers(0, n_keys))
    while src not in oracle.vertices:
        src = int(rng.integers(0, n_keys))
    ref = oracle.bfs(src)
    reached = np.fromiter(ref, np.int64, len(ref)).astype(np.int32)
    half = FOLD_PAIRS // 2
    vs = np.concatenate([rng.choice(reached, half), rng.integers(0, n_keys, half)]).astype(np.int32)
    got = g.reachable(np.full(FOLD_PAIRS, src, np.int32), vs)
    want = np.array([int(v) in ref for v in vs])
    if not np.array_equal(got, want):
        raise SystemExit(f"{what}: reachable differs from the oracle")


def delta_path(g, oracle, seed: int, dev):
    rng = np.random.default_rng(seed + 14)
    n_keys = COM_YOUTUBE_VERTICES
    out = {"fold_epochs": [], "seconds": {}}
    t_part = time.perf_counter()

    def keep_survivors(values, mask, **_):  # the fold's first compaction: 3 rows
        return (values.clone(), mask.clone()) if values.shape[0] == 3 else None

    # fold epochs: each one batch queued on the cached snapshot, folded by the
    # next query on the device merge, held to the rebuild and the host splice
    for i in range(FOLD_EPOCHS):
        base = g.traversal_csr()
        mix = FOLD_MIXES[i % len(FOLD_MIXES)]
        ops, us, vs = sample_batch(rng, BATCH, mix, key_space=n_keys)
        _check_bits(g.apply(ops, us, vs), _oracle_apply(oracle, ops, us, vs), f"fold epoch {i}")
        if g._delta_base is not base or len(g._delta_batches) != 1:
            raise SystemExit(f"fold epoch {i}: the batch was not queued on the snapshot")
        t0 = time.perf_counter()  # the fold's host dedup, alone (host only)
        v_touch, e_tu, _ = traversal.touched_keys(ops, us, vs)
        dt_keys = time.perf_counter() - t0
        before = _launch_counts()
        merges, splices, fold_inputs = [], [], []
        with spying(maintenance, "delta_merge", merges), \
                spying(traversal, "_delta_probe", splices), \
                spying(compact_ops, "masked_compact", fold_inputs, keep_survivors):
            csr, dt = wall_s(g.traversal_csr)
        launched = {k: v - before[k] for k, v in _launch_counts().items()}
        if len(merges) != 1 or splices:
            raise SystemExit(f"fold epoch {i}: {len(merges)} device merges and "
                             f"{len(splices)} host splices (want 1 and 0)")
        if launched["masked_compact"] == 0 or launched["hash_probe"] == 0:
            raise SystemExit(f"fold epoch {i}: the fold launched {launched}")
        with uncounted():
            rebuilt, dt_build = wall_s(lambda: build_csr(g.state))
            require_csr_equal(f"fold epoch {i} against build_csr", csr, rebuilt)
            host = traversal.apply_delta(base, g.state, ops, us, vs, impl="host")
            require_csr_equal(f"fold epoch {i} against the host splice", csr, host)
            del rebuilt, host
        _reach_check(g, oracle, rng, n_keys, f"fold epoch {i}")
        out["fold_epochs"].append({
            "mix": mix, "touched_keys": int(v_touch.size + e_tu.size), "fold_ms": dt * 1e3,
            "touched_keys_ms": dt_keys * 1e3, "build_csr_ms": dt_build * 1e3,
            "masked_compact_launches":
            launched["masked_compact"], "hash_probe_launches": launched["hash_probe"]})
    log("phase 14: fold epochs (one 65,536-op batch each, folded by the device merge at "
        "the next query, equal to build_csr and to the host splice, reachable on "
        f"{FOLD_PAIRS} pairs equal to the oracle): " + json.dumps(out["fold_epochs"]))

    # one more epoch, its fold under the profiler: where the fold's time goes
    g.traversal_csr()
    ops, us, vs = sample_batch(rng, BATCH, FOLD_MIXES[0], key_space=n_keys)
    _check_bits(g.apply(ops, us, vs), _oracle_apply(oracle, ops, us, vs), "profiled fold epoch")
    (csr,), out["fold_profile"] = profile_window(g.traversal_csr, 1, "fold")
    with uncounted():
        require_csr_equal("profiled fold against build_csr", csr, build_csr(g.state))
    log("phase 14: one fold under the profiler: " + json.dumps(out["fold_profile"]))
    out["seconds"]["fold epochs"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # growth epoch: add edges past the edge table's load factor in one batch;
    # the growth's rehash hands its snapshot to the queue
    _, e_used = _used_slots(g.state)
    cv0, ce0 = g.state.v_capacity, g.state.e_capacity
    n_add = int(GROW_LOAD_FACTOR * ce0) - e_used + BATCH
    live = np.fromiter(oracle.vertices, np.int64, len(oracle.vertices)).astype(np.int32)
    ops = np.full(n_add, OP_ADD_EDGE, np.int32)
    us, vs = rng.choice(live, n_add), rng.choice(live, n_add)
    got, dt = wall_s(lambda: g.apply(ops, us, vs))
    _check_bits(got, _oracle_apply(oracle, ops, us, vs), "growth epoch")
    # the fold's host dedup of this batch, beside np.unique of its edge codes
    t0 = time.perf_counter()
    traversal.touched_keys(ops, us, vs)
    dt_keys = time.perf_counter() - t0
    codes = (us.astype(np.int64) << 32) | (vs.astype(np.int64) & 0xFFFFFFFF)
    t0 = time.perf_counter()
    np.unique(codes)
    dt_unique = time.perf_counter() - t0
    cv, ce = g.state.v_capacity, g.state.e_capacity
    base = g._delta_base
    if (cv, ce) == (cv0, ce0) or base is None or base.e_capacity != ce or \
            len(g._delta_batches) != 1:
        raise SystemExit("growth epoch: no growth, or the grown snapshot is not the queue's base")
    merges = []
    with spying(maintenance, "delta_merge", merges):
        csr, dt_fold = wall_s(g.traversal_csr)
    with uncounted():
        rebuilt, dt_build = wall_s(lambda: build_csr(g.state))
        require_csr_equal("growth epoch's fold against build_csr", csr, rebuilt)
        del rebuilt
    if len(merges) != 1:
        raise SystemExit("growth epoch: the fold did not take the device merge")
    with uncounted():
        for got_k, want_k in zip(_state_keys(g.state), _oracle_keys(oracle)):
            if not np.array_equal(got_k, want_k):
                raise SystemExit("growth epoch: the live set differs from the oracle")
    out["growth_epoch"] = {"ops": n_add, "apply_s": dt, "capacities": [cv0, ce0, cv, ce],
                           "fold_ms": dt_fold * 1e3, "build_csr_ms": dt_build * 1e3,
                           "touched_keys_ms": dt_keys * 1e3, "np_unique_ms": dt_unique * 1e3,
                           "numpy": np.__version__}

    # the snapshot-compact at the final size, beside the plain rehash
    state = g.state
    times = {True: [], False: []}
    for with_csr in (False, True) * 3:  # in turns; the last one is checked
        grown = grown_csr = None  # the previous tables go before the next are made
        (grown, grown_csr, ok), dt = wall_s(lambda: maintenance.rehash(
            state, 2 * cv, 2 * ce, impl="device", with_csr=with_csr))
        if not ok:
            raise SystemExit("rehash at the final size overflowed")
        times[with_csr].append(dt * 1e3)
    with uncounted():
        host, _, host_ok = maintenance.rehash(state, 2 * cv, 2 * ce, impl="host")
        if not host_ok:
            raise SystemExit("host rehash at the final size overflowed")
        for f in GraphState._fields:
            if not torch.equal(getattr(grown, f), getattr(host, f)):
                raise SystemExit(f"rehash differs from the host reference in {f}")
        del host
        require_csr_equal("rehash(with_csr=True)", grown_csr, build_csr(grown))
    del grown, grown_csr
    out["rehash_ms"] = {"with_csr": times[True], "without": times[False]}
    out["seconds"]["growth epoch and rehash"] = time.perf_counter() - t_part
    log(f"phase 14: growth epoch of {n_add} edge adds, Cv {cv0} -> {cv}, Ce {ce0} -> {ce}: "
        f"apply {dt * 1e3:.3f} ms, equal to the oracle; its batch queued on the rehash's snapshot, folded in "
        f"{dt_fold * 1e3:.3f} ms (build_csr {dt_build * 1e3:.3f} ms), equal; its dedup "
        f"{dt_keys * 1e3:.3f} ms (np.unique of its edge codes {dt_unique * 1e3:.3f} ms, "
        f"numpy {np.__version__}); rehash to "
        f"Cv={2 * cv} Ce={2 * ce} with the snapshot {json.dumps(times[True])} ms, without "
        f"{json.dumps(times[False])} ms, equal to the host rehash and to build_csr")

    # baselines: every engine from one pre-state (a copy of the grown state:
    # the engines never write into the state they are given), each mix's
    # bits and live set held to the oracle after the same lanes
    out["engines"] = {}
    pre = g.state
    for mix in FIG4_MIXES:
        t_part = time.perf_counter()
        ops, us, vs = sample_batch(rng, BATCH, mix, key_space=n_keys)
        bits, want_keys, lo = [], {}, 0
        for cut in sorted({lanes for _, lanes in ENGINE_RUNS}):
            bits.append(_oracle_apply(oracle, ops[lo:cut], us[lo:cut], vs[lo:cut]))
            want_keys[cut], lo = _oracle_keys(oracle), cut
        exp = np.concatenate(bits)
        rates, post = {}, None
        for name, lanes in ENGINE_RUNS:
            fn = ENGINE_FNS[name]
            batch = make_batch(ops[:lanes], us[:lanes], vs[:lanes], device=dev)
            res, dt = wall_s(lambda: fn(pre, batch))
            what = f"{name} at {lanes} lanes, {mix}"
            if not bool(res.ok):
                raise SystemExit(f"{what}: overflowed")
            _check_bits(res.success.cpu().numpy(), exp[:lanes], what)
            with uncounted():
                for got_k, want_k in zip(_state_keys(res.state), want_keys[lanes]):
                    if not np.array_equal(got_k, want_k):
                        raise SystemExit(f"{what}: live set differs from the oracle")
            rates[f"{name}@{lanes}"] = {"ops_per_s": lanes / dt, "s": dt}
            if name == "lockfree":
                rates[f"{name}@{lanes}"]["rounds"] = int(res.stats[0])
            if name == "waitfree" and lanes == BATCH:
                post = res.state
        out["engines"][mix] = rates
        out["seconds"][f"engines, {mix}"] = time.perf_counter() - t_part
        pre = post  # the oracle now holds the whole batch
        log(f"phase 14: engines on the {mix} mix, one batch each (the serial and coarse loops "
            f"go one op at a time) from one pre-state (Cv {cv}, Ce {ce}; host clock ended by "
            "a sync; bits and live set equal to the oracle): " + json.dumps(rates))
    log("phase 14: wall seconds by part: " + json.dumps(out["seconds"]))

    return out, (fold_inputs[0] if fold_inputs else None)


# ---------------------------------------------------------------------------
# phase 15: the sharded graph at com-Youtube scale
# ---------------------------------------------------------------------------


def build_stream(rng, traversals: int = TRAVERSAL_BATCHES):
    """Phase 3's build stream, given a generator made from the same seed:
    the vertex loads, then ``traversals`` ``traversal`` batches (phase 3's
    first ones), as (label, ops, us, vs); with all TRAVERSAL_BATCHES,
    ``rng`` is left where phase 3's Fig. 4 batches start."""
    n_keys = COM_YOUTUBE_VERTICES
    for lo in range(0, n_keys, BATCH):
        us = np.arange(lo, min(lo + BATCH, n_keys), dtype=np.int32)
        yield "vertex load", np.full(us.shape, OP_ADD_VERTEX, np.int32), us, np.zeros_like(us)
    for i in range(traversals):
        yield (f"traversal batch {i}", *sample_batch(rng, BATCH, "traversal", key_space=n_keys))


def _shard_caps(g):
    return tuple((st.v_capacity, st.e_capacity) for st in g.shards)


def _balance(shard_idx) -> float:
    sizes = [idx.size for idx in shard_idx]
    return max(sizes) * len(sizes) / max(1, sum(sizes))


def sharded_path(seed: int, dev):
    n_keys = COM_YOUTUBE_VERTICES
    out = {"n_shards": SHARDS, "seconds": {}}
    t_part = time.perf_counter()

    # part 1: the 4-shard build, every batch checked against the oracle
    g = WaitFreeGraph(n_shards=SHARDS, device=dev)
    oracle = SequentialGraph()
    out["shard_capacities_start"] = _shard_caps(g)
    caps_seen = [_shard_caps(g)]
    bits, balance, apply_s, n_ops = [], [], 0.0, 0
    rng = np.random.default_rng(seed)
    for label, ops, us, vs in build_stream(rng, SHARDED_TRAVERSAL_BATCHES):
        if label.startswith("traversal"):
            balance.append(_balance(sharding.route_ops(ops, us, vs, SHARDS)[0]))
        if label == "traversal batch 0":
            edge_hist = shard_balance(ops, us, vs, SHARDS).tolist()
        sync()
        t0 = time.perf_counter()
        got = g.apply(ops, us, vs)
        sync()
        apply_s += time.perf_counter() - t0
        _check_bits(got, _oracle_apply(oracle, ops, us, vs), f"sharded {label}")
        if len(bits) < SHARDED_FPSP_BATCHES:
            bits.append((ops, us, vs, got))
        n_ops += ops.size
        if _shard_caps(g) != caps_seen[-1]:
            caps_seen.append(_shard_caps(g))
    out.update(build_ops=n_ops, build_apply_s=apply_s, build_ops_per_s=n_ops / apply_s,
               growth_steps=caps_seen, subbatch_balance=[min(balance), max(balance)],
               live_vertices=len(oracle.vertices), live_edges=len(oracle.edges))
    log(f"phase 15: built {n_ops} ops on {SHARDS} shards in {apply_s:.3f} s of apply (host "
        f"clock ended by a sync; {n_ops / apply_s:.0f} ops/s), every batch equal to the oracle; "
        f"live vertices {len(oracle.vertices)}, live edges {len(oracle.edges)}; shard "
        f"capacities (Cv, Ce) at each growth: {caps_seen}; sub-batch balance (max over mean) "
        f"{min(balance):.4f}-{max(balance):.4f}; edge ops a shard in the first traversal "
        f"batch {edge_hist}")
    out["apply_ops_per_s"] = fig4_windows(g, oracle, rng, n_keys, 15)
    out["apply_profile"] = profile_apply(g, oracle, rng, n_keys, phase=15)
    if g.snapshot() != (oracle.vertices, oracle.edges):
        raise SystemExit("phase 15: the sharded graph's snapshot differs from the oracle")
    out["seconds"]["build"] = time.perf_counter() - t_part

    # part 2: the fused snapshot, on the card and on the host, and queries
    t_part = time.perf_counter()
    csr, dt = wall_s(g.traversal_csr)
    out["fuse_ms_first"] = dt * 1e3
    if int(csr.n_edges) != len(oracle.edges) or int(csr.n_live) != len(oracle.vertices):
        raise SystemExit("phase 15: the fused snapshot's counts differ from the oracle")
    fuse_ms = {"device": [], "host": []}
    for impl in ("device", "host"):  # twice each, in turns, before phase 22 came
        fused, dt = wall_s(lambda: sharding.fuse_partitioned(g.shards, impl=impl))
        require_csr_equal(f"phase 15 {impl} fuse", fused, csr)
        fuse_ms[impl].append(dt * 1e3)
        del fused
    out["fuse_ms"] = fuse_ms
    out.update(directory_capacity=csr.v_capacity, fused_edge_lanes=csr.e_capacity)
    queries, _, _ = query_checks(g, oracle, rng, n_keys)
    out.update(queries)
    log(f"phase 15: fused snapshot (directory Cv={csr.v_capacity}, {csr.e_capacity} edge lanes) "
        f"{out['fuse_ms_first']:.3f} ms as the graph's first query; the device fuse "
        f"{fuse_ms['device']} ms and the host fuse {fuse_ms['host']} ms, field for "
        f"field equal; n_edges and n_live equal to the oracle; " + query_summary(out))
    del csr, oracle
    out["seconds"]["fuse_and_queries"] = time.perf_counter() - t_part

    # part 3: FPSP on 2 shards gives part 1's bits
    t_part = time.perf_counter()
    g2 = WaitFreeGraph(n_shards=2, mode="fpsp", device=dev)
    for i, (ops, us, vs, want) in enumerate(bits):
        if not np.array_equal(g2.apply(ops, us, vs), want):
            raise SystemExit(f"phase 15: 2-shard FPSP bits differ from 4 shards at batch {i}")
    out["fpsp_2_shards"] = {"batches": len(bits), "shard_capacities": _shard_caps(g2)}
    log(f"phase 15: 2-shard FPSP on the first {len(bits)} batches: bits equal to the 4-shard "
        f"graph's; shard capacities {_shard_caps(g2)}")
    del g, g2
    out["seconds"]["fpsp_2_shards"] = time.perf_counter() - t_part

    # part 4: telemetry on one shard and on four, FPSP, against obs off
    t_part = time.perf_counter()
    graphs = {n: WaitFreeGraph(e_capacity=OBS_E_CAPACITY, n_shards=n, mode="fpsp", obs=True,
                               device=dev) for n in (1, SHARDS)}
    n_loads = -(-n_keys // BATCH)
    for i, (ops, us, vs, want) in enumerate(bits[:OBS_BATCHES]):
        if i == n_loads:
            grown = {n: gn.obs.counters().get("growth.events", 0) for n, gn in graphs.items()}
        for n, gn in graphs.items():
            if not np.array_equal(gn.apply(ops, us, vs), want):
                raise SystemExit(f"phase 15: obs-on bits ({n} shards) differ at batch {i}")
    if any(gn.obs.counters().get("growth.events", 0) != grown[n] for n, gn in graphs.items()):
        raise SystemExit("phase 15: a telemetry graph grew after the vertex loads")
    graphs[SHARDS].traversal_csr()
    counters = {n: gn.obs.counters() for n, gn in graphs.items()}
    for name in SHARD_INVARIANT_COUNTERS:
        if counters[1].get(name) != counters[SHARDS].get(name):
            raise SystemExit(f"phase 15: {name} differs between 1 and {SHARDS} shards")
    dirs = {n: obs_probes.directory_probe_histogram(gn) for n, gn in graphs.items()}
    if dirs[1] != dirs[SHARDS]:
        raise SystemExit("phase 15: the directory probe histograms differ across shard counts")
    spans = graphs[SHARDS].obs.dump()["spans"]
    table = {name: {"count": spans[name]["count"], "total_ms": spans[name]["total_ms"]}
             for name in SPAN_TABLE if name in spans}
    out["telemetry"] = {"batches": OBS_BATCHES,
                        "counters": {k: counters[SHARDS].get(k) for k in SHARD_INVARIANT_COUNTERS},
                        "directory_probe_hist": dirs[SHARDS], "spans": table}
    log(f"phase 15: telemetry on the first {OBS_BATCHES} batches, FPSP: the shard-invariant "
        f"counters and the directory probe histograms equal on 1 and {SHARDS} shards, the bits "
        f"equal with obs off; {SHARDS}-shard spans (host wall ms): {json.dumps(table)}")
    out["seconds"]["telemetry"] = time.perf_counter() - t_part
    return out


def fold_compact_row(vals, mask, launches: int) -> dict:
    """``masked_compact`` at the fold's shape: the surviving (src, dst, lane)
    rows of the last fold epoch's snapshot under its keep mask."""
    r, n = vals.shape
    with uncounted():
        got = ck.masked_compact(vals, mask, fill=0)
        want = masked_compact(vals, mask, fill=0, impl="reference")
        row = {
            "name": "masked_compact", "route": "cuda", "source": "src/repro_torch/csrc/compact.cu",
            "replaces": "src/repro/kernels/compact/kernel.py:61", "launches": launches,
            "max_abs_err": require_equal("masked_compact (fold)", got, want),
            "ms": cuda_ms(lambda: ck.masked_compact(vals, mask, fill=0), 20),
            "plain_ms": cuda_ms(lambda: masked_compact(vals, mask, fill=0, impl="reference"), 5),
        }
        bound = _bound(2 * 4 * r * n + n + 4, (r + 4) * n)
        row.update(bound_ms=bound[0], bound_by=bound[1],
                   library_ms=cuda_ms(lambda: vals[:, mask], 20),
                   shape=f"the delta fold's survivors: {r} x {n}, {int(mask.sum())} kept")
    return row


# ---------------------------------------------------------------------------
# phase 5: flash attention against its plain version, adversarial shapes
# ---------------------------------------------------------------------------


def require_close(name: str, got, want, tol: float) -> float:
    """Max abs error of a float kernel against its plain version; exits
    unless every element is within ``tol`` (absolute plus relative)."""
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise SystemExit(f"{name}: non-finite output")
    if not torch.allclose(g, w, atol=tol, rtol=tol):
        raise SystemExit(f"{name}: kernel disagrees with its plain version "
                         f"(max abs err {(g - w).abs().max().item()})")
    return (g - w).abs().max().item()


def limit_share(got, want, tol: float) -> float:
    """How close ``got`` came to :func:`require_close`'s limit: the largest
    |got - want| / (tol + tol |want|), 1 at the limit."""
    g, w = got.float(), want.float()
    return ((g - w).abs() / (tol + tol * w.abs())).max().item()


def require_block_rel_l2(name: str, got, want, tol: float = FLASH_BLOCK_REL_TOL) -> float:
    """Largest relative L2 error over blocks of ``FLASH_BLOCK_ROWS`` q rows
    of one (batch, head) of attention outputs (B, H, S, D); exits unless
    each is within ``tol``.  A block the plain version gives as 0 (rows that
    see no key) is held to an absolute 0 instead."""
    b, h, s, d = want.shape
    pad = -s % FLASH_BLOCK_ROWS
    g, w = (torch.nn.functional.pad(x.float(), (0, 0, 0, pad)).reshape(
        b, h, -1, FLASH_BLOCK_ROWS * d) for x in (got, want))
    worst = ((g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)).max().item()
    if not worst <= tol:
        raise SystemExit(f"{name}: relative L2 error {worst} of a {FLASH_BLOCK_ROWS}-row block "
                         f"against the plain version (limit {tol})")
    return worst


def flash_small_checks(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(3)
    worst = {str(dt): 0.0 for dt in FLASH_TOL}
    for shape in FLASH_SHAPES:
        b, hq, hkv, sq, sk, d, causal, window = shape
        for dt, tol in FLASH_TOL.items():
            q = torch.randn(b, hq, sq, d, generator=gen, device=dev).to(dt)
            k = torch.randn(b, hkv, sk, d, generator=gen, device=dev).to(dt)
            v = torch.randn(b, hkv, sk, d, generator=gen, device=dev).to(dt)
            got = fak.flash_attention(q, k, v, causal=causal, window=window)
            want = attention(q, k, v, causal=causal, window=window, impl="reference")
            sync()
            err = require_close(f"flash_attention {shape} {dt}", got, want, tol)
            worst[str(dt)] = max(worst[str(dt)], err)
            if dt == torch.bfloat16 and sq >= 1024:
                worst["bf16_block_rel_l2"] = max(worst.get("bf16_block_rel_l2", 0.0),
                                                 require_block_rel_l2(f"flash_attention {shape}",
                                                                      got, want))
            if window is not None and sq - window >= sk:  # rows that see no key
                dead = torch.arange(sq, device=dev) - window + 1 > sk - 1
                if got[:, :, dead].abs().max().item() != 0.0:
                    raise SystemExit(f"flash_attention {shape}: a fully masked row is not 0")
    log(f"phase 5: flash_attention equals its plain version on {len(FLASH_SHAPES)} shapes "
        f"in f32 and bf16 (max abs err, and bf16's largest relative L2 error of a "
        f"{FLASH_BLOCK_ROWS}-row block where Sq >= 1024: {json.dumps(worst)}); fully masked "
        f"rows are 0")
    at = {str(dt): 0.0 for dt in FLASH_TOL}
    for shape in FLASH_OFFSET_SHAPES:
        b, hq, hkv, sq, sk, d, causal, window, off = shape
        for dt, tol in FLASH_TOL.items():
            q = torch.randn(b, hq, sq, d, generator=gen, device=dev).to(dt)
            k = torch.randn(b, hkv, sk, d, generator=gen, device=dev).to(dt)
            v = torch.randn(b, hkv, sk, d, generator=gen, device=dev).to(dt)
            got = fak.flash_attention(q, k, v, causal=causal, window=window, q_offset=off)
            want = attention(q, k, v, causal=causal, window=window, q_offset=off,
                             impl="reference")
            sync()
            at[str(dt)] = max(at[str(dt)], require_close(f"flash_attention {shape} {dt}", got,
                                                         want, tol))
            if dt == torch.bfloat16 and sq >= 1024:
                at["bf16_block_rel_l2"] = max(at.get("bf16_block_rel_l2", 0.0),
                                              require_block_rel_l2(f"flash_attention {shape}",
                                                                   got, want))
    log(f"phase 5: flash_attention at q_offset != 0 (or Sq < Sk) equals its plain version on "
        f"{len(FLASH_OFFSET_SHAPES)} shapes in f32 and bf16: {json.dumps(at)}")
    worst["at_offset"] = at
    return worst


# ---------------------------------------------------------------------------
# phase 6: the LM's serving path at full width
# ---------------------------------------------------------------------------


def _decode_alone(eng, params, req, slot: int):
    """Greedy tokens of ``req`` decoded with ``decode_step`` as the only
    sequence in a cache of the engine's shape, in the slot (and so at the
    positions and matrix shapes) the engine gave it.  For audio a prompt row
    fills every codebook and a generated id all of them, as in the engine."""
    model, ncb = eng.model, eng.cfg.n_codebooks
    cache = model.decode_init(eng.max_batch, eng.max_len)
    cache["start"] = torch.zeros(eng.max_batch, dtype=torch.int32, device=eng.device)
    tokens = torch.zeros((eng.max_batch, 1) + ((ncb,) if ncb > 1 else ()), dtype=torch.int32,
                         device=eng.device)
    prompt, gen = torch.as_tensor(req.prompt, device=eng.device), []
    with torch.no_grad():
        for t in range(len(prompt) + req.max_new_tokens - 1):
            tokens[slot, 0] = prompt[t] if t < len(prompt) else gen[-1]
            logits, cache = model.decode_step(params, tokens, cache)
            if t >= len(prompt) - 1:
                row = logits[:, -1].float().cpu().numpy()[slot]
                gen.append(eng._sample(req, row, position=t + 1))
    return gen


def _synced(fn, acc: dict, key: str):
    """``fn``, adding its host time (synced before and after) to ``acc[key]``."""
    def run(*args, **kwargs):
        sync()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sync()
        acc[key] += time.perf_counter() - t0
        return out
    return run


def _rel_l2(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


def _logits_distance(what: str, got, want, vocab: int):
    """Relative L2 and top-1 agreement of two last-token logits; exits if a
    value is not finite."""
    a, b = got[..., :vocab].float(), want[..., :vocab].float()
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise SystemExit(f"{what}: logits are not finite")
    return _rel_l2(a, b), (a.argmax(-1) == b.argmax(-1)).flatten().tolist()


def _check_logits(what: str, got, want, vocab: int):
    """:func:`_logits_distance`, and an exit if either is off the limit."""
    rel, top1 = _logits_distance(what, got, want, vocab)
    if rel > LOGITS_REL_L2 or not all(top1):
        raise SystemExit(f"{what}: relative L2 {rel} (limit {LOGITS_REL_L2}), top-1 "
                         f"agreeing {top1}")
    return rel, top1


def _model_handoff(model, params, tokens, _batch):
    """The prefill's recurrent states continued by one ``decode_step``,
    against the prefill of one token more (ssm: the whole model)."""
    n = tokens.shape[1] - 1
    with torch.no_grad():
        states = model.init_recurrent_states(tokens.shape[0], model.cfg.param_dtype)
        _, _, new_states = model.hidden_states(params, tokens[:, :n], states=states)
        cache = {"len": torch.tensor(n, dtype=torch.int32, device=tokens.device),
                 "states": new_states}
        got, _ = model.decode_step(params, tokens[:, n:], cache)
        full_states = model.init_recurrent_states(tokens.shape[0], model.cfg.param_dtype)
        hid, _, _ = model.hidden_states(params, tokens, states=full_states)
        want = model._logits(params, hid[:, -1:])
    return {"whole model": _check_logits("handoff", got, want, model.cfg.vocab)[0]}


def _block_handoff(model, params, tokens, _batch):
    """The handoff on the first and last mamba2 layers (hybrid: the prefill
    yields no KV cache for the shared block): a block run over the prompt,
    its state continued by one decode step, against the block run over one
    token more, on the prompt's embeddings."""
    cfg, n = model.cfg, tokens.shape[1] - 1
    x = model_layers.embed_apply(params["embed"], cfg, tokens)
    out = {}
    with torch.no_grad():
        for i in (0, cfg.n_layers - 1):
            p = tree_map(lambda t: t[i], params["blocks"])
            _, st = model_blocks.mamba2_block_apply(p, cfg, x[:, :n])
            got, _ = model_blocks.mamba2_block_apply(p, cfg, x[:, n:], state=st)
            want, _ = model_blocks.mamba2_block_apply(p, cfg, x)
            a, b = got[:, -1].float(), want[:, -1].float()
            if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
                raise SystemExit(f"handoff at layer {i}: not finite")
            out[f"layer {i}"] = _rel_l2(a, b)
            if out[f"layer {i}"] > LOGITS_REL_L2:
                raise SystemExit(f"handoff at layer {i}: relative L2 {out[f'layer {i}']}")
    return out


def _xattn_decode_check(model, params, tokens, batch):
    """vlm: the first ``XATTN_DECODE_TOKENS`` prompt tokens decoded one at a
    time over the cross K/V that ``decode_init`` precomputes from the image
    tokens, against the prefill's logits at every position.  Held to
    ``LOGITS_REL_L2`` on an f32 copy of the first group (its ``every`` layers,
    its cross-attention block, ``ln_f`` and the head: the decode launches the
    kernel at Sq 1 against the image tokens); the whole bf16 model's figure is
    reported."""
    cfg, n = model.cfg, XATTN_DECODE_TOKENS
    toks, mem = tokens[:, :n], batch["memory"]

    def decode_against_prefill(m, p, memory):
        with torch.no_grad():
            hid, _, _ = m.hidden_states(p, toks, memory=memory)
            want = m._logits(p, hid)
            cache = m.decode_init(toks.shape[0], n, params=p, memory=memory)
            got = []
            for t in range(n):
                lg, cache = m.decode_step(p, toks[:, t:t + 1], cache)
                got.append(lg)
        a, b = torch.cat(got, 1)[..., :cfg.vocab].float(), want[..., :cfg.vocab].float()
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise SystemExit("vlm decode over the cross K/V: logits are not finite")
        return _rel_l2(a, b), (a.argmax(-1) == b.argmax(-1)).float().mean().item()

    every = cfg.xattn_every
    p32 = {"embed": tree_map(lambda t: t.float(), params["embed"]),
           "ln_f": tree_map(lambda t: t.float(), params["ln_f"]),
           "blocks": tree_map(lambda t: t[:every].float(), params["blocks"]),
           "xattn": tree_map(lambda t: t[:1].float(), params["xattn"])}
    rel32, agree32 = decode_against_prefill(
        LM(cfg.scaled(n_layers=every, dtype="float32"), model.device), p32, mem.float())
    del p32
    torch.cuda.empty_cache()
    if rel32 > LOGITS_REL_L2:
        raise SystemExit(f"vlm decode over the cross K/V, f32 first group: relative L2 {rel32} "
                         f"(limit {LOGITS_REL_L2})")
    rel16, agree16 = decode_against_prefill(model, params, mem)
    return {"tokens": n, "first group f32 (held)": rel32, "first group f32 top-1 share": agree32,
            "whole model bf16 (reported)": rel16, "whole model bf16 top-1 share": agree16}


def dispatch_twin(probs: np.ndarray, k: int, capacity: int):
    """numpy twin of ``moe_dispatch`` on given router probabilities (T, e):
    top-k with ties to the lower expert index, slots granted in (expert,
    phase) order, the pairs past ``capacity`` dropped to slot ``e *
    capacity``.  Returns (gate_idx, keep, slot), each (T, k)."""
    T, e = probs.shape
    gate_idx = np.argsort(-probs, axis=1, kind="stable")[:, :k]
    eid = gate_idx.reshape(-1)
    order = np.argsort(eid, kind="stable")
    seg_start = np.searchsorted(eid[order], np.arange(e))
    pos = np.empty_like(eid)
    pos[order] = np.arange(eid.size) - seg_start[eid[order]]
    keep = pos < capacity
    slot = np.where(keep, eid * capacity + pos, e * capacity)
    return gate_idx, keep.reshape(T, k), slot.reshape(T, k)


@contextlib.contextmanager
def _moe_dispatches(calls=()):
    """The model's MoE dispatches run as they would; the results of the
    calls numbered ``calls`` (in layer order) are kept with their capacity,
    and every call's dropped pairs are summed on the card (``stats``, read
    by the caller)."""
    kept, stats, n, real = {}, {"dropped": 0, "pairs": 0}, [0], model_layers.moe_dispatch

    def recording(router, cfg, xt, capacity):
        res = real(router, cfg, xt, capacity)
        if n[0] in calls:
            kept[n[0]] = ([t.clone() for t in res], capacity)
        n[0] += 1
        stats["dropped"] = stats["dropped"] + (~res[3]).sum()
        stats["pairs"] += res[3].numel()
        return res

    model_layers.moe_dispatch = recording
    try:
        yield kept, stats
    finally:
        model_layers.moe_dispatch = real


def _drop_share(stats) -> float:
    return int(stats["dropped"]) / stats["pairs"] if stats["pairs"] else 0.0


def _dispatch_gate(kept, k: int) -> dict:
    """The card's dispatch of the kept MoE calls against :func:`dispatch_twin`
    on the card's own router probabilities: ``gate_idx``, ``keep`` and the
    slots equal, int for int."""
    out = {}
    for i, ((probs, _, gate_idx, keep, slot), capacity) in sorted(kept.items()):
        want = dispatch_twin(probs.cpu().numpy(), k, capacity)
        for name, got, w in zip(("gate_idx", "keep", "slot"), (gate_idx, keep, slot), want):
            got = got.cpu().numpy()
            if got.shape != w.shape or not np.array_equal(got, w):
                bad = int(np.flatnonzero(got.reshape(-1) != w.reshape(-1))[0]) \
                    if got.shape == w.shape else -1
                raise SystemExit(f"MoE dispatch of layer {i}: {name} differs from the numpy "
                                 f"twin (first at flat index {bad})")
        kept_np = keep.cpu().numpy()
        out[f"layer {i}"] = {"tokens": int(probs.shape[0]), "capacity": capacity,
                             "pairs": int(kept_np.size),
                             "dropped_share": float(1 - kept_np.mean())}
    return out


def _near_tie_differences(mesh_call, one_call, k: int) -> dict:
    """One MoE dispatch on the mesh against the same call on one device: the
    tokens whose top-k (``gate_idx``, in order) differ, each allowed only
    where the one-device router's first k + 1 probabilities come within
    ``MESH_ROUTER_TIE`` of one another (a near tie that rounding of the
    router's input may break either way).  With ``gate_idx`` equal, ``keep``
    and the slots follow from it (held by :func:`_dispatch_gate`)."""
    (_, _, idx_m, _, _), _ = mesh_call
    (probs_1, _, idx_1, _, _), _ = one_call
    top = torch.sort(probs_1, dim=-1, descending=True, stable=True).values[:, :k + 1]
    margin = (top[:, :-1] - top[:, 1:]).min(dim=-1).values
    differ = (idx_m != idx_1).any(dim=-1)
    widest = float(margin[differ].max()) if bool(differ.any()) else None
    return {"tokens_differing": int(differ.sum()), "widest_margin_differing": widest,
            "ok": widest is None or widest < MESH_ROUTER_TIE}


@contextlib.contextmanager
def _scan_inputs_of(calls, to=None):
    """The model's prefill scans run as they would; the inputs of the scan
    calls numbered ``calls`` (in the order the layers make them) are kept
    (copied to the device ``to``, by default where they are)."""
    kept, n, real = {}, [0], ssd_ops.ssd_scan

    def keep(t):
        return None if t is None else t.clone() if to is None else t.to(to, copy=True)

    def recording(q, k, v, w, **kw):
        if n[0] in calls:
            kept[n[0]] = ((keep(q), keep(k), keep(v), keep(w)), {**kw, "h0": keep(kw["h0"])})
        n[0] += 1
        return real(q, k, v, w, **kw)

    ssd_ops.ssd_scan = recording
    try:
        yield kept
    finally:
        ssd_ops.ssd_scan = real


def _scan_margin(got, hT, want, want_h, tol: float) -> dict:
    """For a scan's y and final state: the share of the element limit it
    reached (:func:`limit_share`) and its relative L2 against the plain
    version."""
    return {name: {"limit_share": limit_share(a, b, tol), "rel_l2": _rel_l2(a.float(), b.float())}
            for name, a, b in (("y", got, want), ("final_state", hT, want_h))}


def _layer_scan_gate(kept) -> dict:
    """``ssd_scan`` on the kept inputs of model layers (in the dtype the
    prefill gave them) against its plain version, outputs and final states
    within that dtype's tolerance of phase 8; per scan call the max abs
    error, its heads and :func:`_scan_margin`."""
    out = {}
    with uncounted():
        for i, (args, kw) in sorted(kept.items()):
            kw = {**kw, "return_state": True}
            del kw["impl"]
            dtype = args[0].dtype
            tol = SSD_TOL[dtype]
            got, hT = ssk.ssd_scan(*args, **kw)
            want, want_h = ssd_scan(*args, **kw, impl="reference")
            what = (f"ssd_scan on the inputs of scan call {i} of the "
                    f"{str(dtype).removeprefix('torch.')} prefill ({args[0].shape[1]} heads)")
            out[f"call {i}"] = {
                "heads": args[0].shape[1],
                "max_abs_err": max(require_close(what, got, want, tol),
                                   require_close(what + ", final state", hT, want_h, tol)),
                **_scan_margin(got, hT, want, want_h, tol)}
    return out


def _paged_drain_check(eng, key: str, gen, reusable: set, dev) -> dict:
    """``paged_attention`` on the engine's own block tables at this tick:
    each live slot's pages from ``eng.pages.block_table`` and its length
    ``cache["len"] - cache["start"][slot]``, both passed on the host, and its
    cache rows of the first and last attention layer copied into those pages
    of a pool of random rows.  The kernel (a launch of the path, so counted) is held within the
    working type's tolerance to the plain paged version and to the engine's
    own dense decode attention over the slot's cache."""
    cache = eng.cache
    live = [s for s, r in enumerate(eng.slots) if r is not None]
    page = eng.page_size
    table = eng.pages.block_table([eng.slots[s].id for s in live], eng.max_len // page)
    start = cache["start"][live]
    lens = (cache["len"] - start).to(torch.int32)
    starts, lengths = start.tolist(), lens.tolist()
    n_pages = [-(-n // page) for n in lengths]
    pages = {int(p) for i, n in enumerate(n_pages) for p in table[i, :n]}
    # the tables as the engine holds them, on the host: the call reads nothing back
    bt, sl = torch.as_tensor(table), torch.tensor(lengths, dtype=torch.int32)
    n_attn, err, share = cache[key]["k"].shape[0], 0.0, 0.0
    for layer in (0, n_attn - 1):
        k_all, v_all = cache[key]["k"][layer], cache[key]["v"][layer]  # (slots, Hkv, T, D)
        _, hkv, _, d = k_all.shape
        pool = [torch.randn(eng.pages.num_pages, page, hkv, d, generator=gen, device=dev)
                .to(k_all.dtype) for _ in range(2)]
        for i, slot in enumerate(live):
            for j in range(n_pages[i]):
                lo, rows = starts[i] + page * j, min(page, lengths[i] - page * j)
                for dst, src in zip(pool, (k_all, v_all)):
                    dst[table[i, j], :rows] = src[slot, :, lo:lo + rows].transpose(0, 1)
        q = torch.randn(len(live), eng.cfg.n_heads, d, generator=gen, device=dev).to(k_all.dtype)
        got = pak.paged_attention(q, *pool, bt, sl)
        plain = paged_attention(q, *pool, bt, sl, impl="reference")
        dense = model_layers._decode_attention(q[:, :, None], k_all[live], v_all[live],
                                               cache["len"], start=start)[:, :, 0]
        what, tol = f"paged_attention at tick {eng.ticks}, attention layer {layer}", \
            PAGED_TOL[k_all.dtype]
        err = max(err, require_close(what, got, plain, tol),
                  require_close(what + ", against the dense decode attention", got, dense, tol))
        share = max(share, limit_share(got, plain, tol), limit_share(got, dense, tol))
    return {"tick": eng.ticks, "tables": len(live), "pages": pages, "max_abs_err": err,
            "limit_share": share, "reused": len(pages & reusable)}


def _paged_drain_summary(phase: int, checks: list, reusable: set) -> dict:
    """Exits unless there were enough checks and one saw reused pages."""
    if len(checks) < PAGED_MIN_CHECKS or not any(c["reused"] for c in checks):
        raise SystemExit(f"phase {phase}: {len(checks)} paged decode checks, reused pages "
                         f"{[c['reused'] for c in checks]}: too few checks or no page reused")
    pages = set().union(*(c["pages"] for c in checks))
    res = {"checks": len(checks), "ticks": [c["tick"] for c in checks],
           "block_tables": sum(c["tables"] for c in checks), "kernel_calls": 2 * len(checks),
           "distinct_pages": len(pages), "reused_pages": len(pages & reusable),
           "max_abs_err": max(c["max_abs_err"] for c in checks),
           "limit_share": max(c["limit_share"] for c in checks)}
    log(f"phase {phase}: paged decode on the engine's own block tables at ticks {res['ticks']}: "
        f"{res['block_tables']} block tables, first and last attention layer, "
        f"{res['distinct_pages']} distinct pages of which {res['reused_pages']} were granted "
        f"before to a finished sequence; the kernel equals the plain paged version and the "
        f"dense decode attention (max abs err {res['max_abs_err']}, {res['limit_share']:.3f} of "
        f"the limit at its worst element)")
    return res


def _serve_requests(cfg, seed: int):
    """Phase 6's traffic: SERVE_REQUESTS requests of SERVE_PROMPT tokens (a
    row of every codebook for audio) and SERVE_NEW new ones, half greedy;
    and the generator that drew them, for the second wave."""
    rng, cb = np.random.default_rng(seed + 1), _codebooks(cfg)
    out = []
    for i in range(SERVE_REQUESTS):
        plen = int(rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1))
        out.append(dict(id=i, prompt=rng.integers(0, cfg.vocab, (plen,) + cb).astype(np.int32),
                        max_new_tokens=SERVE_NEW, temperature=0.0 if i % 2 == 0 else 0.8))
    return out, rng


def _codebooks(cfg) -> tuple:
    return (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()


def _serve_again(cfg, params, seed: int, dev, done) -> dict:
    """MoE: the same traffic on a fresh engine must give the same tokens (a
    request decoded alone would see other capacity drops than in a batch,
    as in the reference); each tick's share of (token, expert) pairs
    dropped is read here."""
    eng = ServingEngine(cfg, params, max_batch=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                        page_size=SERVE_PAGE, seed=seed, device=dev)
    for r in _serve_requests(cfg, seed)[0]:
        eng.submit(Request(**r))
    shares = []
    while eng.queue or any(s is not None for s in eng.slots):
        with _moe_dispatches() as (_, stats):
            eng.tick()
        shares.append(_drop_share(stats))
    for rid, req in done.items():
        if eng.finished[rid].generated != req.generated:
            raise SystemExit(f"request {rid}: a second engine on the same traffic gave other "
                             f"tokens")
    return {"ticks": eng.ticks, "dropped_share_mean": statistics.mean(shares),
            "dropped_share_min": min(shares), "dropped_share_max": max(shares)}


def lm_serve_path(arch: str, phase: int, seed: int, dev, *, plain_run: dict,
                  per_prefill: dict, handoff=None, gate_f32: bool = False,
                  scan_calls=(), n_layers=None, prefill_len=None) -> dict:
    """One LM at full width (``n_layers`` cuts its depth): the prefill
    through the kernels (each called ``per_prefill[name]`` times), held
    against the prefill with ``plain_run`` forcing a plain version, the
    ``handoff`` from the prefill to decode where the model has one, and
    continuous-batching serving.  A vlm's cross-attention gates and its image
    tokens are drawn nonzero from the seed.

    With ``gate_f32`` the kernel-against-plain comparison and the handoff
    are held to their limit on an f32 copy of the same weights, and the bf16
    comparison of the logits is measured and reported: the random recurrent
    stacks carry a rounding difference of one bf16 step through their depth
    chaotically, so at bf16 the comparison measures that amplification and
    not the kernel.  The bf16 kernel is held per layer instead: the inputs
    of the scan calls numbered ``scan_calls`` in the bf16 prefill are kept,
    and the kernel on them is held to its plain version (outputs and final
    states).  An MoE model's dispatch is held on its first and last layer's
    own prefill inputs to a numpy twin, int for int, and its serving to a
    second engine on the same traffic.  Launches made only to compare are
    not counted."""
    cfg = get_config(arch)
    full_bytes = param_bytes(LM(cfg, "meta").meta())
    if n_layers is not None:
        cfg = cfg.scaled(n_layers=n_layers)
    moe, cb = cfg.moe is not None, _codebooks(cfg)
    prefill_len = prefill_len or PREFILL_LEN
    out = {"arch": cfg.name, "layers": cfg.n_layers}
    model = LM(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params, dt = wall_s(lambda: model.init(gen))
    if cfg.xattn_every:  # the reference's zeros would leave the cross path out
        for leaf in (params["xattn"]["attn"]["gate"], params["xattn"]["ffn_gate"]):
            leaf.uniform_(0.3, 1.0, generator=gen)
    out["params"] = param_count(model.meta())
    out["param_bytes"] = param_bytes(model.meta())
    out["init_s"] = dt
    cut = "" if n_layers is None else \
        f" (depth cut to {n_layers} layers; all {get_config(arch).n_layers}: " \
        f"{full_bytes / 1e9:.2f} GB)"
    log(f"phase {phase}: {cfg.name} at full width, {out['params']} parameters "
        f"({out['param_bytes'] / 1e9:.2f} GB){cut} drawn on the card in {dt:.2f} s")

    # prefill through the kernels, then with a plain version forced
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, cfg.vocab, (PREFILL_BATCH, prefill_len) + cb)
    nxt = rng.integers(0, cfg.vocab, (PREFILL_BATCH, 1) + cb)  # the handoff's next token
    tokens = torch.as_tensor(np.concatenate([prompt, nxt], 1).astype(np.int32), device=dev)
    batch = {"tokens": tokens[:, :prefill_len]}
    if cfg.xattn_every:  # the image tokens, as the stub frontend supplies them
        batch["memory"] = torch.randn(PREFILL_BATCH, cfg.n_img_tokens, cfg.d_model,
                                      generator=gen, device=dev).to(cfg.param_dtype)
    prefill, _, _ = build_prefill_step(cfg, device=dev)
    plain, _, _ = build_prefill_step(cfg, device=dev, run_overrides=plain_run)
    torch.cuda.reset_peak_memory_stats()
    before = {name: (WRAPPERS[name].calls, WRAPPERS[name].launches) for name in per_prefill}
    moe_calls = (0, cfg.n_layers - 1) if moe else ()
    with _scan_inputs_of(scan_calls) as kept, _moe_dispatches(moe_calls) as (dispatches, drops):
        logits, warm_s = wall_s(lambda: prefill(params, batch))
    counts = {name: WRAPPERS[name].calls - before[name][0] for name in per_prefill}
    launched = {name: WRAPPERS[name].launches - before[name][1] for name in per_prefill}
    if counts != per_prefill:
        raise SystemExit(f"prefill called {counts}, not {per_prefill}")
    times = [wall_s(lambda: prefill(params, batch))[1] for _ in range(PREFILL_RUNS)]
    peak = torch.cuda.max_memory_allocated()
    _, prof = profile_window(lambda: prefill(params, batch), 1, "prefill")
    log(f"phase {phase}: prefill profile: " + json.dumps(prof))
    with uncounted():
        want, plain_s = wall_s(lambda: plain(params, batch))
    vp = model_layers.padded_vocab(cfg)
    if logits.shape != (PREFILL_BATCH, 1) + cb + (vp,):
        raise SystemExit(f"prefill logits of shape {tuple(logits.shape)}")
    compare = _logits_distance if gate_f32 else _check_logits
    rel, top1 = compare(f"prefill against {plain_run}", logits, want, cfg.vocab)
    med = statistics.median(times)
    n_tok = PREFILL_BATCH * prefill_len
    out["prefill"] = {
        "batch": PREFILL_BATCH, "prompt_len": prefill_len, "warmup_s": warm_s,
        "s": times, "median_s": med, "prompt_tokens_per_s": n_tok / med,
        "plain_s": plain_s, "plain_run": plain_run, "peak_bytes": peak,
        "argument_bytes": _tree_bytes({"params": params, "batch": batch}),
        "calls_per_prefill": counts, "launches_per_prefill": launched,
        "logits_rel_l2": rel, "top1_agree": top1, "profile": prof,
    }
    del logits, want
    if scan_calls:
        out["prefill"]["layer_scan_gate"] = _layer_scan_gate(kept)
    del kept
    log(f"phase {phase}: prefill {PREFILL_BATCH} x {prefill_len}{' x ' + str(cb[0]) if cb else ''}"
        f": median {med:.4f} s of {PREFILL_RUNS} ({n_tok / med:.0f} prompt tokens/s), warm-up "
        f"{warm_s:.3f} s, with {plain_run} {plain_s:.3f} s; peak {peak / 1e9:.2f} GB; kernel "
        f"calls per prefill {counts}, launches {launched}; last-token logits within {rel:.3e} "
        f"relative L2 of the plain run's, top-1 agreeing {top1}")
    if scan_calls:
        log(f"phase {phase}: ssd_scan on the bf16 inputs of the prefill's scan calls "
            f"{list(scan_calls)} (first and last layer) equals its plain version within "
            f"{SSD_TOL[torch.bfloat16]}, outputs and final states: "
            f"{json.dumps(out['prefill']['layer_scan_gate'])}")
    if moe:
        out["prefill"]["dropped_share"] = _drop_share(drops)
        out["prefill"]["dispatch_gate"] = _dispatch_gate(dispatches, cfg.moe.top_k)
        log(f"phase {phase}: MoE dispatch on the first and last layer's own prefill inputs "
            f"equals the numpy twin on the card's router probabilities (gate_idx, keep and "
            f"slots, int for int): {json.dumps(out['prefill']['dispatch_gate'])}; pairs dropped "
            f"over every layer of the prefill: {out['prefill']['dropped_share']:.4f}")
    del dispatches, drops
    gate_model, gate_params, gated = model, params, "bf16"
    if gate_f32:
        cfg32 = cfg.scaled(dtype="float32")
        gate_model = LM(cfg32, dev)
        gate_params = tree_map(lambda t: t.float(), params)
        k32, _, _ = build_prefill_step(cfg32, device=dev)
        p32, _, _ = build_prefill_step(cfg32, device=dev, run_overrides=plain_run)
        with uncounted():
            (got, want), dt = wall_s(lambda: (k32(gate_params, batch),
                                              p32(gate_params, batch)))
        rel32, top1_32 = _check_logits(f"f32 prefill against {plain_run}", got, want, cfg.vocab)
        out["prefill"].update(f32_logits_rel_l2=rel32, f32_top1_agree=top1_32,
                              bf16_gated=False)
        gated = "f32 copy of the weights"
        log(f"phase {phase}: the same prefill on an f32 copy of the weights ({dt:.2f} s for "
            f"both): last-token logits within {rel32:.3e} relative L2 of the plain run's "
            f"(limit {LOGITS_REL_L2}), top-1 agreeing {top1_32}; the bf16 figure above is "
            f"measured, not held to the limit")
        del got, want
    if handoff is not None:
        with uncounted():
            out["handoff_rel_l2"], dt = wall_s(lambda: handoff(gate_model, gate_params, tokens,
                                                               batch))
        log(f"phase {phase}: prefill-to-decode handoff ({handoff.__name__}) on the {gated} "
            f"({dt:.2f} s): decode continuing the prompt gives the prefill's result within "
            f"relative L2 {json.dumps(out['handoff_rel_l2'])}")
    del tokens, batch, gate_params
    torch.cuda.empty_cache()

    # continuous-batching serving over the wait-free page table
    eng = ServingEngine(cfg, params, max_batch=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                        page_size=SERVE_PAGE, seed=seed, device=dev)
    requests, rng = _serve_requests(cfg, seed)
    for r in requests:
        eng.submit(Request(**r))
    split = {"decode_step": 0.0, "page_ops": 0.0}
    eng.model.decode_step = _synced(eng.model.decode_step, split, "decode_step")
    eng.pages.step_ops = _synced(eng.pages.step_ops, split, "page_ops")
    done, run_s = wall_s(eng.run)
    del eng.model.decode_step, eng.pages.step_ops
    if sorted(done) != list(range(SERVE_REQUESTS)) or any(
            len(r.generated) != SERVE_NEW for r in done.values()):
        raise SystemExit("serving did not drain every request to its length")
    if len(eng.pages.free) != eng.pages.num_pages or eng.pages.seq_pages:
        raise SystemExit("serving leaked KV pages")
    twin = eng.failover()  # raises unless the replayed page tables match
    for f in GraphState._fields:
        if not torch.equal(getattr(twin.graph.state, f), getattr(eng.pages.graph.state, f)):
            raise SystemExit(f"failover replay: page-table graph differs in {f}")
    n_gen = sum(len(r.generated) for r in done.values())
    out["serve"] = {
        "slots": SERVE_SLOTS, "max_len": SERVE_MAX_LEN, "page_size": SERVE_PAGE,
        "requests": SERVE_REQUESTS, "ticks": eng.ticks, "generated_tokens": n_gen,
        "prompt_tokens": sum(len(r.prompt) for r in done.values()),
        "s": run_s, "generated_tokens_per_s": n_gen / run_s, "host_split_s": split,
        "page_ops": sum(len(o[0]) for o in eng.pages.op_log),
        "page_table_capacity": [eng.pages.graph.state.v_capacity,
                                eng.pages.graph.state.e_capacity],
    }
    if moe:
        out["serve"]["again"] = _serve_again(cfg, params, seed, dev, done)
        same = (f"the same traffic on a fresh engine gives the same tokens (pairs dropped a "
                f"tick: mean {out['serve']['again']['dropped_share_mean']:.4f}, "
                f"{out['serve']['again']['dropped_share_min']:.4f}-"
                f"{out['serve']['again']['dropped_share_max']:.4f})")
    else:
        for rid in SERVE_ALONE:
            if done[rid].temperature != 0.0 or _decode_alone(eng, params, done[rid], rid) != \
                    done[rid].generated:
                raise SystemExit(f"request {rid} decoded alone differs from the batch")
        same = f"requests {list(SERVE_ALONE)} decoded alone give the batch's tokens"
    # a profiled window of full ticks on a second wave, whose sequences get
    # the pages the first wave gave back; drained by hand afterwards, with
    # the paged decode checked on the engine's own block tables
    reusable = {v for ops, _, vs in eng.pages.op_log for op, v in zip(ops, vs)
                if op == OP_ADD_EDGE}
    for i in range(SERVE_SLOTS):
        eng.submit(Request(id=SERVE_REQUESTS + i, max_new_tokens=SERVE_NEW,
                           prompt=rng.integers(0, cfg.vocab, (SERVE_PROMPT[0],) + cb)
                           .astype(np.int32)))
    eng.tick()
    _, out["serve"]["profile"] = profile_window(eng.tick, PROFILE_TICKS, "tick")
    log(f"phase {phase}: serving profile: " + json.dumps(out["serve"]["profile"]))
    kv_key = next((k for k in ("kv", "shared_kv") if k in eng.cache), None)
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    checks = []
    while eng.queue or any(s is not None for s in eng.slots):
        eng.tick()
        if kv_key and eng.ticks % PAGED_EVERY == 0 and any(s is not None for s in eng.slots):
            checks.append(_paged_drain_check(eng, kv_key, gen, reusable, dev))
    if len(eng.finished) != SERVE_REQUESTS + SERVE_SLOTS:
        raise SystemExit("serving did not drain the profiled wave")
    if kv_key:
        out["serve"]["paged_decode"] = _paged_drain_summary(phase, checks, reusable)
    log(f"phase {phase}: served {SERVE_REQUESTS} requests in {out['serve']['ticks']} ticks, "
        f"{run_s:.3f} s ({split['decode_step']:.3f} s in decode_step, "
        f"{split['page_ops']:.3f} s in page-table ops): "
        f"{n_gen} generated tokens ({n_gen / run_s:.1f} tokens/s), "
        f"{out['serve']['page_ops']} page ops applied; failover replay identical (page "
        f"tables and graph state); {same}")
    del eng, params, twin
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 7: flash attention at the prefill's shape
# ---------------------------------------------------------------------------


def _attended_pairs(s: int, causal: bool, window) -> int:
    """The (q, k) pairs the mask keeps over ``s`` positions of q and of k."""
    if not causal:
        return s * s
    w = min(window or s, s)
    return w * (w + 1) // 2 + (s - w) * w


def flash_full_shape(arch: str, cfg, launches: int, dev, *, phase: int = 7, seq=None,
                     causal: bool = True, window=None, what: str = "prefill",
                     sp_blocks: int = 1) -> dict:
    """``flash_attention`` at ``arch``'s prefill shape (``seq`` positions for
    q and k, causal or not, with its sliding ``window``), bf16, beside its
    plain version and ``scaled_dot_product_attention`` (with the window's
    boolean mask where there is one), whose own error against the plain
    version is reported too.  With ``sp_blocks`` > 1, q is the last of that
    many blocks of the sequence (the sequence-parallel layout's last model
    rank: ``q_offset`` S - S / blocks) against every key; without a window
    SDPA takes that offset's causal mask as ``causal_lower_right``, which
    keeps it on its flash backend (a boolean mask would not)."""
    b, hq, hkv, s, d = PREFILL_BATCH, cfg.n_heads, cfg.n_kv_heads, seq or PREFILL_LEN, \
        cfg.head_dim
    sq = s // sp_blocks
    off = s - sq
    opts = {"causal": causal, "window": window, "q_offset": off}
    gen = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn(b, hq, sq, d, generator=gen, device=dev).bfloat16()
    k = torch.randn(b, hkv, s, d, generator=gen, device=dev).bfloat16()
    v = torch.randn(b, hkv, s, d, generator=gen, device=dev).bfloat16()
    label = f"flash_attention at the {arch} {what} shape"
    got = fak.flash_attention(q, k, v, **opts)
    want = attention(q, k, v, impl="reference", **opts)
    err = require_close(label, got, want, FLASH_TOL[torch.bfloat16])
    block_rel = require_block_rel_l2(label, got, want)
    del got
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = None
    if window is not None:
        qpos, kpos = off + torch.arange(sq, device=dev), torch.arange(s, device=dev)
        mask = kpos[None, :] > qpos[:, None] - window
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
    elif causal and off:
        # q's rows are the last sq of s positions: the lower-right causal mask
        mask = torch.nn.attention.bias.causal_lower_right(sq, s)

    def library():
        if mask is not None:
            return sdpa(q, k, v, attn_mask=mask, enable_gqa=True)
        return sdpa(q, k, v, is_causal=causal, enable_gqa=True)

    lib_err = (library().float() - want.float()).abs().max()
    del want
    pairs = _attended_pairs(s, causal, window) - (_attended_pairs(off, causal, window)
                                                   if causal else off * s)
    flops = 4 * b * hq * pairs * d
    row = {
        "name": "flash_attention" if arch == LM_ARCH and what == "prefill" else
                f"flash_attention[{arch}" + ("" if what == "prefill" else f" {what}") + "]",
        "route": "cuda", "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:106",
        "launches": launches, "max_abs_err": err, "block_rel_l2": block_rel,
        "ms": cuda_ms(lambda: fak.flash_attention(q, k, v, **opts), 10),
        "plain_ms": cuda_ms(lambda: attention(q, k, v, impl="reference", **opts), 3),
        "bound_ms": None, "bound_by": None,
        "library_ms": cuda_ms(library, 10),
        "library_max_abs_err": lib_err.item(),
        "shape": {"B": b, "Hq": hq, "Hkv": hkv, "S": s, "D": d, "dtype": "bfloat16",
                  "causal": causal, "window": window},
    }
    if off:
        row["shape"].update(Sq=sq, q_offset=off)
    t_bytes = 2 * (q.numel() * 2 + k.numel() + v.numel()) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_OPS_PER_S * 1e3
    row["bound_ms"], row["bound_by"] = (t_ops, "operations") if t_ops >= t_bytes else \
        (t_bytes, "bytes")
    row["tflops"] = flops / row["ms"] / 1e9
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    log(f"phase {phase}: {label} B={b} Hq={hq} Hkv={hkv} S={s} D={d} bf16 "
        f"{'causal' if causal else 'non-causal'}{f' window {window}' if window else ''}"
        f"{f' Sq={sq} q_offset={off}' if off else ''}: "
        f"{row['ms']:.4f} ms, {row['tflops']:.1f} TFLOP/s, "
        f"{100 * row['share_of_bound']:.1f}% of the bound {row['bound_ms']:.4f} ms by "
        f"{row['bound_by']} (plain {row['plain_ms']:.3f} ms, scaled_dot_product_attention "
        f"{row['library_ms']:.4f} ms); max abs err {err}, scaled_dot_product_attention's "
        f"{row['library_max_abs_err']}; largest relative L2 error of a {FLASH_BLOCK_ROWS}-row "
        f"block {block_rel} (limit {FLASH_BLOCK_REL_TOL})")
    return row


# ---------------------------------------------------------------------------
# phases 8 and 11: the SSD scan against its plain version
# ---------------------------------------------------------------------------


def _ssd_inputs(gen, shape, scalar, dtype, dev):
    """q, k, v at scale 0.5, a decay in (0, 1) (one per (b, h, t) when
    ``scalar``) with whole steps at 1, 0 and 1e-30, and an f32 state."""
    b, h, s, k, v = shape[:5]
    q = (torch.randn(b, h, s, k, generator=gen, device=dev) * 0.5).to(dtype)
    kk = (torch.randn(b, h, s, k, generator=gen, device=dev) * 0.5).to(dtype)
    vv = (torch.randn(b, h, s, v, generator=gen, device=dev) * 0.5).to(dtype)
    w = torch.rand(b, h, s, 1 if scalar else k, generator=gen, device=dev) * 0.99 + 0.01
    w = w.expand(b, h, s, k).clone()
    w[:, :, ::7] = 1.0
    w[:, :, 3::11] = 0.0
    w[:, :, 5::13] = 1e-30
    h0 = torch.randn(b, h, k, v, generator=gen, device=dev)
    return q, kk, vv, w.to(dtype), h0


def ssd_small_checks(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(5)
    worst = {str(dt): 0.0 for dt in SSD_TOL}
    n = 0
    for shape in SSD_SHAPES:
        chunk = shape[5]
        for scalar in (False, True):
            for strict in (False, True):
                for dt, tol in SSD_TOL.items():
                    q, k, v, w, h0 = _ssd_inputs(gen, shape, scalar, dt, dev)
                    got, hT = ssk.ssd_scan(q, k, v, w, chunk=chunk, scalar_decay=scalar,
                                           strict=strict, h0=h0, return_state=True)
                    want, want_h = ssd_scan(q, k, v, w, chunk=chunk, strict=strict, h0=h0,
                                            return_state=True, impl="reference")
                    sync()
                    what = f"ssd_scan {shape} scalar={scalar} strict={strict} {dt}"
                    err = max(require_close(what, got, want, tol),
                              require_close(what + " final state", hT, want_h, tol))
                    if scalar:  # the one-column decay gives the same result
                        got1, hT1 = ssk.ssd_scan(q, k, v, w[..., :1].contiguous(), chunk=chunk,
                                                 scalar_decay=True, strict=strict, h0=h0,
                                                 return_state=True)
                        if not (torch.equal(got1, got) and torch.equal(hT1, hT)):
                            raise SystemExit(f"{what}: a one-column decay gives another result")
                    worst[str(dt)] = max(worst[str(dt)], err)
                    n += 1
    log(f"phase 8: ssd_scan equals its plain version in {n} cases ({len(SSD_SHAPES)} shapes, "
        f"both decay modes and readouts, f32 and bf16, decays of 1, 0 and 1e-30, a nonzero "
        f"initial state; outputs and final states; max abs err {json.dumps(worst)}); in "
        f"scalar mode a one-column decay gives the same result bit for bit")
    return worst


SSD_BOUND_CHUNKS = (1, 2, 4, 8, 16)  # the chunked forms the scan's bound weighs


def _ssd_bound(b, h, s, k, v, scalar, strict, elt_bytes):
    """(ms, "bytes" | "operations"), the least the scan's function needs,
    whatever chunk the caller passes (the chunk changes the rounding, not
    the function).  Bytes: q, k, v read and y written once, w read once (one
    value a step when ``scalar``), the f32 initial state read and final
    state written once.  Operations: the cheapest of the forms that keep
    every exponent <= 0.  The sequential recurrence needs no exps: per step
    and state entry the update h * w + k v (two lane instructions) and the
    readout q . h (one), on the f32 lanes.  The chunked form at each chunk
    of up to 16 that divides S: the exps on the SFUs (the pairwise decays,
    one (C, C) matrix when scalar, and the decays folded into q and k), the
    per-channel pairwise products on the f32 lanes, and the matrix products
    (q . k^T when scalar, the readout and the state update) at the TF32
    tensor-core rate."""
    def chunked(c):
        n = b * h * (s // c)  # (b, h, chunk) tiles
        pairs = c * (c - 1) // 2 if strict else c * (c + 1) // 2
        exps = n * (pairs + 2 * c + 1) if scalar else n * k * (pairs + 2 * c + 1)
        lane_flops = 0 if scalar else n * 4 * k * pairs
        tc_flops = n * (2 * (c * v * k + pairs * v + c * k * v)
                        + (2 * k * pairs if scalar else 0))
        return max(exps / EXP_PER_S, lane_flops / F32_OPS_PER_S, tc_flops / TF32_OPS_PER_S)

    sequential = b * h * s * k * v * 3 * 2 / F32_OPS_PER_S  # 3 instructions, 2 flops each
    t_ops = min([sequential] + [chunked(c) for c in SSD_BOUND_CHUNKS if s % c == 0]) * 1e3
    moved = elt_bytes * b * h * s * (2 * k + 2 * v + (1 if scalar else k)) \
        + 2 * 4 * b * h * k * v
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def ssd_full_shape(arch, cfg, scalar, strict, path, dev) -> dict:
    """``ssd_scan`` at a prefill's shape, as the model's block calls it
    (an f32 initial state in, the final state out); ``path`` has the
    launches and calls of the model's run."""
    if scalar:
        _, hds, hd, n_state = model_blocks._mamba_dims(cfg)
        k_dim, v_dim = n_state, hd
    else:
        hds, hd = model_blocks._rwkv_heads(cfg)
        k_dim, v_dim = hd, hd
    b, s = PREFILL_BATCH, PREFILL_LEN
    chunk = model_blocks._pick_chunk(s)
    gen = torch.Generator(device=dev).manual_seed(6)
    q, k, v, w, h0 = _ssd_inputs(gen, (b, hds, s, k_dim, v_dim), scalar, torch.bfloat16, dev)
    if scalar:
        w = w[..., :1].contiguous()  # one decay a step, as mamba2_block_apply passes it
    kw = dict(chunk=chunk, strict=strict, h0=h0, return_state=True)
    got, hT = ssk.ssd_scan(q, k, v, w, scalar_decay=scalar, **kw)
    want, want_h = ssd_scan(q, k, v, w, impl="reference", **kw)
    tol = SSD_TOL[torch.bfloat16]
    err = max(require_close(f"ssd_scan at the {arch} prefill shape", got, want, tol),
              require_close(f"ssd_scan final state at the {arch} prefill shape", hT, want_h, tol))
    margin = _scan_margin(got, hT, want, want_h, tol)
    # f32 arithmetic throughout: the f32 kernel on the same values, y rounded once to bf16
    got32, hT32 = ssk.ssd_scan(*(t.float() for t in (q, k, v, w)), scalar_decay=scalar, **kw)
    f32_margin = _scan_margin(got32.to(torch.bfloat16), hT32, want, want_h, tol)
    del got32, hT32
    bound = _ssd_bound(b, hds, s, k_dim, v_dim, scalar, strict, 2)
    # each pass alone (its own launch), timed as the call is
    _, _, scratch, launches = ssk.prepare(q, k, v, w, scalar_decay=scalar, **kw)
    passes = {name: cuda_ms(launch, 10) for name, launch in zip(ssk.PASSES, launches)}
    row = {
        "name": f"ssd_scan[{arch}]", "route": "cuda", "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:97",
        "launches": path["launches"]["ssd_scan"], "calls": path["calls"]["ssd_scan"],
        "max_abs_err": err, "margin": margin, "f32_rounded_margin": f32_margin,
        "ms": cuda_ms(lambda: ssk.ssd_scan(q, k, v, w, scalar_decay=scalar, **kw), 10),
        "plain_ms": cuda_ms(lambda: ssd_scan(q, k, v, w, impl="reference", **kw), 3),
        "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
        "shape": {"B": b, "H": hds, "S": s, "K": k_dim, "V": v_dim, "chunk": chunk,
                  "dtype": "bfloat16", "strict": strict, "scalar_decay": scalar},
        "pass_ms": passes,
        "scratch_bytes": scratch.numel() * scratch.element_size(),
    }
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    log(f"phase 11: ssd_scan at the {arch} prefill shape (B={b} H={hds} S={s} K={k_dim} "
        f"V={v_dim} chunk {chunk} bf16 strict={strict} scalar={scalar}): {row['ms']:.4f} ms "
        f"(plain {row['plain_ms']:.3f} ms; no single PyTorch call computes it), bound "
        f"{row['bound_ms']:.4f} ms by {row['bound_by']} ({row['share_of_bound']:.1%} of it), max "
        f"abs err {err}, margin {json.dumps(margin)} (the f32 kernel's, y rounded to bf16: "
        f"{json.dumps(f32_margin)}); ms by pass {json.dumps(passes)}; scratch "
        f"{row['scratch_bytes']} bytes; {row['calls']} calls, {row['launches']} launches on "
        f"the model's path")
    return row


# ---------------------------------------------------------------------------
# phases 12 and 13: paged decode attention against its plain version
# ---------------------------------------------------------------------------


def _paged_inputs(gen, shape, dtype, dev):
    """q, k_pages, v_pages; a block table of distinct pages, or with repeats
    where the pool is smaller than the tables (as the reference sweep draws
    it); lengths in [1, pages_per_seq * page_size]."""
    b, hq, hkv, d, p, page, pps = shape
    q = torch.randn(b, hq, d, generator=gen, device=dev).to(dtype)
    kp = torch.randn(p, page, hkv, d, generator=gen, device=dev).to(dtype)
    vp = torch.randn(p, page, hkv, d, generator=gen, device=dev).to(dtype)
    if b * pps <= p:
        bt = torch.randperm(p, generator=gen, device=dev)[: b * pps].reshape(b, pps)
    else:
        bt = torch.randint(0, p, (b, pps), generator=gen, device=dev)
    sl = torch.randint(1, page * pps + 1, (b,), generator=gen, device=dev)
    return q, kp, vp, bt.to(torch.int32), sl.to(torch.int32)


def _refused(what: str, fn) -> None:
    """Exits unless ``fn`` raises the wrapper's ValueError."""
    try:
        fn()
    except ValueError:
        return
    raise SystemExit(f"paged_attention accepted {what}")


def paged_small_checks(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(7)
    worst = {str(dt): 0.0 for dt in PAGED_TOL}
    n = 0
    for dt, tol in PAGED_TOL.items():
        for shape in PAGED_SHAPES:
            args = _paged_inputs(gen, shape, dt, dev)
            got = pak.paged_attention(*args)
            want = paged_attention(*args, impl="reference")
            sync()
            worst[str(dt)] = max(worst[str(dt)], require_close(
                f"paged_attention {shape} {dt}", got, want, tol))
            _same_on_host_tables(got, args)
            n += 1
        # lengths 0, 1, one page, three pages, the full table and two pages
        # and 5; one page repeated through a table; zero-filled table tails
        page, pps = 16, 8
        q, kp, vp, bt, _ = _paged_inputs(gen, (6, 14, 2, 128, 20, page, pps), dt, dev)
        sl = torch.tensor([0, 1, page, 3 * page, page * pps, 2 * page + 5], dtype=torch.int32,
                          device=dev)
        bt[1] = 3
        bt[3, 3:] = 0
        bt[5] = torch.tensor([4, 4, 7, 0, 0, 0, 0, 0], dtype=torch.int32, device=dev)
        got = pak.paged_attention(q, kp, vp, bt, sl)
        want = paged_attention(q, kp, vp, bt, sl, impl="reference")
        sync()
        worst[str(dt)] = max(worst[str(dt)], require_close(
            f"paged_attention edge lengths {dt}", got, want, tol))
        if got[0].abs().max().item() != 0.0:
            raise SystemExit("paged_attention: a sequence of length 0 does not give 0")
        _same_on_host_tables(got, (q, kp, vp, bt, sl))
        n += 1
    # refusals on both routes: a live page id past the pool, a negative one,
    # a length past the table, a negative length, D 136, g 17
    q, kp, vp, bt, sl = _paged_inputs(gen, (2, 4, 2, 16, 6, 4, 3), torch.float32, dev)
    past, negative = bt.clone(), bt.clone()
    past[0, 0], negative[1, 0] = kp.shape[0], -1
    before = pak.paged_attention.launches
    for route, on in (("on the card", lambda t: t), ("on the host", lambda t: t.cpu())):
        for what, tables in (("a live page id past the pool", (past, sl)),
                             ("a negative live page id", (negative, sl)),
                             ("a length past the table", (bt, torch.full_like(sl, 13))),
                             ("a negative length", (bt, torch.full_like(sl, -1)))):
            _refused(f"{what}, tables {route}",
                     lambda: pak.paged_attention(q, kp, vp, *(on(t) for t in tables)))
        for shape in ((2, 4, 2, 136, 6, 4, 3), (2, 17, 1, 16, 6, 4, 3)):
            args = _paged_inputs(gen, shape, torch.float32, dev)
            _refused(f"the shape {shape}, tables {route}",
                     lambda: pak.paged_attention(*args[:3], on(args[3]), on(args[4])))
    if pak.paged_attention.launches != before:
        raise SystemExit("paged_attention launched on a call it refused")
    log(f"phase 12: paged_attention equals its plain version in {n} cases "
        f"({len(PAGED_SHAPES)} shapes and the edge lengths 0, 1, a page, the full table, "
        f"repeated page ids and zero-filled tails, in f32 and bf16; max abs err "
        f"{json.dumps(worst)}), bit for bit the same with the tables on the host; a length "
        f"of 0 gives 0; a live page id past the pool or negative, a length past the table "
        f"or negative, D 136 and a group of 17 are refused with the tables on the card and "
        f"on the host, and nothing is launched")
    return worst


def _same_on_host_tables(got, args) -> None:
    """Exits unless the kernel, given the same tables on the host, gives
    ``got`` bit for bit (one plan, one kernel)."""
    q, kp, vp, bt, sl = args
    if not torch.equal(pak.paged_attention(q, kp, vp, bt.cpu(), sl.cpu()), got):
        raise SystemExit("paged_attention: host tables give another output than card tables")


def _paged_tables(arch: str, seed: int, dev):
    """Block tables from a ``PagedKVManager`` on the card (its graph the
    port's FPSP ``WaitFreeGraph``): ``PAGED_PRELOAD`` sequences admitted,
    every third finished, then the timed ones admitted into the pages
    given back (the free list is out of order by then).  Returns the pool
    size, the table and the timed lengths."""
    lo, hi = PAGED_LENS[arch]
    page = SERVE_PAGE
    rng = np.random.default_rng(seed + 13)
    pre = rng.integers(lo, hi + 1, PAGED_PRELOAD)
    timed = rng.integers(lo, hi + 1, PAGED_DECODE_BATCH)
    num_pages = sum(-(-int(n) // page) for n in np.concatenate([pre, timed]))
    pages = PagedKVManager(num_pages, page, device=dev)
    pages.step_ops({i: int(n) for i, n in enumerate(pre)}, [], [])
    pages.step_ops({}, [], list(range(0, PAGED_PRELOAD, 3)))
    ids = [PAGED_PRELOAD + i for i in range(PAGED_DECODE_BATCH)]
    pages.step_ops({s: int(n) for s, n in zip(ids, timed)}, [], [])
    table = pages.block_table(ids, -(-hi // page))
    scattered = sum(bool(np.any(np.diff(table[i, : -(-int(n) // page)]) != 1))
                    for i, n in enumerate(timed))
    if not scattered:
        raise SystemExit(f"phase 13 ({arch}): every timed sequence got consecutive pages")
    return num_pages, table, timed.astype(np.int32), scattered


def paged_full_shape(arch: str, cfg, launches, seed: int, dev) -> dict:
    """``paged_attention`` at one decode step of ``arch`` at full width,
    bf16, pages of 16, on block tables of the port's page table, timed as
    in phase 4, beside its plain version, its bound and
    ``scaled_dot_product_attention`` over the same K/V gathered into a
    contiguous cache (the gather not timed)."""
    b, hq, hkv, d, page = PAGED_DECODE_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, SERVE_PAGE
    num_pages, table, lens, scattered = _paged_tables(arch, seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    q = torch.randn(b, hq, d, generator=gen, device=dev).bfloat16()
    kp = torch.randn(num_pages, page, hkv, d, generator=gen, device=dev).bfloat16()
    vp = torch.randn(num_pages, page, hkv, d, generator=gen, device=dev).bfloat16()
    # the tables as PagedKVManager gives them, on the host (the main call),
    # and the same on the card
    host = (torch.as_tensor(table), torch.as_tensor(lens))
    bt, sl = (t.to(dev) for t in host)
    args = (q, kp, vp, *host)
    card_args = (q, kp, vp, bt, sl)
    with uncounted():
        got = pak.paged_attention(*args)
        if not torch.equal(pak.paged_attention(*card_args), got):
            raise SystemExit(f"paged_attention at the {arch} decode shape: card tables give "
                             f"another output than host tables")
        sync()
        torch.cuda.set_sync_debug_mode("error")  # a read from the device would raise
        try:
            pak.paged_attention(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want = paged_attention(*args, impl="reference")
        err = require_close(f"paged_attention at the {arch} decode shape", got, want,
                            PAGED_TOL[torch.bfloat16])
        rel_err = err / want.float().abs().max().item()
        share = limit_share(got, want, PAGED_TOL[torch.bfloat16])
        if rel_err > PAGED_FULL_REL_TOL:
            raise SystemExit(f"paged_attention at the {arch} decode shape: max abs err {err} is "
                             f"{rel_err:.3g} of the largest output (limit {PAGED_FULL_REL_TOL})")
        args32 = (q.float(), kp.float(), vp.float(), *host)
        err32 = require_close(f"paged_attention at the {arch} decode shape, f32",
                              pak.paged_attention(*args32),
                              paged_attention(*args32, impl="reference"), PAGED_TOL[torch.float32])
        del args32
        ms = cuda_ms(lambda: pak.paged_attention(*args), 10)
        kernel_ms = cuda_ms(pak.prepare(*args)[1], 10)  # the two kernels alone
        card_ms = cuda_ms(lambda: pak.paged_attention(*card_args), 10)
        check_ms = cuda_ms(lambda: pak._check_values(bt, sl, num_pages, page), 10)
        plain_ms = cuda_ms(lambda: paged_attention(*args, impl="reference"), 3)
        host_s = []  # the wrapper's host time with host tables, the device idle
        for _ in range(10):
            sync()
            t0 = time.perf_counter()
            pak.paged_attention(*args)
            host_s.append(time.perf_counter() - t0)
        sync()
    del want
    # the same K/V as a contiguous (B, Hkv, S_max, D) cache with a length mask
    s_max = int(lens.max())
    n_p = -(-s_max // page)
    kc, vc = (x[bt[:, :n_p].long()].reshape(b, n_p * page, hkv, d)[:, :s_max].transpose(1, 2)
              .contiguous() for x in (kp, vp))
    mask = (torch.arange(s_max, device=dev)[None, :] < sl[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_out = sdpa(q[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True)[:, :, 0]
    sdpa_err = (sdpa_out.float() - got.float()).abs().max().item()
    sdpa_ms = cuda_ms(lambda: sdpa(q[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True), 10)
    del kc, vc, sdpa_out
    rows = int(lens.sum())
    live_pages = sum(-(-int(n) // page) for n in lens)
    moved = 2 * rows * hkv * d * 2 + 2 * q.numel() * 2 + 4 * live_pages + 4 * b
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    # q . k and p . v, bf16 products on the tensor cores; one exponent a score
    t_ops = max(4 * rows * hq * d / BF16_OPS_PER_S, rows * hq / EXP_PER_S) * 1e3
    bound, by = (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")
    row = {
        "name": f"paged_attention[{arch}]", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:84",
        "launches": launches["paged_attention"],
        "launched_by": "the drain checks of phases 6 and 10; the engine decodes over a dense cache",
        "max_abs_err": err, "max_abs_err_over_max_output": rel_err, "limit_share": share,
        "rel_limit_share": rel_err / PAGED_FULL_REL_TOL, "f32_max_abs_err": err32,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "library_ms": None,
        "share_of_bound": bound / ms, "kernel_ms": kernel_ms,
        "kernel_share_of_bound": bound / kernel_ms,
        "card_tables_ms": card_ms, "check_ms": check_ms,
        "host_ms": 1e3 * statistics.median(host_s),
        "contiguous_sdpa_ms": sdpa_ms, "contiguous_sdpa_max_abs_err": sdpa_err,
        "shape": {"B": b, "Hq": hq, "Hkv": hkv, "D": d, "page_size": page,
                  "pages_per_seq": table.shape[1], "pool_pages": num_pages,
                  "live_rows": rows, "live_pages": live_pages, "bytes": moved,
                  "seq_lens": [int(n) for n in lens], "scattered_tables": scattered,
                  "dtype": "bfloat16"},
    }
    log(f"phase 13: paged_attention at the {arch} decode shape (B={b} Hq={hq} Hkv={hkv} D={d} "
        f"bf16, pages of 16, lengths {int(lens.min())}-{s_max}, {rows} live rows in "
        f"{live_pages} pages of a {num_pages}-page pool, {scattered} of {b} tables not "
        f"consecutive): {ms:.4f} ms by the wrapper with host tables ({kernel_ms:.4f} ms in its "
        f"two kernels alone, {100 * bound / kernel_ms:.1f}% of the bound; the wrapper's host time "
        f"{row['host_ms']:.4f} ms; no read from the device under sync debug mode \"error\"), "
        f"{card_ms:.4f} ms with the tables on the card (the checks alone, with their read from "
        f"the device, {check_ms:.4f} ms), plain {plain_ms:.3f} ms, bound {bound:.4f} ms by {by} "
        f"({moved / 1e6:.1f} MB), {100 * bound / ms:.1f}% of the bound; no PyTorch call reads "
        f"paged K/V: scaled_dot_product_attention over the same K/V as a contiguous cache "
        f"{sdpa_ms:.4f} ms (max abs diff {sdpa_err}); max abs err {err} ({share:.3f} of the "
        f"limit; {rel_err:.3g} of the largest output, {rel_err / PAGED_FULL_REL_TOL:.3f} of that "
        f"limit; f32 on the same tables: {err32}); launched by the drain checks of "
        f"phases 6 and 10: {launches['paged_attention']}")
    return row


def hopper_sass(so: Path) -> dict:
    """The bf16 attention kernels' machine code: each must hold wgmma
    (``HGMMA``) and TMA loads (``UTMALDG``) and no ``mma.sync`` (``HMMA``);
    the highest register its SASS names, and ptxas's register and spill
    report of each, from the build's log; then the ssd_scan kernels'
    (:func:`ssd_sass`) and the bf16 paged kernels' (:func:`paged_sass`)."""
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    out = {}
    for func in sass.split("Function : ")[1:]:
        name = func.split(None, 1)[0]
        if "flash_fwd_wgmma_kernel" not in name:
            continue
        counts = {op: len(re.findall(rf"\b{op}\b", func)) for op in ("HGMMA", "UTMALDG", "HMMA")}
        if not counts["HGMMA"] or not counts["UTMALDG"] or counts["HMMA"]:
            raise SystemExit(f"phase 1: {name} is not on wgmma and TMA: {counts}")
        # above ptxas's 168 a thread only where setmaxnreg raised the consumers' budget
        counts["highest_register"] = max(int(r) for r in re.findall(r"\bR(\d+)\b", func))
        out["D64" if "ILi64E" in name else "D128"] = counts
    if len(out) != 2:
        raise SystemExit(f"phase 1: expected the bf16 attention kernel at D 64 and 128, got {out}")
    for key, ptxas in _ptxas_report(
            so.parent / "flash_attention.nvcc.log",
            lambda line: ("D64" if "ILi64E" in line else "D128")
            if "flash_fwd_wgmma_kernel" in line else None).items():
        out[key]["ptxas"] = ptxas
    log(f"phase 1: flash_attention's bf16 kernels in SASS: {json.dumps(out)}")
    out["ssd_scan"] = ssd_sass(sass, so.parent / "ssd_scan.nvcc.log")
    out["paged_attention"] = paged_sass(sass, so.parent / "paged_attention.nvcc.log")
    return out


def _ptxas_report(report: Path, key) -> dict:
    """ptxas's registers and spills of each kernel whose mangled name ``key``
    maps to a name (None for the others), from the build's log."""
    lines, out = report.read_text().splitlines(), {}
    for i, line in enumerate(lines):
        name = key(line) if "Compiling entry" in line else None
        if name:
            out[name] = "; ".join(x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                                  if "Used" in x or "spill" in x)
    return out


def _paged_key(mangled: str):
    m = re.search(r"paged_mma_kernelILi(\d+)E", mangled)
    return f"paged_mma_kernel<{m.group(1)}>" if m else None


def paged_sass(sass: str, report: Path) -> dict:
    """The bf16 paged kernel's machine code: the tensor cores' ``mma.sync``
    (``HMMA``) and the asynchronous copies into shared memory (``LDGSTS``,
    cp.async) at D 64 and 128, with ptxas's registers and spills of each."""
    out = {}
    for func in sass.split("Function : ")[1:]:
        key = _paged_key(func.split(None, 1)[0])
        if key:
            out[key] = {op: len(re.findall(rf"\b{op}\b", func)) for op in ("HMMA", "LDGSTS")}
    if sorted(out) != ["paged_mma_kernel<128>", "paged_mma_kernel<64>"] or \
            any(not c["HMMA"] or not c["LDGSTS"] for c in out.values()):
        raise SystemExit(f"phase 1: the bf16 paged kernels are not on mma.sync and cp.async: {out}")
    for key, ptxas in _ptxas_report(report, _paged_key).items():
        out[key]["ptxas"] = ptxas
    log(f"phase 1: paged_attention's bf16 kernels in SASS (HMMA, LDGSTS counts) and ptxas: "
        f"{json.dumps(out)}")
    return out


def _ssd_key(mangled: str):
    """``pass<dtype, strict, scalar>`` for an ssd_scan kernel's mangled name,
    or None for another kernel."""
    m = re.search(r"(ssd_chunk_state_kernel|ssd_state_pass_kernel|ssd_chunk_out_kernel)I(.*)",
                  mangled)
    if not m:
        return None
    args = m.group(2)
    dtype = "bf16" if args.startswith("13__nv_bfloat16") else (
        "f32" if args.startswith("f") else "")
    flags = ",".join(re.findall(r"Lb([01])E", args))
    return f"{m.group(1)}<{','.join(x for x in (dtype, flags) if x)}>"


def ssd_sass(sass: str, report: Path) -> dict:
    """The ssd_scan kernels' machine code: the tensor-core instruction
    (``HMMA``) in every bf16 instantiation of the chunk-state and
    chunk-output passes, and ptxas's registers and spills of each kernel."""
    out = {}
    for func in sass.split("Function : ")[1:]:
        key = _ssd_key(func.split(None, 1)[0])
        if key:
            out[key] = {"HMMA": len(re.findall(r"\bHMMA\b", func))}
    for key, ptxas in _ptxas_report(report, _ssd_key).items():
        if key in out:
            out[key]["ptxas"] = ptxas
    bf16 = [k for k in out if "<bf16" in k and "state_pass" not in k]
    if len(out) != 14 or len(bf16) != 6 or any(not out[k]["HMMA"] for k in bf16):
        raise SystemExit(f"phase 1: the ssd_scan kernels are not all built, or a bf16 one "
                         f"is not on the tensor cores: {out}")
    log(f"phase 1: ssd_scan's kernels in SASS (HMMA count) and ptxas: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# phase 20: training zamba2-1.2b at full width
# ---------------------------------------------------------------------------


def _leaf_paths(tree, prefix: str = "") -> list:
    """The "/"-joined key paths of a parameter tree, in its leaves' order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _leaf_paths(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def _loss_and_grads(model, params, batch, run):
    """``LM.loss`` of ``batch`` and its gradient for every parameter leaf."""
    wrt = [t.detach().requires_grad_() for t in tree_leaves(params)]
    it = iter(wrt)
    loss = model.loss(tree_map(lambda _: next(it), params), batch, run=run)
    return loss.detach(), torch.autograd.grad(loss, wrt)


def _train_launches(cfg, run, microbatches: int) -> dict:
    """The launches that ``microbatches`` of the loss and its backward make,
    as the code derives them: each mamba2 layer's scan (three launches a
    call) and each application of the shared block's attention (one), once
    in the forward and once more in the backward's recompute under remat;
    the backward's own recompute of the plain versions launches nothing."""
    fwd = 2 if run["remat"] else 1
    n_shared = cfg.n_layers // cfg.shared_attn_every
    return {"flash_attention": microbatches * n_shared * fwd,
            "ssd_scan": microbatches * cfg.n_layers * fwd * len(ssk.PASSES)}


def train_grad_gate(cfg, params, tokens, dev) -> dict:
    """Part 1: one microbatch of the loss on an f32 copy of the weights,
    through the kernels and with both plain versions forced; the loss
    within ``GATE_LOSS_RTOL`` and each leaf's gradient within
    ``GATE_GRAD_REL_L2`` relative L2.  Launches made to compare are not
    counted."""
    cfg32 = cfg.scaled(dtype="float32", n_layers=GATE_LAYERS)
    model = LM(cfg32, dev)
    p32 = {k: tree_map((lambda t: t[:GATE_LAYERS].float()) if k == "blocks" else
                       (lambda t: t.float()), v) for k, v in params.items()}
    mb = {k: v[:GATE_BATCH] for k, v in tokens.items()}
    run = build_run(cfg32)
    with uncounted():
        before = _launch_counts()
        (loss, grads), kernel_s = wall_s(lambda: _loss_and_grads(model, p32, mb, run))
        launched = {n: WRAPPERS[n].launches - before[n] for n in TRAIN_PATH}
        plain_run = {**run, "attn_impl": "reference", "scan_impl": "reference"}
        (want, want_g), plain_s = wall_s(lambda: _loss_and_grads(model, p32, mb, plain_run))
    if launched != _train_launches(cfg32, run, 1):
        raise SystemExit(f"phase 20: the f32 loss and backward launched {launched}, not "
                         f"{_train_launches(cfg32, run, 1)}")
    loss_rel = abs(float(loss) - float(want)) / abs(float(want))
    rels = {name: ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
            for name, a, b in zip(_leaf_paths(params), grads, want_g)}
    worst = max(rels, key=rels.get)
    out = {"batch": GATE_BATCH, "seq": TRAIN_SEQ, "layers": GATE_LAYERS,
           "loss": float(loss), "plain_loss": float(want),
           "loss_rel": loss_rel, "worst_leaf": worst, "worst_rel_l2": rels[worst],
           "rel_l2": rels, "kernel_s": kernel_s, "plain_s": plain_s, "launches": launched}
    log(f"phase 20: f32 gradient gate, {GATE_BATCH} x {TRAIN_SEQ} tokens on an f32 copy of the "
        f"first {GATE_LAYERS} of {cfg.n_layers} layers' weights: loss {float(loss):.7f} through the kernels against {float(want):.7f} with the "
        f"plain versions ({loss_rel:.3e} relative, limit {GATE_LOSS_RTOL}); the worst of "
        f"{len(rels)} leaves' gradients {worst} at {rels[worst]:.3e} relative L2 (limit "
        f"{GATE_GRAD_REL_L2}); {kernel_s:.2f} s through the kernels ({json.dumps(launched)} "
        f"launches), {plain_s:.2f} s plain")
    if not (torch.isfinite(loss) and loss_rel <= GATE_LOSS_RTOL
            and rels[worst] <= GATE_GRAD_REL_L2):
        raise SystemExit(f"phase 20: the f32 gate failed: loss {loss_rel}, {worst} {rels[worst]}")
    return out


def train_steps(cfg, params, seed: int, dev) -> dict:
    """Part 2: ``TRAIN_STEPS`` bf16 steps of ``TrainRunner``'s step function
    (``build_train_step``, accum 2) on the token stream, one of them under
    the profiler; every loss and gradient norm finite, each step's launches
    equal to the count the code derives, and step 1's batch's loss lower
    after the steps than at step 1."""
    runner = TrainRunner(cfg, ckpt_dir=None, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                         accum=TRAIN_ACCUM, seed=seed, opt_cfg=AdamWConfig(**TRAIN_OPT),
                         device=dev)
    runner.params, runner.opt_state = params, adamw_init(params)
    want = _train_launches(cfg, runner.run, TRAIN_ACCUM)
    n_tok = TRAIN_BATCH * TRAIN_SEQ
    steps, first, prof = [], None, None
    torch.cuda.reset_peak_memory_stats()
    for i in range(1, TRAIN_STEPS + 1):
        batch = runner.data.next_batch()
        if first is None:  # what the step is given: the train state and the batch
            first = batch
            arg_bytes = _tree_bytes({"params": runner.params, "opt": runner.opt_state}) + \
                sum(v.nbytes for v in batch.values())

        def one():
            runner.params, runner.opt_state, m = runner.step_fn(runner.params, runner.opt_state,
                                                                batch)
            runner.step += 1
            return m

        before = _launch_counts()
        if i == TRAIN_PROFILE_STEP:
            m, prof = profile_device(one)
            dt = prof["wall_s"]
        else:
            m, dt = wall_s(one)
        launched = {n: WRAPPERS[n].launches - before[n] for n in TRAIN_PATH}
        row = {"step": i, "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "lr": float(m["lr"]), "s": dt, "tokens_per_s": n_tok / dt,
               "profiled": i == TRAIN_PROFILE_STEP}
        steps.append(row)
        log(f"phase 20: step {i}: loss {row['loss']:.4f}, grad_norm {row['grad_norm']:.4f}, lr "
            f"{row['lr']:.3e}, {dt:.3f} s, {row['tokens_per_s']:.1f} tokens/s"
            f"{' (under the profiler)' if row['profiled'] else ''}; launches "
            f"{json.dumps(launched)}")
        if not (np.isfinite(row["loss"]) and np.isfinite(row["grad_norm"])):
            raise SystemExit(f"phase 20: step {i} gave a loss or grad norm that is not finite")
        if launched != want:
            raise SystemExit(f"phase 20: step {i} launched {launched}, not {want}")
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        again = float(runner.model.loss(
            runner.params, {k: torch.as_tensor(v, device=dev) for k, v in first.items()},
            run=runner.run))
    log(f"phase 20: step 1's batch: loss {steps[0]['loss']:.4f} at step 1, {again:.4f} after "
        f"{TRAIN_STEPS} steps; peak device memory {peak / 1e9:.2f} GB; the profiled step: "
        + json.dumps(prof))
    if not again < steps[0]["loss"]:
        raise SystemExit(f"phase 20: step 1's batch's loss did not fall ({again} after "
                         f"{TRAIN_STEPS} steps, {steps[0]['loss']} at step 1)")
    timed = [r["s"] for r in steps[1:] if not r["profiled"]]
    del runner
    return {"batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "accum": TRAIN_ACCUM, "opt": TRAIN_OPT,
            "steps": steps, "median_s": statistics.median(timed),
            "tokens_per_s": n_tok / statistics.median(timed), "first_batch_loss_after": again,
            "peak_bytes": peak, "argument_bytes": arg_bytes, "launches_per_step": want,
            "profile": prof}


def _train_state(runner) -> list:
    return tree_leaves({"params": runner.params, "opt": runner.opt_state})


def train_resume(cfg, seed: int, dev) -> dict:
    """Part 3: kill and resume, bit for bit, under deterministic
    algorithms, on the first group of the model (``RESUME_LAYERS``).  Run A
    trains ``RESUME_STEPS`` steps and saves its whole state at step
    ``RESUME_AT`` into a directory the phase deletes; run B, a fresh
    runner, restores the latest valid checkpoint (step ``RESUME_AT``) and
    trains on to ``RESUME_STEPS``.  Parameters, m, v, master, count and the
    data step must be equal."""
    cut = cfg.scaled(n_layers=RESUME_LAYERS)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=ROOT / "build")

    def runner(ckpt):
        return TrainRunner(cut, ckpt_dir=ckpt, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                           accum=TRAIN_ACCUM, seed=seed, opt_cfg=AdamWConfig(**TRAIN_OPT),
                           device=dev)

    def quiet(_msg):
        return None

    torch.use_deterministic_algorithms(True)
    try:
        a = runner(None)
        a.init_or_restore()
        a.train(RESUME_AT, log_every=1, save_every=0, log=quiet)
        a.store = CheckpointStore(tmp)
        _, save_s = wall_s(lambda: a.save(sync=True))
        a.store = None  # the phase writes one checkpoint
        a.train(RESUME_STEPS, log_every=1, save_every=0, log=quiet)
        ckpt_bytes = sum(f.stat().st_size for f in Path(tmp).rglob("*") if f.is_file())
        b = runner(tmp)
        how, restore_s = wall_s(b.init_or_restore)  # validates the sha256, then loads
        if how != "restored" or b.step != RESUME_AT or b.data.step != RESUME_AT:
            raise SystemExit(f"phase 20: run B {how} at step {b.step} (data step "
                             f"{b.data.step}), not restored at {RESUME_AT}")
        b.store = None
        b.train(RESUME_STEPS, log_every=1, save_every=0, log=quiet)
        names = _leaf_paths({"params": a.params, "opt": a.opt_state})
        differ = [n for n, x, y in zip(names, _train_state(a), _train_state(b))
                  if x.dtype != y.dtype or not torch.equal(x, y)]
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(tmp, ignore_errors=True)
    if differ or a.data.step != b.data.step:
        raise SystemExit(f"phase 20: resumed run differs from the whole run in {differ[:8]} "
                         f"(data steps {a.data.step}, {b.data.step})")
    out = {"layers": RESUME_LAYERS, "params": param_count(LM(cut, "meta").meta()),
           "checkpoint_bytes": ckpt_bytes, "save_s": save_s, "restore_s": restore_s,
           "leaves_equal": len(names), "data_step": b.data.step}
    log(f"phase 20: resume at {cut.n_layers} layers ({out['params']} parameters), deterministic "
        f"algorithms: run A trained {RESUME_STEPS} steps, saving step {RESUME_AT} "
        f"({ckpt_bytes} bytes in {save_s:.2f} s); run B restored it ({restore_s:.2f} s, sha256 "
        f"checked) and trained to step {RESUME_STEPS}: all {len(names)} leaves (params, m, v, "
        f"master, count) and the data step ({b.data.step}) equal bit for bit")
    return out


def train_backward_ms(cfg, dev) -> dict:
    """The kernels' backward (the plain versions' gradient, ``*_vjp``) at one
    microbatch's shapes, bf16, timed as in phase 4: one call of each of the
    38 scans and 6 attentions a microbatch's backward makes."""
    b = TRAIN_BATCH // TRAIN_ACCUM
    _, hds, hd, n_state = model_blocks._mamba_dims(cfg)
    gen = torch.Generator(device=dev).manual_seed(7)
    q, k = (0.3 * torch.randn(b, hds, TRAIN_SEQ, n_state, generator=gen, device=dev)
            for _ in range(2))
    v, gy = (torch.randn(b, hds, TRAIN_SEQ, hd, generator=gen, device=dev) for _ in range(2))
    w = torch.rand(b, hds, TRAIN_SEQ, 1, generator=gen, device=dev) * 0.1 + 0.9
    q, k, v, gy, w = (t.bfloat16() for t in (q, k, v, gy, w))
    h0 = torch.zeros(b, hds, n_state, hd, device=dev)
    chunk = model_blocks._pick_chunk(TRAIN_SEQ)
    out = {"ssd_scan": cuda_ms(lambda: ssd_ref.linear_scan_chunked_vjp(
        q, k, v, w, h0, gy, None, chunk=chunk), 3)}
    del q, k, v, gy, w, h0
    qa, ka, va, ga = (torch.randn(b, cfg.n_heads, TRAIN_SEQ, cfg.head_dim, generator=gen,
                                  device=dev).bfloat16() for _ in range(4))
    out["flash_attention"] = cuda_ms(lambda: flash_ref.mha_chunked_vjp(qa, ka, va, ga,
                                                                       q_offset=0), 3)
    log(f"phase 20: the kernels' backward (the plain versions' gradient) at a microbatch's "
        f"shapes, bf16: ssd_scan {out['ssd_scan']:.1f} ms a call (B {b}, H {hds}, S "
        f"{TRAIN_SEQ}, K {n_state}, V {hd}), flash_attention {out['flash_attention']:.1f} ms "
        f"(B {b}, H {cfg.n_heads}, S {TRAIN_SEQ}, D {cfg.head_dim}, causal)")
    return out


def train_path(seed: int, dev) -> dict:
    """Phase 20: the f32 gradient gate, bf16 training at full width and the
    bit-exact resume, the weights drawn on the card from ``seed``."""
    cfg = get_config(TRAIN_ARCH).scaled(n_layers=TRAIN_LAYERS)
    model = LM(cfg, dev)
    params, init_s = wall_s(lambda: model.init(torch.Generator(device=dev).manual_seed(seed)))
    log(f"phase 20: {cfg.name} at full width, {cfg.n_layers} of its "
        f"{get_config(TRAIN_ARCH).n_layers} layers ({param_count(model.meta())} parameters, "
        f"{param_bytes(model.meta()) / 1e9:.2f} GB bf16) drawn on the card in {init_s:.2f} s; "
        f"train state with f32 m, v and master {param_count(model.meta()) * 14 / 1e9:.2f} GB")
    stream = SyntheticTokenStream(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                             global_batch=TRAIN_BATCH, seed=seed))
    tokens = {k: torch.as_tensor(v, device=dev) for k, v in stream.next_batch().items()}
    out = {"arch": cfg.name, "params": param_count(model.meta())}
    t = [time.perf_counter()]
    out["f32_gate"] = train_grad_gate(cfg, params, tokens, dev)
    del tokens
    torch.cuda.empty_cache()
    t.append(time.perf_counter())
    out["train"] = train_steps(cfg, params, seed, dev)
    del params
    torch.cuda.empty_cache()
    t.append(time.perf_counter())
    out["resume"] = train_resume(cfg, seed, dev)
    torch.cuda.empty_cache()
    t.append(time.perf_counter())
    with uncounted():
        out["backward_ms"] = train_backward_ms(cfg, dev)
    t.append(time.perf_counter())
    out["seconds"] = dict(zip(("f32_gate", "train", "resume", "backward_ms"),
                              np.diff(t).tolist()))
    log(f"phase 20: seconds by part {json.dumps(out['seconds'])}")
    return out


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def start_dry_run():
    """Phase 21's counts, and phase 22's count of each rank of its dense
    run, started in worker processes on the host (spawned: the workers never
    touch the card).  Returns the pool and the pending result of
    ``dryrun.run_cell`` a cell of ``DRYRUN_CELLS``, and a rank of phase 22
    under ``("mesh", kind, rank)``."""
    pool = multiprocessing.get_context("spawn").Pool(2, initializer=torch.set_num_threads,
                                                     initargs=(1,))
    pending = {key: pool.apply_async(dryrun.run_cell, (cfg.name, shape),
                                     {"verbose": False, "cfg": cfg})
               for key, (cfg, shape) in DRYRUN_CELLS.items()}
    pending.update(mesh_dense_predictions(pool))
    return pool, pending


def dry_run_against_card(pending, summary: dict, smi: str) -> dict:
    """Phase 21: the dry run of the steps that phases 6 and 20 ran, against
    what the card measured there: its argument bytes equal to the bytes of
    the tensors the phase passed to its step, its arguments and
    temporaries within ``DRYRUN_PEAK_RTOL`` of the phase's
    ``max_memory_allocated``, and its budget within the card's memory.  Its
    ops are printed beside the phase's launches (the card runs cuBLAS and the
    kernels where the count on ``meta`` runs the plain versions), and its
    flops over the measured median time as TFLOP/s and a share of the bf16
    dense peak."""
    total = torch.cuda.get_device_properties(0).total_memory
    if dryrun.H100_BYTES > total:
        raise SystemExit(f"phase 21: the dry run's budget {dryrun.H100_BYTES} is past the "
                         f"card's {total} bytes")
    prefill, train = summary["lm"]["prefill"], summary["train"]["train"]
    measured = {
        "prefill": (prefill["argument_bytes"], prefill["peak_bytes"], prefill["median_s"],
                    prefill["profile"]["kernel_launches_per_prefill"], "phase 6"),
        "train": (train["argument_bytes"], train["peak_bytes"], train["median_s"],
                  train["profile"]["kernel_launches"], "phase 20"),
    }
    out = {"budget_bytes": dryrun.H100_BYTES, "total_memory": total}
    for key, (cfg, shape) in DRYRUN_CELLS.items():
        arch = cfg.name
        r = pending[key].get(timeout=DRYRUN_WAIT_S)
        args, peak, med, launches, phase = measured[key]
        mem = r["memory"]
        pred = mem["argument_bytes"] + mem["temp_bytes"]
        rel = (pred - peak) / peak
        tflops = r["flops"] / med / 1e12
        row = {"arch": arch, "shape": shape, "trace_s": r["trace_s"], "flops": r["flops"],
               "bytes_accessed": r["bytes_accessed"], "ops": r["exec"]["ops"],
               "launches": launches, "memory": mem, "predicted_peak_bytes": pred,
               "measured_peak_bytes": peak, "peak_rel": rel, "measured_argument_bytes": args,
               "median_s": med, "tflops": tflops, "bf16_dense_share": tflops * 1e12 /
               BF16_DENSE_FLOPS, "fits": r["fits"], "top": r["exec"]["top"]}
        if key == "train":
            row["microbatches"] = r["microbatches"]
        out[key] = row
        log(f"phase 21: {arch} {key} ({shape['global_batch']} x {shape['seq_len']}) dry run "
            f"(counted in {r['trace_s']:.1f} s on the host): argument bytes {mem['argument_bytes']}"
            f" against {args} passed in {phase}; arguments + temporaries "
            f"{pred / 1e9:.3f} GB against the measured peak {peak / 1e9:.3f} GB ({rel:+.2%}, "
            f"limit {DRYRUN_PEAK_RTOL:.0%}); {r['exec']['ops']:.0f} ops counted against "
            f"{launches:.0f} launches; {r['flops']:.4e} flops over the median {med:.4f} s: "
            f"{tflops:.1f} TFLOP/s, {row['bf16_dense_share']:.2%} of "
            f"{BF16_DENSE_FLOPS / 1e12:.0f} TFLOP/s bf16 dense ({smi})")
        if r["status"] != "ok" or r["n_devices"] != 1:
            raise SystemExit(f"phase 21: the {key} cell's dry run gave {r['status']}")
        if mem["argument_bytes"] != args:
            raise SystemExit(f"phase 21: {key} argument bytes {mem['argument_bytes']}, the "
                             f"step was given {args}")
        if abs(rel) > DRYRUN_PEAK_RTOL:
            raise SystemExit(f"phase 21: {key} predicted peak {pred} is {rel:+.2%} off the "
                             f"measured {peak}")
        if key == "train" and r["microbatches"] != TRAIN_ACCUM:
            raise SystemExit(f"phase 21: the dry run took {r['microbatches']} microbatches, "
                             f"phase 20 {TRAIN_ACCUM}")
    return out


def run_counted(path, fn):
    """Run one main path with every launch (and call) count set to 0 just
    before it; exits if a kernel of ``path`` was launched no time in it."""
    for w in WRAPPERS.values():
        w.launches = w.calls = 0
    ck.probe_place.rounds = None  # the next call makes a counter at 0
    out = fn()
    counts = {name: w.launches for name, w in WRAPPERS.items()}
    log(f"kernel launches on the path: {json.dumps(counts)}; calls: "
        f"{json.dumps({name: w.calls for name, w in WRAPPERS.items()})}")
    missing = [name for name in path if counts[name] == 0]
    if missing:
        raise SystemExit(f"the main path never launched: {missing}")
    return out


@contextlib.contextmanager
def uncounted():
    """Launches made to compare a kernel with its plain version: every
    launch count is put back as it was when the block ends."""
    saved = {name: (w.launches, w.calls) for name, w in WRAPPERS.items()}
    rounds = ck.probe_place.rounds
    saved_rounds = None if rounds is None else rounds.clone()
    try:
        yield
    finally:
        for name, w in WRAPPERS.items():
            w.launches, w.calls = saved[name]
        ck.probe_place.rounds = saved_rounds


def place_rounds() -> int:
    """Claim rounds ``probe_place`` ran since its device counter was made
    (one read of that counter)."""
    rounds = ck.probe_place.rounds
    return 0 if rounds is None else int(rounds)


def family_phases(seed: int, dev, rows: list, summary: dict, phase_s: dict) -> None:
    """Phases 16-19: the moe, vlm and audio LMs, each with every launch
    count read around it, and ``flash_attention`` timed at its shape."""
    plain_attn = {"attn_impl": "reference"}
    for phase, arch, kw, shape in (
            (16, GRANITE_ARCH, {}, {}),
            (17, MIXTRAL_ARCH, {"n_layers": MIXTRAL_LAYERS, "prefill_len": MIXTRAL_PREFILL_LEN},
             {"seq": MIXTRAL_PREFILL_LEN, "window": get_config(MIXTRAL_ARCH).window}),
            (18, VLM_ARCH, {"handoff": _xattn_decode_check, "n_layers": VLM_LAYERS},
             {"causal": False, "what": "cross"}),
            (19, AUDIO_ARCH, {"n_layers": AUDIO_LAYERS}, {})):
        t0 = time.perf_counter()
        cfg = get_config(arch).scaled(n_layers=kw.get("n_layers", get_config(arch).n_layers))
        n_attn = cfg.n_layers + (cfg.n_layers // cfg.xattn_every if cfg.xattn_every else 0)
        summary[arch] = run_counted(SERVE_PATH, lambda: lm_serve_path(
            arch, phase, seed, dev, plain_run=plain_attn,
            per_prefill={"flash_attention": n_attn}, **kw))
        summary[arch]["launches"] = _launch_counts()
        rows.append(flash_full_shape(arch, cfg, summary[arch]["launches"]["flash_attention"],
                                     dev, phase=phase, **shape))
        phase_s[str(phase)] = time.perf_counter() - t0


# ---------------------------------------------------------------------------
# phase 22: several ranks on one mesh
# ---------------------------------------------------------------------------


def _bits_equal(a, b) -> bool:
    """Bit for bit (NaNs and the sign of zero too)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                       b.contiguous().reshape(-1).view(torch.uint8))


def list_gather_staging(dev, n_bytes: int = MESH_STAGING_BYTES) -> dict:
    """The card memory that one all-gather, issued as
    ``parallel/collectives.py`` issues it (a list of views of one result
    buffer, bytes), takes above its input and result on the initialised
    world: the dry run on a description counts a staging buffer of the
    result's size, which must be what the backend allocates."""
    import torch.distributed as dist

    world = dist.get_world_size()
    src = torch.ones(n_bytes // world, dtype=torch.uint8, device=dev)
    out = torch.empty(n_bytes, dtype=torch.uint8, device=dev)
    dist.all_gather(list(out.chunk(world)), src)  # the backend's first call: set-up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dist.all_gather(list(out.chunk(world)), src)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    res = {"backend": dist.get_backend(), "world": world, "result_bytes": n_bytes,
           "staging_bytes": extra, "result_right": bool((out == 1).all())}
    if extra != n_bytes or not res["result_right"]:
        raise SystemExit(f"phase 22: a list all-gather on {res['backend']} staged {extra} bytes "
                         f"for a result of {n_bytes} (the dry run counts the result's size): "
                         f"{res}")
    return res


def mesh_one_rank(seed: int, dev, tmp: Path) -> dict:
    """(a) A world of one rank on NCCL and a (1, 1) mesh: granite-moe at full
    width and depth on phase 16's prefill (its parameters and prompt drawn
    from the seed as there).  The ``sp`` prefill (``moe_apply_shardmap``) on
    the rank's blocks gives the one-device prefill's hidden states, balancing
    loss and logits bit for bit, and two ``decode_moe_shardmap`` decode steps
    its logits; ``compressed_psum`` over the NCCL world gives the quantized
    value and residual bit for bit."""
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"file://{tmp / 'nccl_rendezvous'}", rank=0,
                            world_size=1, device_id=dev)
    try:
        backend = dist.get_backend()
        mesh = make_host_mesh((1, 1), device_type="cuda")
        cfg = get_config(MESH_ARCH)
        model = LM(cfg, dev)
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
        blocks = tree_map(lambda t, sp: local_shard(t, sp, mesh), params,
                          model.pspecs(multi_pod=False))
        rng = np.random.default_rng(seed)
        prompt = rng.integers(0, cfg.vocab, (PREFILL_BATCH, PREFILL_LEN))
        nxt = rng.integers(0, cfg.vocab, (PREFILL_BATCH, 1))
        toks = torch.as_tensor(prompt.astype(np.int32), device=dev)
        steps = [torch.as_tensor(nxt.astype(np.int32), device=dev), toks[:, :1]]
        run = {"sp": True, "mesh": mesh}
        out = {"backend": backend, "params": param_count(model.meta())}
        with torch.no_grad():
            (hid_m, aux_m, _), t_m = wall_s(lambda: model.hidden_states(blocks, toks, run=run))
            (lg_m, _, _), tl_m = wall_s(lambda: model.prefill(blocks, toks, run=run))
            with uncounted():
                hid_1, aux_1, _ = model.hidden_states(params, toks)
                lg_1, _, _ = model.prefill(params, toks)
            same = {"hidden": _bits_equal(hid_m, hid_1), "aux": _bits_equal(aux_m, aux_1),
                    "logits": _bits_equal(lg_m, lg_1)}
            del hid_m, hid_1
            cache_m, cache_1 = model.decode_init(PREFILL_BATCH, 8), model.decode_init(
                PREFILL_BATCH, 8)
            for i, t in enumerate(steps):
                dl_m, cache_m = model.decode_step(blocks, t, cache_m,
                                                  run={"decode_moe_shardmap": True, "mesh": mesh})
                with uncounted():
                    dl_1, cache_1 = model.decode_step(params, t, cache_1)
                same[f"decode_{i}"] = _bits_equal(dl_m, dl_1)
        x = {"logits": lg_m[..., :cfg.vocab].float().reshape(-1)}
        mean, resid = compressed_psum(x, ef_init(x))
        host_mean, (host_resid,) = _host_compressed_mean([x["logits"]], 1)
        same["compressed_psum"] = (
            np.array_equal(mean["logits"].cpu().numpy().view(np.uint32), host_mean.view(np.uint32))
            and np.array_equal(resid["logits"].cpu().numpy().view(np.uint32),
                               host_resid.view(np.uint32)))
        out.update(bit_equal=same, sp_prefill_s=t_m, sp_logits_s=tl_m)
        if not all(same.values()):
            raise SystemExit(f"phase 22 (a): the (1, 1) mesh differs from one device: {same}")
        del blocks, params, lg_m, lg_1, cache_m, cache_1
        torch.cuda.empty_cache()
        out["gather_staging"] = list_gather_staging(dev)
        log(f"phase 22 (a): a world of 1 rank on {backend}, a (1, 1) mesh: {cfg.name} at full "
            f"width and depth ({out['params']} parameters), the sp prefill of {PREFILL_BATCH} x "
            f"{PREFILL_LEN} through moe_apply_shardmap ({t_m:.3f} s hidden states, {tl_m:.3f} s "
            f"logits) equal to the one-device prefill bit for bit (hidden states, balancing "
            f"loss, logits), two decode_moe_shardmap steps' logits bit for bit, compressed_psum "
            f"of the logits over the world equal to numpy on the host bit for bit: "
            f"{json.dumps(same)}; a list all-gather of "
            f"{out['gather_staging']['result_bytes']} bytes staged "
            f"{out['gather_staging']['staging_bytes']} bytes on {backend} (the dry run counts a "
            f"staging buffer of the result's size)")
        return out
    finally:
        dist.destroy_process_group()


def _timed_collectives(acc: dict):
    """Every all-reduce and all-gather of ``launch.collectives`` timed on the
    host clock (waits for the other ranks included) into ``acc``."""
    def timed(fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            res = fn(*args, **kwargs)
            acc["s"] += time.perf_counter() - t0
            acc["calls"] += 1
            return res
        return wrapper

    mesh_collectives.all_reduce = timed(mesh_collectives.all_reduce)
    mesh_collectives._gather_one = timed(mesh_collectives._gather_one)


def _mesh_oracle_grads(model, cfg, whole, batch, accum: int, n_dp: int, dev) -> list:
    """The f32 gradient of the sharded step's loss on one device: for each
    microbatch, each data shard's rows run alone (their token-local MoE
    capacity), their cross-entropy sums over the microbatch's token count,
    plus 0.01 times the data-mean of their balancing losses; one backward a
    shard's rows."""
    from repro_torch.models.lm import _xent_sums

    leaves = [t.detach().requires_grad_() for t in whole]
    it = iter(leaves)
    tree = tree_map(lambda _: next(it), model.shapes())
    grads = [torch.zeros_like(t) for t in leaves]
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    per = b["tokens"].shape[0] // accum
    for i in range(accum):
        cnt = b["mask"][i * per:(i + 1) * per].sum()
        for d in range(n_dp):
            r = slice(i * per + d * per // n_dp, i * per + (d + 1) * per // n_dp)
            with torch.enable_grad():
                hid, aux, _ = model.hidden_states(tree, b["tokens"][r])
                tot, _ = _xent_sums(tree["embed"], cfg, hid, b["targets"][r], b["mask"][r],
                                    chunk=512)
                term = (tot / cnt + 0.01 * aux / n_dp) / accum
                for acc, g in zip(grads, torch.autograd.grad(term, leaves, allow_unused=True)):
                    if g is not None:
                        acc.add_(g)
    return grads


def _host_compressed_mean(parts, n: int):
    """``compressed_psum``'s mean and each member's residual, in numpy on the
    host, from every member's gradient (zero residuals in)."""
    xs = [p.cpu().numpy().astype(np.float32) for p in parts]
    amax = np.float32(max(float(np.abs(x).max()) for x in xs))
    scale = np.maximum(amax, np.float32(1e-12)) / np.float32(127.0)
    qs = [np.clip(np.rint(x / scale), -127, 127).astype(np.int8) for x in xs]
    total = np.sum([q.astype(np.int32) for q in qs], axis=0, dtype=np.int32)
    mean = (total.astype(np.float32) * scale) / np.float32(n)
    return mean, [x - q.astype(np.float32) * scale for x, q in zip(xs, qs)]


def _mesh_params_gate(blocks, whole, spec_leaves, mesh, rank: int, paths) -> dict:
    """(b)'s parameters after the train steps (``blocks``, the rank's),
    each leaf gathered whole in turn, against rank 0's one-device AdamW
    (``whole``) stepped with the same gathered gradients, by
    tests/test_torch_tp.py's rule: ``MESH_PARAMS_REL_L2`` relative L2 a
    leaf, ``MESH_PARAMS_SMALL`` absolute where the one-device leaf's norm
    is below 1e-3 (no granite leaf starts at zero, that rule's exception).
    Rank 0 raises where a leaf misses it."""
    rec = {"rel_l2_worst": 0.0, "rel_l2_worst_leaf": None, "misses": []}
    for i, (blk, sp) in enumerate(zip(tree_leaves(blocks), spec_leaves)):
        got = mesh_collectives.whole(blk, mesh, sp)
        if rank == 0:
            g, w = got.double(), tree_leaves(whole)[i].double()
            small = bool(w.norm() < 1e-3)
            err = float((g - w).abs().max()) if small else _rel_l2(g, w)
            if err > (MESH_PARAMS_SMALL if small else MESH_PARAMS_REL_L2):
                rec["misses"].append((paths[i], err))
            if not small and err >= rec["rel_l2_worst"]:
                rec.update(rel_l2_worst=err, rel_l2_worst_leaf=paths[i])
        del got
    if rec["misses"]:
        raise RuntimeError(f"phase 22 (b): the parameters after the f32 train step(s) against "
                           f"a one-device AdamW on the same gradients: {rec} (limit "
                           f"{MESH_PARAMS_REL_L2} relative L2 a leaf, {MESH_PARAMS_SMALL} "
                           f"absolute below a norm of 1e-3)")
    return rec if rank == 0 else {}


def _one_rank_at_a_time(rank: int, world: int, fn):
    """``fn()`` on each rank in turn, the others waiting at a barrier: one
    whole f32 model on the shared card at a time."""
    import torch.distributed as dist

    out = None
    for r in range(world):
        if r == rank:
            out = fn()
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def _step_memory(fn, argument_bytes: int):
    """(``fn()``, its seconds, its arguments' bytes plus the card memory
    allocated at its peak above what was allocated before it): the
    measured counterpart of the dry run's arguments plus temporaries."""
    sync()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, sec = wall_s(fn)
    return out, sec, torch.cuda.max_memory_allocated() - before + argument_bytes


def _dense_batch(cfg, seed: int, dev) -> dict:
    """(b)'s dense run's global batch: tokens and targets from the seed,
    the mask holding zeros."""
    rng = np.random.default_rng(seed + 22)
    shape = (MESH_DENSE_BATCH, PREFILL_LEN)
    mask = np.ones(shape, np.float32)
    mask[0, :PREFILL_LEN // 8] = 0.0
    return {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, shape).astype(np.int32),
                                      device=dev),
            "targets": torch.as_tensor(rng.integers(0, cfg.vocab, shape).astype(np.int32),
                                       device=dev),
            "mask": torch.as_tensor(mask, device=dev)}


def _mesh_dense(rank: int, world: int, mesh, seed: int, dev) -> dict:
    """(b)'s dense run in the sequence-parallel layout (see the module
    docstring); every gate raises on the rank that misses it."""
    mesh14 = make_host_mesh(MESH_SEQ_SHAPE, device_type="cuda")
    cfg = get_config(MESH_DENSE_ARCH).scaled(n_layers=MESH_DENSE_LAYERS)
    cfg32 = cfg.scaled(dtype="float32")
    specs = LM(cfg, "meta").pspecs(multi_pod=False)
    params = LM(cfg, dev).init(torch.Generator(device=dev).manual_seed(seed))
    batch = _dense_batch(cfg, seed, dev)
    at_offset = fak.flash_attention.launches_at_offset
    out = {"prefill": {}}
    t0 = time.perf_counter()
    for name, m in (("2x2", mesh), ("1x4", mesh14)):
        n_dp = dict(zip(m.mesh_dim_names, m.shape))["data"]
        per = MESH_DENSE_BATCH // n_dp
        rows = slice(m.get_local_rank("data") * per, (m.get_local_rank("data") + 1) * per)
        mine = {"tokens": batch["tokens"][rows]}
        for dtype in ("bfloat16",) if name == "2x2" else ("float32",):
            c = cfg if dtype == "bfloat16" else cfg32
            blocks = tree_map(lambda t, sp: local_shard(t if dtype == "bfloat16" else t.float(),
                                                        sp, m), params, specs)
            args = _tree_bytes(blocks) + mine["tokens"].numel() * 4
            step, _, _ = build_prefill_step(c, device=dev, mesh=m)
            lg, sec, peak = _step_memory(lambda: step(blocks, mine), args)

            def oracle(c=c):
                with uncounted(), torch.no_grad():
                    p = params if dtype == "bfloat16" else tree_map(lambda t: t.float(), params)
                    return build_prefill_step(c, device=dev)[0](p, mine)

            want = oracle() if dtype == "bfloat16" else _one_rank_at_a_time(rank, world,
                                                                             oracle)
            rel, top1 = _logits_distance(f"phase 22 (b) {cfg.name} {dtype} prefill on {name}",
                                         lg, want, cfg.vocab)
            rec = {"rel_l2": rel, "top1": top1, "s": sec, "peak_bytes": peak,
                   "argument_bytes": args}
            if name == "2x2" and dtype == "bfloat16":
                # the gathered-whole layout beside it: every dense weight
                # gathered whole for the step
                step_w, _, _ = build_prefill_step(c, device=dev, mesh=m,
                                                  run_overrides={"sp": False})
                lg_w, sec_w, peak_w = _step_memory(lambda: step_w(blocks, mine), args)
                rec.update(whole_peak_bytes=peak_w, whole_s=sec_w,
                           whole_rel_l2=_logits_distance("phase 22 (b) gathered whole", lg_w,
                                                         want, cfg.vocab)[0])
            out["prefill"][f"{name}|{dtype}"] = rec
            limit = MESH_F32_REL_L2 if dtype == "float32" else MESH_DENSE_BF16_REL_L2
            if rel > limit or rec.get("whole_rel_l2", 0.0) > limit:
                raise RuntimeError(f"phase 22 (b) rank {rank}: {cfg.name}'s {dtype} prefill "
                                   f"on {name} against one device: {rec} (limit {limit})")
            del blocks, lg, want
    _release_host("the dense prefills", rank)
    # the f32 loss and every gradient leaf on (2, 2), against one device
    n_dp = MESH_SHAPE[0]
    per = MESH_DENSE_BATCH // n_dp
    d = mesh.get_local_rank("data")
    mine = {k: v[d * per:(d + 1) * per] for k, v in batch.items()}
    blocks = tree_map(lambda t, sp: local_shard(t.float(), sp, mesh), params, specs)
    args = _tree_bytes(blocks) + _tree_bytes(mine)
    run = build_run(cfg32, mesh=mesh)
    leaves = [t.detach().requires_grad_() for t in tree_leaves(blocks)]

    def loss_grads():
        it = iter(leaves)
        with torch.enable_grad():
            loss = LM(cfg32, dev).loss(tree_map(lambda _: next(it), blocks), mine, run=run)
            return loss.detach(), torch.autograd.grad(loss, leaves)

    (loss, grads), sec, peak = _step_memory(loss_grads, args)
    del leaves

    def oracle():
        with uncounted():
            p = tree_map(lambda t: t.float(), params)
            want_loss, want = _loss_and_grads(LM(cfg32, dev), p, batch, {})
            del p
            errs = [_rel_l2(g, local_shard(w, sp, mesh)) if w.norm() > 0 else
                    float(g.norm()) for g, w, sp in zip(grads, want, tree_leaves(specs))]
            return float(want_loss), errs

    want_loss, errs = _one_rank_at_a_time(rank, world, oracle)
    worst = int(np.argmax(errs))
    out["train"] = {"loss": float(loss), "one_device_loss": want_loss,
                    "loss_rel": abs(float(loss) - want_loss) / abs(want_loss),
                    "grad_rel_l2_worst": errs[worst],
                    "grad_rel_l2_worst_leaf": _leaf_paths(specs)[worst],
                    "s": sec, "peak_bytes": peak, "argument_bytes": args}
    if out["train"]["loss_rel"] > GATE_LOSS_RTOL or errs[worst] > GATE_GRAD_REL_L2:
        raise RuntimeError(f"phase 22 (b) rank {rank}: {cfg.name}'s f32 loss and gradients "
                           f"on {MESH_SHAPE} against one device: {out['train']} (limits "
                           f"{GATE_LOSS_RTOL}, {GATE_GRAD_REL_L2})")
    out["launches_at_offset"] = fak.flash_attention.launches_at_offset - at_offset
    out["seconds"] = time.perf_counter() - t0
    del blocks, grads
    torch.cuda.empty_cache()
    out["host"] = _release_host("the dense run", rank)
    out["decode"] = _mesh_decode(rank, world, mesh, seed, dev, params)
    return out


def _host_memory() -> dict:
    """This process's peak resident host memory (``ru_maxrss``; pinned pages
    included) and the machine's available memory (MemAvailable), in GB."""
    with open("/proc/meminfo") as f:
        avail = next(int(line.split()[1]) for line in f if line.startswith("MemAvailable:"))
    return {"rss_peak_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9,
            "available_gb": avail * 1024 / 1e9}


def _release_host(what: str, rank=None) -> dict:
    """Returns the pinned blocks the allocator caches (each gloo collective
    of a card's tensor stages it in pinned host memory, in blocks rounded up
    to a power of two, which the allocator keeps), and logs
    :func:`_host_memory` after ``what``."""
    torch._C._host_emptyCache()
    mem = _host_memory()
    who = "" if rank is None else f" rank {rank}"
    log(f"phase 22{who}: host memory after {what} (GB): "
        f"{json.dumps({k: round(v, 3) for k, v in mem.items()})}")
    return mem


def _random_cache(model, batch: int, seed: int, dev):
    """A decode cache of ``batch`` rows at ``len`` ``MESH_DECODE_LEN`` of T
    ``MESH_DECODE_T``, its K/V rings and recurrent states drawn in f32 from
    the seed on the card (alike on every rank, and in either dtype)."""
    cache = model.decode_init(batch, MESH_DECODE_T)
    gen = torch.Generator(device=dev).manual_seed(seed + 26)
    for name in ("kv", "shared_kv", "states"):
        for leaf in tree_leaves(cache.get(name, {})):
            leaf.copy_(torch.randn(leaf.shape, generator=gen, device=dev))
    cache["len"].fill_(MESH_DECODE_LEN)
    return cache


def _cache_rows(cache, rows):
    """The one-device cache of ``rows`` of a whole cache (copies)."""
    return {k: v if k == "len" else tree_map(lambda t: t[:, rows].clone(), v)
            for k, v in cache.items()}


def _greedy_differences(got, want, vocab: int) -> list:
    """The one-device top-2 margin of each row whose greedy token differs."""
    g, w = got[..., :vocab].float(), want[..., :vocab].float()
    top2 = w.topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1])[g.argmax(-1) != w.argmax(-1)].tolist()


def _decode_on_mesh(rank: int, world: int, mesh, cfg, params, seed: int, dev, *,
                    limit: float, whole_beside: bool) -> dict:
    """``MESH_DECODE_STEPS`` decode steps of ``cfg`` on ``mesh`` in the
    striped-cache layout (every rank its blocks of ``params``, whole on each
    rank, and of a random cache), against one device's decode of the rank's
    rows from the same cache (on one rank at a time in f32), its greedy
    tokens fed to both: the logits within ``limit`` relative L2 each step,
    every model rank's logits bit for bit, in f32 the greedy tokens equal
    but at a near tie (``MESH_DECODE_TIE``), and the rank's cache blocks
    after the steps within ``limit`` of the one-device cache's.  The first
    step's card memory is measured (arguments plus the peak above what was
    allocated); with ``whole_beside``, beside the same step with every
    weight gathered whole and the rank's rows of the cache T whole.  Every
    gate raises on the rank that misses it."""
    specs = LM(cfg, "meta").pspecs(multi_pod=False)
    n_dp = dict(zip(mesh.mesh_dim_names, mesh.shape))["data"]
    per = MESH_DENSE_BATCH // n_dp
    rows = slice(mesh.get_local_rank("data") * per, (mesh.get_local_rank("data") + 1) * per)
    rng = np.random.default_rng(seed + 26)
    first = torch.as_tensor(rng.integers(0, cfg.vocab, (MESH_DENSE_BATCH, 1)).astype(np.int32),
                            device=dev)[rows]
    model = LM(cfg, dev)
    whole = _random_cache(model, MESH_DENSE_BATCH, seed, dev)
    cspecs = cache_pspecs(cfg, whole, MESH_DENSE_BATCH, mesh)
    cache = tree_map(lambda t, sp: local_shard(t, sp, mesh), whole, cspecs)
    cache["ring"] = ring_record(whole, dev)
    mine = _cache_rows(whole, rows)
    del whole
    f32 = cfg.dtype == "float32"
    # an f32 copy of bf16 parameters, whose norms and biases are f32 already
    cast = (lambda t: t.float()) if f32 else (lambda t: t)

    def oracle():
        with uncounted(), torch.no_grad():
            p = tree_map(cast, params)
            one = build_decode_step(cfg, device=dev)[0]
            oc = tree_map(lambda t: t.clone(), mine)
            tok, logits, toks = first, [], []
            for _ in range(MESH_DECODE_STEPS):
                toks.append(tok)
                lg, oc = one(p, tok, oc)
                logits.append(lg)
                tok = lg[..., :cfg.vocab].argmax(-1).to(torch.int32)
            return logits, toks, oc

    want, toks, want_cache = _one_rank_at_a_time(rank, world, oracle) if f32 else oracle()
    blocks = tree_map(lambda t, sp: local_shard(cast(t), sp, mesh), params, specs)
    step = build_decode_step(cfg, device=dev, mesh=mesh)[0]
    args = _tree_bytes(blocks) + _tree_bytes(cache) + first.numel() * first.element_size()
    rec = {"rel_l2": [], "s": [], "greedy_margins_differing": [], "model_ranks_identical": True,
           "argument_bytes": args}
    for s, tok in enumerate(toks):
        if s == 0:
            (lg, cache), sec, rec["peak_bytes"] = _step_memory(
                lambda: step(blocks, tok, cache), args)
        else:
            (lg, cache), sec = wall_s(lambda: step(blocks, tok, cache))
        rec["s"].append(sec)
        rec["rel_l2"].append(_logits_distance(f"phase 22 (b) {cfg.name} decode step {s + 1}", lg,
                                              want[s], cfg.vocab)[0])
        every = mesh_collectives.all_gather(lg[None].contiguous(), mesh, "model", 0)
        rec["model_ranks_identical"] &= all(_bits_equal(x, every[0]) for x in every)
        if f32:
            rec["greedy_margins_differing"] += _greedy_differences(lg, want[s], cfg.vocab)
    # the rank's cache blocks after the steps against the one-device cache's
    # (its rows alone: the data axis of one rank)
    stripes = MeshDescription((1, mesh.shape[1]), ("data", "model"))
    coord = {"data": 0, "model": mesh.get_local_rank("model")}
    rec["cache_rel_l2"] = max(
        _rel_l2(got.float(), local_shard(w, sp, stripes, coord).float())
        for got, w, sp in zip(tree_leaves({k: v for k, v in cache.items() if k != "ring"}),
                              tree_leaves(want_cache),
                              tree_leaves(cache_pspecs(cfg, want_cache, per, stripes)))
        if w.dim())
    if whole_beside:
        one = build_decode_step(cfg, device=dev)[0]
        oc = tree_map(lambda t: t.clone(), mine)
        args_w = _tree_bytes(blocks) + _tree_bytes(oc) + first.numel() * first.element_size()
        with torch.no_grad():
            _, rec["whole_s"], rec["whole_peak_bytes"] = _step_memory(
                lambda: one(model._gathered(blocks, mesh), toks[0], oc), args_w)
        del oc
    del blocks, cache, mine, want, want_cache
    torch.cuda.empty_cache()
    _release_host(f"{cfg.name}'s {cfg.dtype} decode", rank)
    if (max(rec["rel_l2"]) > limit or rec["cache_rel_l2"] > limit
            or not rec["model_ranks_identical"]
            or any(m >= MESH_DECODE_TIE for m in rec["greedy_margins_differing"])):
        raise RuntimeError(f"phase 22 (b) rank {rank}: {cfg.name}'s {cfg.dtype} decode on "
                           f"{tuple(mesh.shape)} against one device: {rec} (limit {limit}; a "
                           f"greedy token may differ only below a margin of {MESH_DECODE_TIE})")
    return rec


def _mesh_decode(rank: int, world: int, mesh, seed: int, dev, dense_params) -> dict:
    """(b)'s decode runs: qwen2-7b (``dense_params``, the dense run's bf16
    parameters) in bf16 and in f32, then zamba2-1.2b's first group in f32."""
    t0 = time.perf_counter()
    cfg = get_config(MESH_DENSE_ARCH).scaled(n_layers=MESH_DENSE_LAYERS)
    out = {"bfloat16": _decode_on_mesh(rank, world, mesh, cfg, dense_params, seed, dev,
                                       limit=MESH_DENSE_BF16_REL_L2, whole_beside=True),
           "float32": _decode_on_mesh(rank, world, mesh, cfg.scaled(dtype="float32"),
                                      dense_params, seed, dev, limit=MESH_DECODE_F32_REL_L2,
                                      whole_beside=False)}
    out["dense_s"] = time.perf_counter() - t0
    hyb = get_config(HYBRID_ARCH).scaled(n_layers=MESH_HYBRID_LAYERS, dtype="float32")
    params = LM(hyb, dev).init(torch.Generator(device=dev).manual_seed(seed))
    out["hybrid"] = _decode_on_mesh(rank, world, mesh, hyb, params, seed, dev,
                                    limit=MESH_DECODE_F32_REL_L2, whole_beside=False)
    del params
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def _recurrent_batch(cfg, seed: int, dev) -> dict:
    """(b)'s recurrent runs' global batch: tokens and targets from the seed,
    the mask holding zeros."""
    rng = np.random.default_rng(seed + 28)
    shape = (MESH_RECURRENT_BATCH, PREFILL_LEN)
    mask = np.ones(shape, np.float32)
    mask[0, :PREFILL_LEN // 8] = 0.0
    return {k: torch.as_tensor(v, device=dev) for k, v in (
        ("tokens", rng.integers(0, cfg.vocab, shape).astype(np.int32)),
        ("targets", rng.integers(0, cfg.vocab, shape).astype(np.int32)), ("mask", mask))}


def _recurrent_on_mesh(rank: int, world: int, mesh, cfg, seed: int, dev) -> dict:
    """``cfg`` (f32) on ``mesh`` in the d-sharded layout, every rank its
    blocks of parameters drawn from the seed: the prefill of the rank's rows
    against one device's (logits within ``MESH_F32_REL_L2``; the rank's
    first and last scan through the kernel at its head count held to the
    plain scan on their own inputs), its card memory beside the same
    prefill with ``sp`` off (every dense weight gathered whole); the loss
    on the global batch (within ``GATE_LOSS_RTOL``) and every gradient leaf
    (within ``GATE_GRAD_REL_L2``), against one device run on one rank at a
    time.  Every gate raises on the rank that misses it."""
    model = LM(cfg, dev)
    specs = model.pspecs(multi_pod=False)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    batch = _recurrent_batch(cfg, seed, dev)
    n_dp = dict(zip(mesh.mesh_dim_names, mesh.shape))["data"]
    per = MESH_RECURRENT_BATCH // n_dp
    d = mesh.get_local_rank("data")
    mine = {k: v[d * per:(d + 1) * per] for k, v in batch.items()}
    blocks = tree_map(lambda t, sp: local_shard(t, sp, mesh), params, specs)
    args = _tree_bytes(blocks) + mine["tokens"].numel() * 4
    out = {"mesh": tuple(mesh.shape)}
    t0 = time.perf_counter()
    step, _, run = build_prefill_step(cfg, device=dev, mesh=mesh)
    if model.layout(run) != "d-sharded":
        raise RuntimeError(f"phase 22 (b): {cfg.name} on a mesh ran {model.layout(run)}")
    # the scans' inputs kept on the host, out of the measured peak
    with _scan_inputs_of((0, cfg.n_layers - 1), to="cpu") as kept:
        lg, sec, peak = _step_memory(lambda: step(blocks, {"tokens": mine["tokens"]}), args)
    scans = _layer_scan_gate({i: (tuple(t.to(dev) for t in a),
                                  {**kw, "h0": None if kw["h0"] is None else kw["h0"].to(dev)})
                              for i, (a, kw) in kept.items()})
    del kept

    def oracle():
        with uncounted(), torch.no_grad():
            return build_prefill_step(cfg, device=dev)[0](params, {"tokens": mine["tokens"]})

    want = _one_rank_at_a_time(rank, world, oracle)
    rel, top1 = _logits_distance(f"phase 22 (b) {cfg.name} d-sharded prefill", lg, want,
                                 cfg.vocab)
    step_w, _, run_w = build_prefill_step(cfg, device=dev, mesh=mesh, run_overrides={"sp": False})
    lg_w, sec_w, peak_w = _step_memory(lambda: step_w(blocks, {"tokens": mine["tokens"]}), args)
    out["prefill"] = {"rel_l2": rel, "top1": top1, "s": sec, "peak_bytes": peak,
                      "argument_bytes": args, "whole_peak_bytes": peak_w, "whole_s": sec_w,
                      "whole_layout": model.layout(run_w),
                      "whole_rel_l2": _logits_distance("phase 22 (b) gathered whole", lg_w, want,
                                                       cfg.vocab)[0],
                      "scans": scans}
    del lg, lg_w, want
    if rel > MESH_F32_REL_L2 or out["prefill"]["whole_rel_l2"] > MESH_F32_REL_L2:
        raise RuntimeError(f"phase 22 (b) rank {rank}: {cfg.name}'s f32 d-sharded prefill on "
                           f"{tuple(mesh.shape)} against one device: {out['prefill']} (limit "
                           f"{MESH_F32_REL_L2})")
    _release_host(f"{cfg.name}'s prefill", rank)
    # the loss (and its gradients) on the global batch, against one device
    run = build_run(cfg, mesh=mesh)
    leaves = [t.detach().requires_grad_() for t in tree_leaves(blocks)]

    def loss_grads():
        it = iter(leaves)
        with torch.enable_grad():
            loss = model.loss(tree_map(lambda _: next(it), blocks), mine, run=run)
            return loss.detach(), torch.autograd.grad(loss, leaves)

    (loss, g), sec, peak = _step_memory(loss_grads, _tree_bytes(blocks) + _tree_bytes(mine))
    del leaves

    def oracle_loss():
        with uncounted(), torch.enable_grad():
            want_loss, want = _loss_and_grads(model, params, batch, {})
            errs = [_rel_l2(x, local_shard(w, sp, mesh)) if w.norm() > 0 else float(x.norm())
                    for x, w, sp in zip(g, want, tree_leaves(specs))]
            return float(want_loss), errs

    want_loss, errs = _one_rank_at_a_time(rank, world, oracle_loss)
    rec = {"loss": float(loss), "one_device_loss": want_loss,
           "loss_rel": abs(float(loss) - want_loss) / abs(want_loss), "s": sec,
           "peak_bytes": peak}
    worst = int(np.argmax(errs))
    rec.update(grad_rel_l2_worst=errs[worst], grad_rel_l2_worst_leaf=_leaf_paths(specs)[worst])
    out["loss"] = rec
    out["seconds"] = time.perf_counter() - t0
    del blocks, params, g
    torch.cuda.empty_cache()
    _release_host(f"{cfg.name}'s loss", rank)
    if rec["loss_rel"] > GATE_LOSS_RTOL or rec["grad_rel_l2_worst"] > GATE_GRAD_REL_L2:
        raise RuntimeError(f"phase 22 (b) rank {rank}: {cfg.name}'s f32 d-sharded loss on "
                           f"{tuple(mesh.shape)} against one device: {rec} (limits "
                           f"{GATE_LOSS_RTOL}, {GATE_GRAD_REL_L2})")
    return out


def _mesh_recurrent(rank: int, world: int, mesh, seed: int, dev) -> dict:
    """(b)'s recurrent runs in the d-sharded layout: zamba2-1.2b's first
    group on (2, 2), then rwkv6-3b at ``MESH_SSM_LAYERS`` layers on (1, 4),
    each its prefill, loss and gradients."""
    t0 = time.perf_counter()
    hyb = get_config(HYBRID_ARCH).scaled(n_layers=MESH_HYBRID_LAYERS, dtype="float32")
    out = {"hybrid": _recurrent_on_mesh(rank, world, mesh, hyb, seed, dev)}
    ssm = get_config(SSM_ARCH).scaled(n_layers=MESH_SSM_LAYERS, dtype="float32")
    mesh14 = make_host_mesh(MESH_SEQ_SHAPE, device_type="cuda")
    out["ssm"] = _recurrent_on_mesh(rank, world, mesh14, ssm, seed, dev)
    out["seconds"] = time.perf_counter() - t0
    out["host"] = _release_host("the recurrent runs", rank)
    return out


def _mesh_rank(rank: int, world: int, rdv: str, out_dir: str, seed: int) -> None:
    """(b): one rank of the gloo world sharing the card; writes its results
    to ``out_dir/rank<r>.pt``."""
    import datetime

    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products stay f32
    torch.backends.cudnn.allow_tf32 = False
    _build.library()  # built by the parent: loaded
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    coll = {"s": 0.0, "calls": 0}
    _timed_collectives(coll)
    out = {"rank": rank, "backend": dist.get_backend(), "seconds": {}}
    t_rank = time.perf_counter()
    try:
        mesh = make_host_mesh(MESH_SHAPE, device_type="cuda")
        n_dp, d = MESH_SHAPE[0], mesh.get_local_rank("data")
        out["coordinate"] = tuple(mesh.get_coordinate())
        for w in WRAPPERS.values():
            w.launches = w.calls = 0
        cfg = get_config(MESH_ARCH).scaled(n_layers=MESH_LAYERS)
        model = LM(cfg, dev)
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
        specs = model.pspecs(multi_pod=False)
        spec_leaves = tree_leaves(specs)
        blocks = tree_map(lambda t, sp: local_shard(t, sp, mesh), params, specs)
        rng = np.random.default_rng(seed)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (MESH_BATCH, PREFILL_LEN))
                               .astype(np.int32), device=dev)
        per = MESH_BATCH // n_dp
        mine = {"tokens": toks[d * per:(d + 1) * per]}

        # the prefill per data shard against one device, bf16 then f32
        t0 = time.perf_counter()
        gates = {}
        for dtype in ("bfloat16", "float32"):
            c = cfg.scaled(dtype=dtype)
            p = params if dtype == "bfloat16" else tree_map(lambda t: t.float(), params)
            b = blocks if dtype == "bfloat16" else tree_map(lambda t: t.float(), blocks)
            sharded, _, _ = build_prefill_step(c, device=dev, mesh=mesh)
            one, _, _ = build_prefill_step(c, device=dev)
            with _moe_dispatches(range(MESH_LAYERS)) as (kept_m, _):
                lg_m, t_m = wall_s(lambda: sharded(b, mine))
            with uncounted(), _moe_dispatches(range(MESH_LAYERS)) as (kept_1, _):
                lg_1, t_1 = wall_s(lambda: one(p, mine))
            a, w = lg_m[..., :cfg.vocab].float(), lg_1[..., :cfg.vocab].float()
            if not (torch.isfinite(a).all() and torch.isfinite(w).all()):
                raise RuntimeError(f"phase 22 (b): {dtype} prefill logits are not finite")
            slots = [int(sum((x != y).sum() for x, y in zip(kept_m[i][0][2:], kept_1[i][0][2:])))
                     + int(kept_m[i][1] != kept_1[i][1]) for i in range(MESH_LAYERS)]
            ties = _near_tie_differences(kept_m[0], kept_1[0], cfg.moe.top_k)
            gates[dtype] = {"rel_l2": _rel_l2(a, w), "sharded_s": t_m, "one_device_s": t_1,
                            "dispatch_differences_by_layer": slots, "layer0_ties": ties,
                            "dispatch_against_twin": _dispatch_gate(kept_m, cfg.moe.top_k)}
            limit = MESH_F32_REL_L2 if dtype == "float32" else MESH_BF16_REL_L2
            if gates[dtype]["rel_l2"] > limit or not ties["ok"]:
                raise RuntimeError(f"phase 22 (b) rank {rank}: the {dtype} prefill of the data "
                                   f"shard's rows against one device: {gates[dtype]} (limit "
                                   f"{limit}; layer 0's top-k may differ only at a near tie "
                                   f"within {MESH_ROUTER_TIE})")
            del lg_m, lg_1, kept_m, kept_1, p, b
        out["prefill"] = gates
        out["seconds"]["prefill"] = time.perf_counter() - t0
        out.setdefault("host", {})["prefill"] = _release_host("prefill", rank)

        # the f32 train steps; each step's gradients against one device
        t0 = time.perf_counter()
        cfg32 = cfg.scaled(dtype="float32")
        model32 = LM(cfg32, dev)
        p = tree_map(lambda t: t.float(), blocks)
        # rank 0's one-device state: the whole f32 parameters, updated by a
        # one-device AdamW with the gathered gradients (no gather of them)
        whole_p = tree_map(lambda t: t.float(), params) if rank == 0 else None
        whole_opt = adamw_init(whole_p) if rank == 0 else None
        del blocks, params
        opt = adamw_init(p)
        step, _, _ = build_train_step(cfg32, accum=MESH_ACCUM, opt_cfg=AdamWConfig(**TRAIN_OPT),
                                      device=dev, mesh=mesh)
        dcfg = DataConfig(vocab=cfg.vocab, seq_len=PREFILL_LEN, global_batch=MESH_BATCH, seed=seed)
        stream = SyntheticTokenStream(dcfg, rows=data_rows(MESH_BATCH, MESH_ACCUM, n_dp, d))
        whole_stream = SyntheticTokenStream(dcfg)
        steps_out = []
        for s in range(MESH_TRAIN_STEPS):
            batch = stream.next_batch()
            whole_batch = whole_stream.next_batch()
            rows = len(stream.rows) // MESH_ACCUM

            def run_step():
                gsum, loss = step.begin(p), 0.0
                for i in range(MESH_ACCUM):
                    mb = {k: torch.as_tensor(v[i * rows:(i + 1) * rows], device=dev)
                          for k, v in batch.items()}
                    loss = loss + step.microbatch(p, mb, gsum)
                return gsum, step.finish(p, opt, gsum, loss)

            coll0 = dict(coll)
            if s == MESH_TRAIN_STEPS - 1:
                (gsum, (p_new, opt, m)), prof = profile_device(run_step)
            else:
                (gsum, (p_new, opt, m)), step_s = wall_s(run_step)
                prof = {"wall_s": step_s}
            rec = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                   "collective_s": coll["s"] - coll0["s"],
                   "collective_calls": coll["calls"] - coll0["calls"], **prof}
            # the gate (the gather and the oracle outside the step's clock)
            whole_g = [mesh_collectives.whole(g, mesh, sp) for g, sp in zip(gsum, spec_leaves)]
            if rank == 0:
                with uncounted():
                    want = _mesh_oracle_grads(model32, cfg32, tree_leaves(whole_p), whole_batch,
                                              MESH_ACCUM, n_dp, dev)
                errs = [_rel_l2(g, w) if w.norm() > 0 else float(g.norm())
                        for g, w in zip(whole_g, want)]
                worst = int(np.argmax(errs))
                rec["grad_rel_l2_worst"] = errs[worst]
                rec["grad_rel_l2_worst_leaf"] = _leaf_paths(specs)[worst]
                if errs[worst] > GATE_GRAD_REL_L2 or not np.isfinite(rec["loss"]):
                    raise RuntimeError(f"phase 22 (b): step {s + 1}'s f32 gradient leaf "
                                       f"{rec['grad_rel_l2_worst_leaf']} within "
                                       f"{errs[worst]:.3e} of one device (limit "
                                       f"{GATE_GRAD_REL_L2}); loss {rec['loss']}")
                del want
                it = iter(whole_g)
                whole_p, whole_opt, _ = adamw_update(
                    AdamWConfig(**TRAIN_OPT), whole_p, tree_map(lambda _: next(it), whole_p),
                    whole_opt)
            del whole_g
            steps_out.append(rec)
            p = p_new
        out["train"] = steps_out
        out["train_params"] = _mesh_params_gate(p, whole_p, spec_leaves, mesh, rank,
                                                _leaf_paths(specs))
        out["seconds"]["train"] = time.perf_counter() - t0
        out.setdefault("host", {})["train"] = _release_host("train", rank)

        # the last step's compressed_psum over the world, against the host
        t0 = time.perf_counter()
        by_path = dict(zip(_leaf_paths(specs), gsum))
        sel = {name.replace("/", "."): by_path[name] for name in MESH_COMPRESS_LEAVES}
        mean, resid = compressed_psum(sel, ef_init(sel))
        comp = {}
        for name, g in sel.items():
            parts = [torch.empty_like(g) for _ in range(world)]
            dist.all_gather(parts, g.contiguous())
            means = [torch.empty_like(mean[name]) for _ in range(world)]
            dist.all_gather(means, mean[name].contiguous())
            alike = all(_bits_equal(x, means[0]) for x in means)
            host_mean, host_resid = _host_compressed_mean(parts, world)
            host = (np.array_equal(mean[name].cpu().numpy().view(np.uint32),
                                   host_mean.view(np.uint32))
                    and np.array_equal(resid[name].cpu().numpy().view(np.uint32),
                                       host_resid[rank].view(np.uint32)))
            comp[name] = {"elements": g.numel(), "alike_on_every_rank": alike,
                          "equal_to_host": host}
            if not (alike and host):
                raise RuntimeError(f"phase 22 (b) rank {rank}: compressed_psum of {name}: {comp}")
        out["compressed_psum"] = comp
        out["seconds"]["compressed_psum"] = time.perf_counter() - t0
        out.setdefault("host", {})["compressed_psum"] = _release_host("compressed psum", rank)

        # the parameters and the optimizer state saved on (2, 2), restored on
        # (4, 1) and on one device; each leaf gathered whole one at a time to
        # compare
        t0 = time.perf_counter()
        del whole_p, whole_opt
        mesh41 = make_host_mesh((MESH_RANKS, 1), device_type="cuda")
        store = CheckpointStore(os.path.join(out_dir, "ckpt"), keep=1)
        tree = {"params": p, "opt": opt}
        tspecs = {"params": specs, "opt": opt_pspecs(specs)}
        torch.cuda.synchronize()
        peak_before, resident = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _, save_s = wall_s(lambda: store.save(MESH_TRAIN_STEPS, tree, mesh=mesh, specs=tspecs))
        save_extra = torch.cuda.max_memory_allocated() - resident
        like = {"params": model32.shapes()}
        like["opt"] = adamw_init(like["params"])
        back, restore_s = wall_s(lambda: store.restore(MESH_TRAIN_STEPS, like, device=dev,
                                                       mesh=mesh41, specs=tspecs))
        one, one_s = (wall_s(lambda: store.restore(MESH_TRAIN_STEPS, like, device=dev))
                      if rank == 0 else (None, None))
        ok41 = ok1 = True
        ones = tree_leaves(one) if one is not None else [None] * len(tree_leaves(tree))
        for blk, b41, o, sp in zip(tree_leaves(tree), tree_leaves(back), ones,
                                   tree_leaves(tspecs)):
            w = mesh_collectives.whole(blk, mesh, sp)
            ok41 = ok41 and _bits_equal(b41, local_shard(w, sp, mesh41))
            if o is not None:
                ok1 = ok1 and _bits_equal(o, w)
            del w
        del ones
        ckpt = {"save_s": save_s, "restore_4x1_s": restore_s, "restored_4x1_bit_equal": ok41,
                "save_card_bytes_above_resident": save_extra,
                "bytes": sum(t.numel() * t.element_size() for t in tree_leaves(like))}
        if rank == 0:
            ckpt.update(restore_one_device_s=one_s, restored_one_device_bit_equal=ok1)
        del back, one
        dist.barrier()
        if not ok41 or not ckpt.get("restored_one_device_bit_equal", True):
            raise RuntimeError(f"phase 22 (b) rank {rank}: the checkpoint's restore: {ckpt}")
        if rank == 0:  # its files, which the runs that follow do not read
            shutil.rmtree(os.path.join(out_dir, "ckpt"))
        out["checkpoint"] = ckpt
        out["seconds"]["checkpoint"] = time.perf_counter() - t0
        out.setdefault("host", {})["checkpoint"] = _release_host("checkpoint", rank)
        out["peak_bytes"] = max(peak_before, torch.cuda.max_memory_allocated())
        del tree, p, opt, gsum, sel, mean, resid
        torch.cuda.empty_cache()
        out["dense"] = _mesh_dense(rank, world, mesh, seed, dev)
        out["seconds"]["dense"] = out["dense"]["seconds"]
        out["seconds"]["decode"] = out["dense"]["decode"]["seconds"]
        out["host"]["decode"] = _host_memory()
        out["recurrent"] = _mesh_recurrent(rank, world, mesh, seed, dev)
        out["seconds"]["recurrent"] = out["recurrent"]["seconds"]
        out["host"]["recurrent"] = out["recurrent"]["host"]
        out["launches"] = _launch_counts()
    finally:
        dist.destroy_process_group()
    out["seconds"]["rank"] = time.perf_counter() - t_rank
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


# (b)'s steps on (2, 2) the dry run predicts: the dense bf16 prefill and
# decode step, and zamba2-1.2b's f32 d-sharded prefill
MESH_DRY_RUN = ("prefill", "decode", "hybrid_prefill")


def mesh_dense_predictions(pool) -> dict:
    """The dry run of (b)'s dense bf16 prefill and decode step and of its
    zamba2-1.2b f32 prefill (the first group, d-sharded) on (2, 2), one
    count a rank on a ``MeshDescription`` standing for the rank's
    coordinate, submitted to ``pool``: {("mesh", kind, rank): pending
    result}."""
    dense = get_config(MESH_DENSE_ARCH).scaled(n_layers=MESH_DENSE_LAYERS)
    hyb = get_config(HYBRID_ARCH).scaled(n_layers=MESH_HYBRID_LAYERS, dtype="float32")
    desc = MeshDescription(MESH_SHAPE, ("data", "model"))
    cells = {"prefill": (dense, dict(seq_len=PREFILL_LEN, global_batch=MESH_DENSE_BATCH,
                                     kind="prefill")),
             "decode": (dense, dict(seq_len=MESH_DECODE_T, global_batch=MESH_DENSE_BATCH,
                                    kind="decode")),
             "hybrid_prefill": (hyb, dict(seq_len=PREFILL_LEN, global_batch=MESH_RECURRENT_BATCH,
                                          kind="prefill"))}
    return {("mesh", kind, r): pool.apply_async(dryrun.run_cell, (cfg.name, cell), {
        "cfg": cfg, "verbose": False,
        "mesh": desc.at(data=r // MESH_SHAPE[1], model=r % MESH_SHAPE[1])})
        for kind, (cfg, cell) in cells.items() for r in range(MESH_RANKS)}


def _dense_against_dry_run(ranks: list, preds: dict) -> dict:
    """Each rank's bf16 prefill and first bf16 decode step of the dense run,
    and its f32 zamba2-1.2b prefill, on (2, 2) against the dry run of its
    coordinate (``preds``: {kind: {rank: result}}): argument bytes exactly,
    arguments plus temporaries within ``DRYRUN_PEAK_RTOL`` of the measured
    peak."""
    out = {}
    for kind in MESH_DRY_RUN:
        for r, rank in enumerate(ranks):
            got = {"prefill": lambda: rank["dense"]["prefill"]["2x2|bfloat16"],
                   "decode": lambda: rank["dense"]["decode"]["bfloat16"],
                   "hybrid_prefill": lambda: rank["recurrent"]["hybrid"]["prefill"]}[kind]()
            pr = preds[kind][r]
            mem = pr["memory"]
            pred = mem["argument_bytes"] + mem["temp_bytes"]
            rel = (pred - got["peak_bytes"]) / got["peak_bytes"]
            out[f"{kind}|{r}"] = {"argument_bytes": mem["argument_bytes"],
                              "measured_argument_bytes": got["argument_bytes"],
                              "predicted_peak_bytes": pred,
                              "measured_peak_bytes": got["peak_bytes"], "peak_rel": rel,
                              "device": pr["device"], "layout": pr["layout"],
                              "collective_bytes": pr["collective_bytes"],
                              "trace_s": pr["trace_s"]}
            if mem["argument_bytes"] != got["argument_bytes"] or abs(rel) > DRYRUN_PEAK_RTOL:
                raise SystemExit(f"phase 22 (b): the dry run of rank {r}'s {kind} on "
                                 f"{MESH_SHAPE}: {out[f'{kind}|{r}']} (argument bytes exactly, the "
                                 f"peak within {DRYRUN_PEAK_RTOL:.0%})")
    return out


def mesh_four_ranks(seed: int, tmp: Path, preds: dict) -> dict:
    """(b): the gloo world of four ranks, one process each, sharing the
    card; every rank's gates raise in it, and a failed rank fails the
    phase.  ``preds``: the dry run of each rank's dense prefill and decode
    step ({kind: {rank: ``run_cell``'s result}}, :func:`mesh_dense_predictions`)."""
    torch.cuda.empty_cache()
    host = _release_host("(a), before (b)'s ranks start (this process)")
    # the machine's least available memory while the ranks run (its limit
    # is its memory: gloo stages collectives in pinned host memory)
    least, done = [host["available_gb"]], threading.Event()

    def sample():
        while not done.wait(0.2):
            least[0] = min(least[0], _host_memory()["available_gb"])

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    t0 = time.perf_counter()
    try:
        torch.multiprocessing.spawn(_mesh_rank, args=(MESH_RANKS, str(tmp / "gloo_rendezvous"),
                                                      str(tmp), seed), nprocs=MESH_RANKS)
    finally:
        done.set()
        sampler.join()
    wall = time.perf_counter() - t0
    host["least_available_during_b_gb"] = least[0]
    log(f"phase 22 (b): the machine's least available host memory while the ranks ran "
        f"{least[0]:.3f} GB")
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(MESH_RANKS)]
    backends = {r["backend"] for r in ranks}
    last = [r["train"][-1] for r in ranks]
    busy = sum(x["device_busy_s"] for x in last) / max(x["wall_s"] for x in last)
    out = {
        "backend": backends.pop() if len(backends) == 1 else sorted(backends),
        "wall_s": wall, "ranks": ranks, "main_host_before": host,
        "launches": {name: sum(r["launches"][name] for r in ranks) for name in WRAPPERS},
        "last_step_busy_share": busy,
        "train_step_s": [max(r["train"][s]["wall_s"] for r in ranks)
                         for s in range(MESH_TRAIN_STEPS)],
        "collective_s_per_step": [max(r["train"][s]["collective_s"] for r in ranks)
                                  for s in range(MESH_TRAIN_STEPS)],
    }
    r0 = ranks[0]
    log(f"phase 22 (b): {MESH_RANKS} ranks sharing the card, backend {out['backend']}, a "
        f"{MESH_SHAPE} (data, model) mesh, {MESH_ARCH} at full width cut to {MESH_LAYERS} "
        f"layer(s), global batch {MESH_BATCH} x {PREFILL_LEN}; {wall:.1f} s for the world "
        f"(start-up included); coordinates {[r['coordinate'] for r in ranks]}")
    for dtype in ("bfloat16", "float32"):
        g = [r["prefill"][dtype] for r in ranks]
        log(f"phase 22 (b): {dtype} sp prefill of each data shard's {MESH_BATCH // MESH_SHAPE[0]}"
            f" rows against the one-device prefill of those rows: logits within "
            f"{max(x['rel_l2'] for x in g):.3e} relative L2 (limit "
            f"{MESH_F32_REL_L2 if dtype == 'float32' else MESH_BF16_REL_L2}); layer 0's "
            f"dispatch against one device: tokens whose top-k differs "
            f"{[x['layer0_ties']['tokens_differing'] for x in g]}, the widest margin of their "
            f"one-device router probabilities "
            f"{[x['layer0_ties']['widest_margin_differing'] for x in g]} (limit "
            f"{MESH_ROUTER_TIE}); every layer's dispatch int for int with the numpy twin on "
            f"the rank's own router probabilities; its differences from the one-device "
            f"dispatch by layer {[x['dispatch_differences_by_layer'] for x in g]}; sharded "
            f"{[round(x['sharded_s'], 3) for x in g]} s, one device "
            f"{[round(x['one_device_s'], 3) for x in g]} s")
    for s in range(MESH_TRAIN_STEPS):
        rec = r0["train"][s]
        log(f"phase 22 (b): f32 train step {s + 1} (accum {MESH_ACCUM}): loss {rec['loss']:.4f}, "
            f"grad_norm {rec['grad_norm']:.4f}, {out['train_step_s'][s]:.2f} s (slowest rank), "
            f"collectives {out['collective_s_per_step'][s]:.2f} s of it (slowest rank, host "
            f"clock, waits included; {rec['collective_calls']} calls a rank); every gradient "
            f"leaf within {rec['grad_rel_l2_worst']:.3e} relative L2 of one device (worst "
            f"{rec['grad_rel_l2_worst_leaf']}; limit {GATE_GRAD_REL_L2})")
    pg = r0["train_params"]
    log(f"phase 22 (b): the parameters after {MESH_TRAIN_STEPS} f32 step(s), each leaf gathered "
        f"whole, against a one-device AdamW on the same gradients: every leaf within "
        f"{pg['rel_l2_worst']:.3e} relative L2 (worst {pg['rel_l2_worst_leaf']}; limit "
        f"{MESH_PARAMS_REL_L2}, {MESH_PARAMS_SMALL} absolute below a norm of 1e-3)")
    log(f"phase 22 (b): last step under the profiler: the card busy "
        f"{busy:.3f} of the slowest rank's wall time (the four ranks' kernel time summed), "
        f"{sum(x['kernel_launches'] for x in last)} kernel launches; "
        f"compressed_psum of {list(r0['compressed_psum'])} over the world: alike on every rank "
        f"and equal to the host's numpy bit for bit; checkpoint "
        f"({r0['checkpoint']['bytes'] / 1e9:.2f} GB: the f32 parameters, m, v, master and the "
        f"count) saved on {MESH_SHAPE} in {r0['checkpoint']['save_s']:.2f} s (card memory "
        f"above a rank's own state during the save at most "
        f"{max(r['checkpoint']['save_card_bytes_above_resident'] for r in ranks) / 1e9:.3f} GB)"
        f", restored on ({MESH_RANKS}, 1) in "
        f"{max(r['checkpoint']['restore_4x1_s'] for r in ranks):.2f} s and on one device in "
        f"{r0['checkpoint']['restore_one_device_s']:.2f} s, bit for bit; peak "
        f"{max(r['peak_bytes'] for r in ranks) / 1e9:.2f} GB a rank; seconds by part (rank 0) "
        f"{json.dumps({k: round(v, 2) for k, v in r0['seconds'].items()})}")
    dense = [r["dense"] for r in ranks]
    out["dense_launches_at_offset"] = sum(x["launches_at_offset"] for x in dense)
    if out["dense_launches_at_offset"] == 0:
        raise SystemExit("phase 22 (b): the attention kernel never ran at q_offset != 0")
    for key in dense[0]["prefill"]:
        g = [x["prefill"][key] for x in dense]
        whole = ""
        if "whole_peak_bytes" in g[0]:
            whole = (f"; with sp off (every dense weight gathered whole) "
                     f"{[round(x['whole_peak_bytes'] / 1e9, 3) for x in g]} GB, "
                     f"{[round(x['whole_s'], 2) for x in g]} s, logits within "
                     f"{max(x['whole_rel_l2'] for x in g):.3e}")
        log(f"phase 22 (b): {MESH_DENSE_ARCH} at full width cut to {MESH_DENSE_LAYERS} layers, "
            f"the {key.split('|')[1]} sp prefill of {MESH_DENSE_BATCH} x {PREFILL_LEN} on "
            f"{key.split('|')[0]} against the one-device prefill of each rank's rows: logits "
            f"within {max(x['rel_l2'] for x in g):.3e} relative L2, top-1 agreeing "
            f"{all(all(x['top1']) for x in g)}; {[round(x['s'], 2) for x in g]} s a rank; "
            f"arguments plus the card memory allocated at the peak above the rank's resident "
            f"state {[round(x['peak_bytes'] / 1e9, 3) for x in g]} GB{whole}")
    tr = [x["train"] for x in dense]
    log(f"phase 22 (b): {MESH_DENSE_ARCH}'s f32 loss and gradients on {MESH_SHAPE} (sp, remat) "
        f"against one device on the global batch: loss {tr[0]['loss']:.6f} within "
        f"{max(x['loss_rel'] for x in tr):.3e} relative (limit {GATE_LOSS_RTOL}), every "
        f"gradient leaf within {max(x['grad_rel_l2_worst'] for x in tr):.3e} relative L2 "
        f"(limit {GATE_GRAD_REL_L2}; worst {tr[0]['grad_rel_l2_worst_leaf']} on rank 0); "
        f"{[round(x['s'], 2) for x in tr]} s a rank; arguments plus peak "
        f"{[round(x['peak_bytes'] / 1e9, 3) for x in tr]} GB; the attention kernel launched at "
        f"q_offset != 0 {out['dense_launches_at_offset']} times over the ranks; dense run "
        f"{[round(x['seconds'], 1) for x in dense]} s a rank")
    dec = [x["decode"] for x in dense]
    for dtype in ("bfloat16", "float32"):
        g = [x[dtype] for x in dec]
        whole = ""
        if "whole_peak_bytes" in g[0]:
            whole = (f"; with every weight gathered whole and the cache's T whole "
                     f"{[round(x['whole_peak_bytes'] / 1e9, 3) for x in g]} GB, "
                     f"{[round(x['whole_s'], 2) for x in g]} s")
        log(f"phase 22 (b): {MESH_DENSE_ARCH} at full width cut to {MESH_DENSE_LAYERS} layers, "
            f"{MESH_DECODE_STEPS} {dtype} decode steps on {MESH_SHAPE} in the striped-cache "
            f"layout from a random cache at len {MESH_DECODE_LEN} of T {MESH_DECODE_T} "
            f"({MESH_DECODE_T // MESH_SHAPE[1]} rows a stripe) against one device's decode of "
            f"each rank's rows: logits within {max(max(x['rel_l2']) for x in g):.3e} relative L2 "
            f"(limit {MESH_DECODE_F32_REL_L2 if dtype == 'float32' else MESH_DENSE_BF16_REL_L2}),"
            f" cache blocks within {max(x['cache_rel_l2'] for x in g):.3e}, every model rank's "
            f"logits bit for bit {all(x['model_ranks_identical'] for x in g)}, greedy tokens "
            f"differing at one-device margins {[x['greedy_margins_differing'] for x in g]}; "
            f"steps {[[round(t, 2) for t in x['s']] for x in g]} s a rank; arguments plus the "
            f"card memory allocated at the first step's peak above the rank's resident state "
            f"{[round(x['peak_bytes'] / 1e9, 3) for x in g]} GB{whole}")
    g = [x["hybrid"] for x in dec]
    log(f"phase 22 (b): {HYBRID_ARCH}'s first group ({MESH_HYBRID_LAYERS} mamba2 layers and the "
        f"shared block) at full width in f32, {MESH_DECODE_STEPS} decode steps on {MESH_SHAPE} "
        f"(states on their blocks, shared_kv striped) against one device: logits within "
        f"{max(max(x['rel_l2']) for x in g):.3e} (limit {MESH_DECODE_F32_REL_L2}), cache blocks "
        f"within {max(x['cache_rel_l2'] for x in g):.3e}, model ranks bit for bit "
        f"{all(x['model_ranks_identical'] for x in g)}, greedy tokens differing at margins "
        f"{[x['greedy_margins_differing'] for x in g]}; steps "
        f"{[[round(t, 2) for t in x['s']] for x in g]} s a rank; peak "
        f"{[round(x['peak_bytes'] / 1e9, 3) for x in g]} GB; decode runs "
        f"{[round(x['seconds'], 1) for x in dec]} s a rank")
    rec = [x["recurrent"] for x in ranks]
    for key, arch, layers in (("hybrid", HYBRID_ARCH, f"its first group ({MESH_HYBRID_LAYERS} "
                               f"mamba2 layers and the shared block)"),
                              ("ssm", SSM_ARCH, f"{MESH_SSM_LAYERS} layers")):
        g = [x[key] for x in rec]
        pf, ls = [x["prefill"] for x in g], [x["loss"] for x in g]
        scans = {k: (v["heads"], v["max_abs_err"]) for k, v in pf[0]["scans"].items()}
        grads = (f", every gradient leaf within {max(x['grad_rel_l2_worst'] for x in ls):.3e} "
                 f"relative L2 (limit {GATE_GRAD_REL_L2}; worst "
                 f"{ls[0]['grad_rel_l2_worst_leaf']} on rank 0)")
        log(f"phase 22 (b): {arch} at full width, {layers}, f32, d-sharded on {g[0]['mesh']}, "
            f"{MESH_RECURRENT_BATCH} x {PREFILL_LEN}: the prefill of each rank's rows against "
            f"one device's, logits within {max(x['rel_l2'] for x in pf):.3e} relative L2 (limit "
            f"{MESH_F32_REL_L2}), {[round(x['s'], 2) for x in pf]} s a rank, arguments plus "
            f"the peak above the resident state {[round(x['peak_bytes'] / 1e9, 3) for x in pf]} "
            f"GB; with sp off ({pf[0]['whole_layout']}) "
            f"{[round(x['whole_peak_bytes'] / 1e9, 3) for x in pf]} GB, "
            f"{[round(x['whole_s'], 2) for x in pf]} s, logits within "
            f"{max(x['whole_rel_l2'] for x in pf):.3e}; ssd_scan on rank 0's first and last "
            f"scan inputs (heads, max abs err against its plain version) {scans}; the loss on "
            f"the global batch {ls[0]['loss']:.6f} within {max(x['loss_rel'] for x in ls):.3e} "
            f"of one device (limit {GATE_LOSS_RTOL}){grads}, "
            f"{[round(x['s'], 2) for x in ls]} s a rank, peak "
            f"{[round(x['peak_bytes'] / 1e9, 3) for x in ls]} GB; the run "
            f"{[round(x['seconds'], 1) for x in g]} s a rank")
    log(f"phase 22 (b): the recurrent runs {[round(x['seconds'], 1) for x in rec]} s a rank; "
        f"host memory after them (GB) {[x['host'] for x in rec]}")
    out["dry_run"] = _dense_against_dry_run(ranks, preds)
    for key, x in out["dry_run"].items():
        kind, r = key.split("|")
        log(f"phase 22 (b): the dry run of rank {r}'s {kind} ({x['device']}, "
            f"{x['layout']}) of {MESH_SHAPE}, counted in "
            f"{x['trace_s']:.1f} s on the host: argument bytes {x['argument_bytes']} against "
            f"{x['measured_argument_bytes']} on the rank; arguments + temporaries "
            f"{x['predicted_peak_bytes'] / 1e9:.3f} GB against the measured "
            f"{x['measured_peak_bytes'] / 1e9:.3f} GB ({x['peak_rel']:+.2%}, limit "
            f"{DRYRUN_PEAK_RTOL:.0%}); collectives {json.dumps(x['collective_bytes'])}")
    return out


def mesh_graph(seed: int, dev) -> dict:
    """(c): four shards round-robined over the mesh [cuda:0, cpu] against
    the four shards all on the card (phase 15's graph), on phase 15's first
    batches: each batch's answers, every shard's tables after it, the fused
    snapshot and ``reachable`` bit for bit."""
    cpu = torch.device("cpu")
    g_one = WaitFreeGraph(n_shards=SHARDS, device=dev)
    g_mesh = WaitFreeGraph(n_shards=SHARDS, mesh=[dev, cpu])
    rng = np.random.default_rng(seed)
    stream = build_stream(rng)
    batches = list(itertools.islice(stream, MESH_GRAPH_LOADS))
    while len(batches) < MESH_GRAPH_LOADS + MESH_GRAPH_TRAVERSALS:
        label, *b = next(stream)
        if label.startswith("traversal"):
            batches.append((label, *b))
    apply_s = 0.0
    for label, ops, us, vs in batches:
        want = g_one.apply(ops, us, vs)
        got, dt = wall_s(lambda: g_mesh.apply(ops, us, vs))
        apply_s += dt
        if not np.array_equal(got, want):
            raise SystemExit(f"phase 22 (c): {label}: answers differ from one device")
        for i, (a, b) in enumerate(zip(g_mesh.shards, g_one.shards)):
            if a.v_key.device != (dev if i % 2 == 0 else cpu):
                raise SystemExit(f"phase 22 (c): shard {i} is on {a.v_key.device}")
            for f in GraphState._fields:
                if not torch.equal(getattr(a, f).to(dev), getattr(b, f)):
                    raise SystemExit(f"phase 22 (c): {label}: shard {i}'s {f} differs")
    csr, fuse_s = wall_s(g_mesh.traversal_csr)
    require_csr_equal("phase 22 (c) fused snapshot", csr, g_one.traversal_csr())
    # the traversal batches' first 128 edge-op pairs and 128 drawn pairs
    tr = [b for b in batches if b[0].startswith("traversal")]
    eu = np.concatenate([b[2][np.isin(b[1], (OP_ADD_EDGE,))] for b in tr])[:128]
    ev = np.concatenate([b[3][np.isin(b[1], (OP_ADD_EDGE,))] for b in tr])[:128]
    keys = np.concatenate([b[2] for b in batches])
    pairs = np.concatenate([np.stack([eu, ev]), rng.choice(keys, (2, 128))], 1).astype(np.int32)
    reach, reach_s = wall_s(lambda: g_mesh.reachable(pairs[0], pairs[1]))
    if not np.array_equal(reach, g_one.reachable(pairs[0], pairs[1])):
        raise SystemExit("phase 22 (c): reachable differs from one device")
    out = {"batches": len(batches), "ops": int(sum(b[1].size for b in batches)),
           "apply_s": apply_s, "fuse_s": fuse_s, "reachable_s": reach_s,
           "reached": int(reach.sum()), "shard_capacities": _shard_caps(g_mesh),
           "fused_edges": int(csr.n_edges)}
    log(f"phase 22 (c): {SHARDS} shards on the mesh [{dev}, cpu] (shards 0 and 2 on the card): "
        f"the first {MESH_GRAPH_LOADS} batches of phase 15's stream and its first "
        f"{MESH_GRAPH_TRAVERSALS} traversal batches ({out['ops']} ops, {apply_s:.2f} s of "
        f"apply) answer as the 4 shards on the card, bit for bit, every shard's tables equal "
        f"after every batch; shard capacities {out['shard_capacities']}; the fused snapshot "
        f"({out['fused_edges']} edges, {fuse_s * 1e3:.1f} ms) field for field and reachable on "
        f"{pairs.shape[1]} pairs (edge adds' endpoints and drawn keys; {out['reached']} "
        f"reached) equal")
    return out


def mesh_phase(seed: int, dev, preds: dict) -> dict:
    """Phase 22 with every launch count set to 0 just before it: (a) and
    (c) counted in this process, (b)'s ranks each from its own start; the
    path's kernels must have run.  ``preds``: the dry run of each rank of
    (b)'s dense run ({kind: {rank: ``run_cell``'s result}})."""
    tmp = Path(tempfile.mkdtemp(prefix="mesh_phase_", dir=ROOT / "build"))
    try:
        for w in WRAPPERS.values():
            w.launches = w.calls = 0
        ck.probe_place.rounds = None
        out = {"one_rank": mesh_one_rank(seed, dev, tmp)}
        torch.cuda.empty_cache()
        out["four_ranks"] = mesh_four_ranks(seed, tmp, preds)
        out["graph"] = mesh_graph(seed, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    here = _launch_counts()
    counts = {name: here[name] + out["four_ranks"]["launches"][name] for name in WRAPPERS}
    out["launches"] = counts
    log(f"phase 22: kernel launches on the path ((a) and (c) here, (b) summed over its ranks): "
        f"{json.dumps(counts)}")
    missing = [name for name in MESH_PATH if counts[name] == 0]
    if missing:
        raise SystemExit(f"phase 22 never launched: {missing}")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()
    phase_s = {}

    # phase 1: the card and the kernel build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    t0 = time.perf_counter()
    lib = _build.library()
    log(f"phase 1: card {torch.cuda.get_device_name(0)} ({smi}); kernels built from "
        f"src/repro_torch/csrc in {time.perf_counter() - t0:.1f} s; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    sass = hopper_sass(Path(lib._name))

    small_kernel_checks(dev)

    # phase 3: the graph's main path, with every launch count read around it
    summary, g, oracle, sources = run_counted(GRAPH_PATH, lambda: main_path(args.seed))
    launches = {name: fn.launches for name, fn in WRAPPERS.items()}
    calls = {name: fn.calls for name, fn in WRAPPERS.items()}
    rows = full_shape_kernels(g, sources, launches, calls, place_rounds(), dev)

    # phase 14 on the same graph, with every launch count read around it
    t0 = time.perf_counter()
    summary["delta"], fold_inputs = run_counted(
        GRAPH_PATH, lambda: delta_path(g, oracle, args.seed, dev))
    delta_launches = _launch_counts()
    for row in rows:
        row["launches_delta_path"] = delta_launches[row["name"]]
    if fold_inputs is None:
        raise SystemExit("phase 14: no fold compacted the snapshot's rows")
    rows.append(fold_compact_row(*fold_inputs, delta_launches["masked_compact"]))
    del g, oracle, fold_inputs
    phase_s["14"] = time.perf_counter() - t0

    # phase 15: the sharded graph, with every launch count read around it
    t0 = time.perf_counter()
    summary["sharded"] = run_counted(GRAPH_PATH, lambda: sharded_path(args.seed, dev))
    sharded_launches = _launch_counts()
    for row in rows:
        row["launches_sharded_path"] = sharded_launches[row["name"]]
    torch.cuda.empty_cache()
    phase_s["15"] = time.perf_counter() - t0

    flash_small_checks(dev)

    # phase 6: the LM's serving path, with every launch count read around it
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products stay f32
    lm_cfg = get_config(LM_ARCH)
    summary["lm"] = run_counted(SERVE_PATH, lambda: lm_serve_path(
        LM_ARCH, 6, args.seed, dev, plain_run={"attn_impl": "reference"},
        per_prefill={"flash_attention": lm_cfg.n_layers}))
    summary["lm"]["launches"] = {name: fn.launches for name, fn in WRAPPERS.items()}
    rows.append(flash_full_shape(LM_ARCH, lm_cfg, summary["lm"]["launches"]["flash_attention"],
                                 dev))
    hyb_cfg = get_config(HYBRID_ARCH)
    hyb_flash = flash_full_shape(HYBRID_ARCH, hyb_cfg, 0, dev)  # launches: phase 10's
    rows.append(hyb_flash)
    # the last model rank's q block of the sequence-parallel layout; launches:
    # phase 22's at an offset
    sp_flash = flash_full_shape(LM_ARCH, lm_cfg, 0, dev, what="sp block", sp_blocks=SP_BLOCKS)
    rows.append(sp_flash)
    phase_s["1-7"] = time.perf_counter() - t_start - phase_s["14"] - phase_s["15"]

    t0 = time.perf_counter()
    ssd_small_checks(dev)
    phase_s["8"] = time.perf_counter() - t0

    # phases 9 and 10: the recurrent LMs, each with every launch count read
    # around it
    ssm_cfg = get_config(SSM_ARCH).scaled(n_layers=SSM_LAYERS)
    plain_scan = {"scan_impl": "reference"}
    t0 = time.perf_counter()
    summary["ssm"] = run_counted(RWKV_PATH, lambda: lm_serve_path(
        SSM_ARCH, 9, args.seed, dev, plain_run=plain_scan,
        per_prefill={"ssd_scan": ssm_cfg.n_layers}, handoff=_model_handoff, gate_f32=True,
        scan_calls=(0, ssm_cfg.n_layers - 1), n_layers=SSM_LAYERS))
    summary["ssm"]["launches"] = {name: fn.launches for name, fn in WRAPPERS.items()}
    summary["ssm"]["calls"] = {name: fn.calls for name, fn in WRAPPERS.items()}
    phase_s["9"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hyb_cut = hyb_cfg.scaled(n_layers=HYBRID_LAYERS)
    summary["hybrid"] = run_counted(ZAMBA_PATH, lambda: lm_serve_path(
        HYBRID_ARCH, 10, args.seed, dev, plain_run=plain_scan,
        per_prefill={"ssd_scan": hyb_cut.n_layers,
                     "flash_attention": hyb_cut.n_layers // hyb_cut.shared_attn_every},
        handoff=_block_handoff, gate_f32=True, scan_calls=(0, hyb_cut.n_layers - 1),
        n_layers=HYBRID_LAYERS))
    summary["hybrid"]["launches"] = {name: fn.launches for name, fn in WRAPPERS.items()}
    summary["hybrid"]["calls"] = {name: fn.calls for name, fn in WRAPPERS.items()}
    hyb_flash["launches"] = summary["hybrid"]["launches"]["flash_attention"]
    phase_s["10"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    rows.append(ssd_full_shape(SSM_ARCH, ssm_cfg, False, True, summary["ssm"], dev))
    rows.append(ssd_full_shape(HYBRID_ARCH, hyb_cfg, True, False, summary["hybrid"], dev))
    phase_s["11"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    paged_small_checks(dev)
    phase_s["12"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows.append(paged_full_shape(LM_ARCH, lm_cfg, summary["lm"]["launches"], args.seed, dev))
    rows.append(paged_full_shape(HYBRID_ARCH, hyb_cfg, summary["hybrid"]["launches"], args.seed,
                                 dev))
    phase_s["13"] = time.perf_counter() - t0

    family_phases(args.seed, dev, rows, summary, phase_s)

    # phase 20: training, with every launch count read around it; phase
    # 21's dry run counted on the host meanwhile
    t0 = time.perf_counter()
    pool, pending = start_dry_run()
    try:
        summary["train"] = run_counted(TRAIN_PATH, lambda: train_path(args.seed, dev))
        train_launches = _launch_counts()
        for row in rows:
            if row["name"] in (f"flash_attention[{TRAIN_ARCH}]", f"ssd_scan[{TRAIN_ARCH}]"):
                name = row["name"].split("[")[0]
                row["launches_train_path"] = train_launches[name]
                row["plain_backward_ms"] = summary["train"]["backward_ms"][name]
        phase_s["20"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        summary["dryrun"] = dry_run_against_card(pending, summary, smi)
        mesh_preds = {kind: {r: pending[("mesh", kind, r)].get(timeout=DRYRUN_WAIT_S)
                             for r in range(MESH_RANKS)} for kind in MESH_DRY_RUN}
        phase_s["21"] = time.perf_counter() - t0
    finally:
        pool.terminate()
        pool.join()

    # phase 22: several ranks on one mesh, with every launch count read
    # around it
    t0 = time.perf_counter()
    summary["mesh"] = mesh_phase(args.seed, dev, mesh_preds)
    for row in rows:
        row["launches_mesh_path"] = summary["mesh"]["launches"][row["name"].split("[")[0]]
    sp_flash["launches"] = summary["mesh"]["four_ranks"]["dense_launches_at_offset"]
    phase_s["22"] = time.perf_counter() - t0

    summary["card"] = smi
    summary["sass"] = sass
    summary["seconds"] = time.perf_counter() - t_start
    summary["phase_seconds"] = phase_s
    log(f"wall seconds by phase: {json.dumps(phase_s)}; total {summary['seconds']:.1f}")
    log("main paths: " + json.dumps(summary))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
