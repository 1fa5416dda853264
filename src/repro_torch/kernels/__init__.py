"""Hand-written CUDA kernels of the port, one family per directory.

Each family keeps three modules: ``ref.py`` (the plain PyTorch version),
``kernel.py`` (the launch wrapper of the CUDA kernel in ``csrc/``, with its
launch counter) and ``ops.py`` (dispatch by the tensors' device).  The
families, one for each Pallas kernel of ``repro``:

* ``hash_probe`` (``csrc/hash_probe.cu``): the bounded triangular probe;
* ``compact`` (``csrc/compact.cu``): ``masked_compact`` and ``probe_place``;
* ``frontier`` (``csrc/frontier.cu``): the scatter-min BFS step;
* ``flash_attention`` (``csrc/flash_attention.cu``): prefill attention;
* ``ssd_scan`` (``csrc/ssd_scan.cu``): the gated linear-attention scan;
* ``paged_attention`` (``csrc/paged_attention.cu``): one-token decode
  attention over K/V pages addressed through the page table's block tables.
"""
