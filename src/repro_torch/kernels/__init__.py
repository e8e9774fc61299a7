"""The port's Hopper kernels and their plain PyTorch versions.

All six of the reference's Pallas kernels are ported, each a ``csrc/*.cu``
source and a wrapper module: ``router_step``, ``popcount``, ``bt_count``,
``bitonic_sort`` (the window sort), ``order_unit`` and ``chain_select``; the
last three share the bitonic network in ``csrc/bitonic.cuh`` (the chain
select for rows over 1,024 lanes; it sorts narrower rows a warp a row, in
registers; the ordering unit sorts rows of up to 1,024 words in
registers too, on ``warp_bitonic``). ``bt_count`` writes a stream's
per-boundary counts, its total (``ops.bt_total``) or both in one launch,
and, as its second entry point (``ops.bt_measure``), the total with Eq.
3's popcount sums, which is all the no-NoC ``wire.measure`` launches. ``ops``
dispatches a CUDA tensor to the kernel and a CPU tensor to its plain version
in ``ref``. ``min_hamming`` is the O3 chain: each chain call is one launch
of ``chain_greedy`` (``csrc/chain_greedy.cu``), which runs every step of
every chain in the kernel; ``chain_select`` is the one-step body that the
reference's ``chain_select_pallas`` is, kept as an entry point of its own.
Where the port orders by popcount, the counts never leave the card:
``popcount_order`` (``csrc/popcount_order.cu``) turns each window's counts
into its O1/O2 permutation (``ops.descending_perm_rows``) or its O3 chain
preamble (``ops.chain_inputs``) in one launch; ``popcount`` stays the
one-to-one popcount of ``ops.popcount`` / ``core.bits.popcount`` on CUDA
tensors, an entry point the main path no longer takes.
"""
