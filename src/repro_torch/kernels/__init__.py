"""The port's Hopper kernels and their plain PyTorch versions.

All six of the reference's Pallas kernels are ported, each a ``csrc/*.cu``
source and a wrapper module: ``router_step``, ``popcount``, ``bt_count``,
``bitonic_sort`` (the window sort), ``order_unit`` and ``chain_select``; the
last three share the bitonic network in ``csrc/bitonic.cuh``. ``ops``
dispatches a CUDA tensor to the kernel and a CPU tensor to its plain version
in ``ref``. ``min_hamming`` is the O3 chain, which runs one chain-select
call per step.
"""
