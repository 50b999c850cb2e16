"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``<name>_ref.py``), which the CPU tests run and the card compares
against.  Sources live in ``csrc/`` and are compiled at first use."""
