"""Benchmarks of the port, each the counterpart of a script in the
repository's root ``benchmarks/`` folder: ``python -m
repro_torch.benchmarks.<name>``."""
