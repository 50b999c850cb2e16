import os
import sys

# tests import the library from src/ (works with or without PYTHONPATH=src)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs an NVIDIA card; skips on a host without CUDA")
