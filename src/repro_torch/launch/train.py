"""The training entry point (PyTorch port of ``repro.launch.train``).

Only ``reduced_config`` is ported so far: the serving CLI and the examples
use it. The trainer itself waits for the training modules (ROADMAP queue
1, item 10).
"""
from __future__ import annotations

import importlib


def reduced_config(arch: str):
    """The reduced (CPU-sized) config of ``arch``, e.g. ``deepseek-7b``."""
    mod = importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}")
    return mod.reduced()
