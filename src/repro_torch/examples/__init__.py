"""Runnable examples of the port: ``python -m repro_torch.examples.<name>``
from the repository root with ``PYTHONPATH=src``."""
