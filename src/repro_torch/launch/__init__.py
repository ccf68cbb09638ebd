"""Command-line entry points (PyTorch port of ``repro.launch``):
``serve``, the serving CLI, and ``train.reduced_config``."""
