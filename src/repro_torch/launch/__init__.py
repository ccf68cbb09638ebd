"""Command-line entry points (PyTorch port of ``repro.launch``):
``serve``, the serving CLI, ``mesh``, meshes of ``torch.distributed``
ranks, and ``train.reduced_config``."""
