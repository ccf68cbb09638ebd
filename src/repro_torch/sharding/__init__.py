"""Logical-axis sharding over a mesh of ranks (PyTorch port of
``repro.sharding``): ``rules`` resolves logical axes onto mesh axes and
slices a parameter tree to a rank's blocks, ``collectives`` runs the
reference's ``shard_map`` collectives on ``torch.distributed``."""
