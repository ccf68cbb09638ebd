"""Experiment drivers (PyTorch port of the reference's ``experiments/``):
``hillclimb``, one dry-run cell re-traced with named flags and rules."""
