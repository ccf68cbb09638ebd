"""Roofline tooling (PyTorch port of ``repro.roofline``): the H100
roofline and model FLOPs (``analysis``), the operation counter over the
eager program, the counterpart of ``hlo_scale`` (``counting``), and the
report over dry-run records (``report``)."""
