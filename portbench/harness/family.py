"""A configuration's family: how the harness maps it onto the port, the
plain reference its served tokens are checked against, and its model
FLOPs, found by name as the metrics' readers are.

``of(c)`` looks for ``portbench/families/<model_type>.py``, where
``model_type`` is the configuration's Hugging Face key, and returns a
namespace of five members:

- ``model_config(c)``: the port's ``ModelConfig``; refuses what the port
  cannot run as stated;
- ``run_flags(c)``: the engine's ``RunFlags``;
- ``Reference``: the class ``(c, params, device, linear=None)`` with
  ``.logits(seqs, want)``, plain ``torch`` in float32 with TF32 off
  (``reference.common.f32_matmuls``), importing no kernel of the port;
  ``linear`` is the control's ``reference.common.Float8Linear``;
- ``prefill(c, n)``, ``decode(c, pos)``: model FLOPs of a prompt of ``n``
  tokens and of one decode step at position ``pos`` (``step_mfu``).

A member the file does not define, and every member where no file
exists, is the harness's own: ``harness.model.model_config``,
``harness.model.run_flags``, ``reference.model.Reference``,
``roofline.flops.prefill`` and ``roofline.flops.decode``. A file that
maps the configuration itself states a model the harness's own reference
and FLOPs do not compute, so it defines ``Reference``, ``prefill`` and
``decode`` as well, or is refused.
"""
from __future__ import annotations

import types
from pathlib import Path

from ..reference import model as reference
from ..roofline import flops
from . import cell as cells
from . import model

MEMBERS = ("model_config", "run_flags", "Reference", "prefill", "decode")
WITH_MAPPING = ("Reference", "prefill", "decode")


def of(c: dict, root: Path = cells.ROOT) -> types.SimpleNamespace:
    """Configuration ``c``'s family: each member from its family file where
    the file defines it, else the harness's own."""
    ns = {"model_config": model.model_config, "run_flags": model.run_flags,
          "Reference": reference.Reference, "prefill": flops.prefill,
          "decode": flops.decode}
    mt = c.get("model_type")
    p = Path(root) / "portbench" / "families" / f"{mt}.py"
    if mt and p.is_file():
        mod = cells.load_file(p, "family")
        own = {m: getattr(mod, m) for m in MEMBERS if hasattr(mod, m)}
        missing = [m for m in WITH_MAPPING if m not in own]
        if "model_config" in own and missing:
            raise ValueError(f"{p.name} maps the configuration itself but "
                             f"leaves out {', '.join(missing)}: the "
                             "harness's own check and count another model")
        ns.update(own)
    return types.SimpleNamespace(**ns)
