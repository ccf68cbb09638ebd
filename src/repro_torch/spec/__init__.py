"""Speculative decoding for Engram serving (PyTorch port of ``repro.spec``,
the paper's deep-lookahead regime): proposers draft future tokens from
token IDs the engine already has, a batched verifier scores the whole block
in one wave, and the accepted prefix widens the Engram prefetch window to
several real decode steps (``pool.scheduler.speculative_wave``)."""
from .proposer import (ConstantProposer, DraftModelProposer, NGramProposer,
                       Proposer, ScriptedProposer, draft_config,
                       make_proposer)
from .verifier import accept_lengths, build_verifier

__all__ = [
    "Proposer", "NGramProposer", "DraftModelProposer", "ScriptedProposer",
    "ConstantProposer", "draft_config", "make_proposer",
    "build_verifier", "accept_lengths",
]
