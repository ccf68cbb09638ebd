from .engine import Engine, EngineStats, Request
from .runtime import EngramRuntime, RequestHandle, TokenEvent
from .slo import DEFAULT_SLOS, OverloadPolicy, SLOSpec

__all__ = ["DEFAULT_SLOS", "Engine", "EngineStats", "EngramRuntime",
           "OverloadPolicy", "Request", "RequestHandle", "SLOSpec",
           "TokenEvent"]
