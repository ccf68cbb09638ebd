from .engine import Engine, EngineStats, Request
from .runtime import EngramRuntime, RequestHandle, TokenEvent

__all__ = ["Engine", "EngineStats", "EngramRuntime", "Request",
           "RequestHandle", "TokenEvent"]
