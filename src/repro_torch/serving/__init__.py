from .clock import Cursor, Link, Transfer, VirtualClock
from .engine import Engine, EngineStats, Request
from .slo import DEFAULT_SLOS, OverloadPolicy, SLOSpec
from .slots import select_slots, update_slots
from .runtime import EngramRuntime, RequestHandle, TokenEvent
from .router import POLICIES, Router, RouterStats
from .workload import RequestSpec, Workload
from .api import ServeResult, serve

__all__ = ["Cursor", "DEFAULT_SLOS", "Engine", "EngineStats", "EngramRuntime",
           "Link", "OverloadPolicy", "POLICIES", "Request", "RequestHandle",
           "RequestSpec", "Router", "RouterStats", "SLOSpec", "ServeResult",
           "TokenEvent", "Transfer", "VirtualClock", "Workload",
           "select_slots", "serve", "update_slots"]
