"""Serving: the batched decode engine with a scrutinizable state, and
preemption-safe session management (scrutinized KV snapshots, live
migration, degraded-mode adoption)."""

from repro_torch.serve.engine import Engine
from repro_torch.serve.migrate import (AdoptionReport, adopt_sessions,
                                       manifest_sessions, restore_sessions,
                                       session_owners)
from repro_torch.serve.sessions import SessionManager

__all__ = [
    "Engine", "SessionManager", "AdoptionReport", "adopt_sessions",
    "manifest_sessions", "restore_sessions", "session_owners",
]
