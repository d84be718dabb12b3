"""Preemption-safe serving: scrutinized snapshots of live decode sessions
(port of ``repro.serve.sessions``).

A serving host runs N concurrent decode sessions, each an ``Engine`` state
``{cache, pos, tokens}``.  That state is the paper's "variables necessary
for checkpointing" for inference: the output is the next-token logits, the
variable is the KV cache, and ``scrutinize()`` on ``Engine.resume_fn``
proves which cache bytes the remaining decode can read (slots at or beyond
``pos`` are overwritten before they are read: an exactly-zero derivative),
so snapshots carry only the logit-affecting prefix.  ``SessionManager``
wires those masks into the coordinated checkpoint stack:

- every session's state is a *host-local* leaf set (``sessions/<sid>/…``),
  pinned to its owner with ``distributed.collective.HostPinned``: each
  host snapshots only the sessions it runs, and manifest fusion stitches
  the per-host session sets into one global manifest;
- snapshots ride the three-stage async pipeline with per-step differential
  chains (``Level(max_chain=…)``): the KV cache is append-only between
  decode steps, so a delta save is near-zero bytes;
- every save lands at the resilience levels of ``checkpoint/levels.py``
  (L1 resident, L2 ring-partner replica, shared store), so a dead host's
  sessions are recoverable from its partner with zero shared-store reads.

On the card the scrutiny's masks stay there as K1's words
(``DeviceLeafReport``), renamed under ``sessions/<sid>/`` without a copy,
and the snapshot packs each session's cache with K2 from them; a restore
expands with K4.  The engine's cache is in the compute dtype (bf16 on the
card); the scrutiny reads it in f32 (``Engine.resume_fn`` casts it up;
ROADMAP Queue 3: in bf16 the vjp can cancel a critical element to zero).

**Mask soundness under chains**: a mask computed at position ``p`` marks
slots ≥ ``p`` uncritical, but the next ``k`` decode steps *write* slots
``p … p+k-1``; reusing the report for later snapshots would drop freshly
written KV.  Scrutiny therefore runs against a widened probe state whose
position is advanced by ``mask_headroom`` decode steps (attention reads
every slot below the current position, so the widened mask is a superset
of every mask needed until the next re-scrutiny).  With ``mask_headroom
== rescrutinize_every`` (the default) and one snapshot per decode step,
every snapshot between two scrutinies stays inside the fixed payload
layout, which is also what keeps delta chains (keyed on report identity)
alive between re-scrutinies.  Each scrutiny gives a new report, so a
re-scrutiny starts a new base snapshot, as in the reference.

Restore is *elastic* (``restore()``): sessions present in the newest
committed manifest are rebuilt exactly; sessions opened after the snapshot
was dispatched keep their live state and are reported through
``missing_out`` accounting instead of raising.  Cross-host migration and
degraded-mode adoption of a dead host's sessions live in
``repro_torch.serve.migrate``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from repro_torch import _tree
from repro_torch.checkpoint.coordinator import CoordinatedCheckpointManager
from repro_torch.core import ScrutinyConfig, scrutinize
from repro_torch.core.criticality import (CriticalityReport,
                                          DeviceLeafReport, LeafReport)
from repro_torch.distributed.collective import HostPinned
from repro_torch.serve import migrate


def _renamed_leaf(lr, name: str):
    """Per-session report leaf, re-rooted under ``sessions/<sid>/``.  A
    device leaf keeps its resident words (no D2H, no copy)."""
    if isinstance(lr, DeviceLeafReport):
        return DeviceLeafReport(name, lr.shape, lr.dtype, lr.policy, lr.n,
                                lr.critical, lr.device,
                                words_dev=lr.words_dev,
                                magnitude_dev=lr.magnitude_dev,
                                stats=lr._stats)
    return dataclasses.replace(lr, name=name)


class SessionManager:
    """N concurrent decode sessions with scrutinized, coordinated snapshots.

    Wraps one shared ``serve.engine.Engine`` and one
    ``CoordinatedCheckpointManager`` (on the engine's device) whose state
    tree is ``{"sessions": {sid: {cache, pos, tokens}}}``: only this host's
    sessions, every leaf ``HostPinned`` to this process.

    ``max_sessions`` is the load-shedding capacity: ``open()`` (and
    degraded-mode adoption) refuse sessions beyond it rather than
    oversubscribing the host.

    ``horizon``: decode steps the scrutiny target runs (the "rest of the
    program"); ``mask_headroom``: extra decode positions the probe state
    is advanced by so masks stay sound for every snapshot until the next
    re-scrutiny (default: ``rescrutinize_every``).
    """

    def __init__(self, engine, levels, *, collective=None,
                 horizon: int = 2, rescrutinize_every: int = 4,
                 mask_headroom: Optional[int] = None,
                 scrutiny_config: Optional[ScrutinyConfig] = None,
                 scrutinize_sessions: bool = True,
                 max_sessions: Optional[int] = None,
                 **ckpt_kwargs):
        self.engine = engine
        self.horizon = int(horizon)
        self.mask_headroom = (int(rescrutinize_every) if mask_headroom is None
                              else int(mask_headroom))
        self.scrutiny_config = scrutiny_config or ScrutinyConfig(probes=2)
        # one function for the manager's life: caches kept per function
        # (the shared trace) hit across re-scrutinies
        self._resume = engine.resume_fn(self.horizon)
        self.max_sessions = max_sessions
        self.sessions: Dict[str, Dict[str, Any]] = {}
        self.last_session_stats: Optional[Dict[str, Any]] = None
        ckpt_kwargs.setdefault("device", engine.device)
        self.ckpt = CoordinatedCheckpointManager(
            levels, collective=collective,
            scrutiny_fn=(self._scrutinize_tree if scrutinize_sessions
                         else None),
            rescrutinize_every=rescrutinize_every, **ckpt_kwargs)
        self.ctx = self.ckpt.ctx

    # --- lifecycle --------------------------------------------------------

    def __enter__(self) -> "SessionManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        self.ckpt.close()

    def wait(self) -> None:
        self.ckpt.wait()

    # --- serving ----------------------------------------------------------

    def open(self, sid: str, batch) -> torch.Tensor:
        """Prefill a new session; returns its first greedy token(s)."""
        if "/" in sid:
            raise ValueError(f"session id {sid!r} must not contain '/' "
                             "(ids become manifest leaf path components)")
        if sid in self.sessions:
            raise ValueError(f"session {sid!r} already open")
        if (self.max_sessions is not None
                and len(self.sessions) >= self.max_sessions):
            raise RuntimeError(
                f"at capacity ({self.max_sessions} sessions): shedding "
                f"session {sid!r}")
        state = self.engine.start(batch)
        self.sessions[sid] = state
        return state["tokens"][:, 0]

    def step(self, sid: str) -> torch.Tensor:
        """One greedy decode step for one session; returns its token(s)."""
        state, tok = self.engine.step(self.sessions[sid])
        self.sessions[sid] = state
        return tok

    def decode(self, sid: str, n_steps: int) -> torch.Tensor:
        """``n_steps`` decode steps; returns tokens ``(batch, n_steps)``."""
        return torch.stack([self.step(sid) for _ in range(n_steps)], dim=1)

    def drop(self, sid: str) -> None:
        self.sessions.pop(sid, None)

    # --- scrutiny ---------------------------------------------------------

    def _scrutinize_tree(self, tree) -> CriticalityReport:
        """Per-session KV criticality, merged into one report whose leaf
        names match the snapshot tree (``sessions/<sid>/…``).

        Each session is probed at ``pos + mask_headroom`` (clamped to
        ``max_len - horizon``) so the mask remains a superset of every
        mask needed until the next re-scrutiny: the soundness condition
        for reusing it across delta-chain snapshots of a growing cache.
        """
        obs = self.ckpt.obs
        leaves: Dict[str, Any] = {}
        stats: Dict[str, Any] = {"sessions": {}}
        cap = max(int(self.engine.max_len) - self.horizon, 0)
        with obs.tracer.span("serve.scrutinize",
                             sessions=len(tree["sessions"])):
            for sid, state in tree["sessions"].items():
                probe = dict(state)
                if self.mask_headroom:
                    probe["pos"] = torch.clamp(
                        state["pos"] + self.mask_headroom, max=cap).to(
                            state["pos"].dtype)
                rep = scrutinize(self._resume, probe,
                                 config=self.scrutiny_config,
                                 device=self.engine.device)
                for name, lr in rep.leaves.items():
                    full = f"sessions/{sid}/{name}"
                    leaves[full] = _renamed_leaf(lr, full)
                stats["sessions"][sid] = {
                    "total": rep.total_elements,
                    "uncritical": rep.uncritical_elements,
                    "uncritical_rate": rep.uncritical_rate,
                }
        self.last_session_stats = obs.registry.publish("sessions", stats)
        return CriticalityReport(leaves=leaves, stats=stats)

    # --- snapshot / restore ----------------------------------------------

    def state_tree(self) -> Dict[str, Any]:
        return {"sessions": dict(self.sessions)}

    def snapshot(self, step: int, block: bool = False):
        """Coordinated snapshot of this host's live sessions.

        The caller blocks only for scrutiny (when due), snapshot isolation
        and the stage-1 pack dispatch; D2H, shard writes, L2 replication
        and the two-phase commit run on the writer thread.  With
        ``Level(max_chain=K)`` consecutive snapshots between re-scrutinies
        ride a differential chain (append-only KV: near-zero deltas).
        """
        obs = self.ckpt.obs
        with obs.tracer.span("serve.snapshot", step=int(step),
                             sessions=len(self.sessions)):
            tree = self.state_tree()
            # session sets change between saves: re-pin the shardings tree
            # to match (the coordinator reads it synchronously in save())
            named, treedef = _tree.flatten_with_names(tree)
            self.ckpt.shardings = _tree.unflatten(
                treedef, [HostPinned(self.ctx.index)] * len(named))
            out = self.ckpt.save(step, tree, block=block)
        if obs.enabled:
            obs.registry.gauge("serve.sessions").set(len(self.sessions))
        return out

    def restore(self, sids: Optional[List[str]] = None,
                missing_out: Optional[List[Dict[str, Any]]] = None
                ) -> Optional[int]:
        """Elastic restore from the newest committed session snapshot.

        Default target set is the union of this manager's live sessions
        and every session in the manifest (so a freshly started host
        adopts the whole snapshot, and a running host rolls its sessions
        back).  Sessions *not* in the manifest (opened after the snapshot
        was dispatched) keep their live state and are appended to
        ``missing_out`` as ``{"sid", "reason", "step"}`` records instead
        of raising.  Returns the restored step (None when no committed
        snapshot exists).
        """
        with self.ckpt.obs.tracer.span("serve.restore"):
            res = migrate.restore_sessions(self.ckpt, sids=sids)
        if res is None:
            if missing_out is not None:
                for sid in (sids if sids is not None
                            else sorted(self.sessions)):
                    missing_out.append({"sid": sid, "step": None,
                                        "reason": "no committed snapshot"})
            return None
        step, restored, missing = res
        if sids is None:
            # live sessions the snapshot predates: keep them, report them
            missing = sorted(set(self.sessions) - set(restored))
        for sid, state in restored.items():
            self.sessions[sid] = state
        if missing_out is not None:
            for sid in sorted(set(missing)):
                missing_out.append({
                    "sid": sid, "step": step,
                    "reason": ("opened after snapshot dispatch; live state "
                               "kept" if sid in self.sessions
                               else "not in manifest")})
        return step
