"""``repro_torch.resilience``: surviving lost frames, dead clients and
preemption.  Port of ``repro.resilience``.

* **Retry + idempotency**: :class:`RetryPolicy` drives client-side
  re-sends (exponential backoff, seeded jitter, same ``seq``); the
  ``FLServer`` dedups by ``(client, seq)`` and replays its cached reply,
  evicts silent clients on liveness deadlines, re-admits them on their
  next message, and bounds two-phase exchanges with per-exchange
  timeouts.
* **Fault schedules**: :class:`FaultSpec` and :class:`FaultPlan`, the
  seeded per-frame fates of the chaos transport.  The transport itself
  (``ChaosTransport``) is ROADMAP.md queue 1 item 9b.
* **Checkpoint-resume**: ``repro_torch.checkpoint`` and
  ``FLRunConfig(checkpoint_path=..., checkpoint_every=k, resume=True)``,
  through every runtime and the server.
"""
from repro_torch.resilience.faults import FaultPlan, FaultSpec, RetryPolicy

__all__ = ["FaultPlan", "FaultSpec", "RetryPolicy"]
