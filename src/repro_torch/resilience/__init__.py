"""``repro_torch.resilience``: surviving lost frames, dead clients and
preemption.  Port of ``repro.resilience``.

* **Fault injection**: :class:`ChaosTransport` (the builtin transport
  ``"chaos"``) wraps any inner transport and applies a seeded,
  counter-based :class:`FaultSpec` schedule (:class:`FaultPlan`): drop,
  duplicate, reorder, delay and corrupt frames, connection resets,
  client blackouts mid-exchange.  Every failure reproduces from its seed.
* **Retry + idempotency**: :class:`RetryPolicy` drives client-side
  re-sends (exponential backoff, seeded jitter, same ``seq``); the
  ``FLServer`` dedups by ``(client, seq)`` and replays its cached reply,
  evicts silent clients on liveness deadlines, re-admits them on their
  next message, and bounds two-phase exchanges with per-exchange
  timeouts.
* **Checkpoint-resume**: ``repro_torch.checkpoint`` and
  ``FLRunConfig(checkpoint_path=..., checkpoint_every=k, resume=True)``,
  through every runtime and the server.
"""
from repro_torch.resilience.chaos import ChaosTransport
from repro_torch.resilience.faults import FaultPlan, FaultSpec, RetryPolicy

__all__ = ["ChaosTransport", "FaultPlan", "FaultSpec", "RetryPolicy"]
