"""Per-client error-feedback state for lossy update compression.  Port
of ``repro.compress.error_feedback``.

SGD-EF: the client keeps the residual e_i = (what it wanted to send) -
(what the codec delivered) and folds it into its next update before
encoding, so dropped mass is delayed, not lost.  In this single-process
simulation the runtime owns one ErrorFeedback per run, keyed by client.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.common.pytree import tree_add, tree_sub
from repro_torch.compress.base import Codec


class ErrorFeedback:
    """Residual accumulator: apply() folds e_i in, update() re-derives it."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.residuals: Dict[int, object] = {}

    def apply(self, cid: int, tree):
        """update + residual (identity when disabled or first transfer)."""
        if not self.enabled or cid not in self.residuals:
            return tree
        return tree_add(tree, self.residuals[cid])

    def update(self, cid: int, target, decoded):
        """Store e_i = target - decoded for the client's next transfer."""
        if self.enabled:
            self.residuals[cid] = tree_sub(target, decoded)


def compress_update(codec: Codec, ef: ErrorFeedback, cid: int, tree, *, seed: int = 0):
    """One client->server transfer: EF-corrected encode + server decode.
    Returns (payload, decoded) with ef already advanced."""
    target = ef.apply(cid, tree)
    payload = codec.encode(target, seed=seed)
    decoded = codec.decode(payload)
    ef.update(cid, target, decoded)
    return payload, decoded
