"""Collectives across processes: the value-gated aggregation of VAFL
(``gated``) on ``torch.distributed``, and a counter of the collectives it
issues (``hlo``).  Port of the gated part of ``repro.distributed``;
``sharding`` (mesh layouts) waits (ROADMAP.md §1 item 10)."""
