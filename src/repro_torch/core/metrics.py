"""FL experiment metrics: communication accounting (the paper's headline
numbers), CCR (Eq. 4) as a count ratio and a byte-accurate ratio,
accuracy tracking, time-to-accuracy.  Port of ``repro.core.metrics``
(framework-free)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class CommStats:
    """Communication accounting.  The paper's 'communication times' = model
    uploads; scalar V reports are tracked separately (they are what VAFL
    trades the heavy uploads for).  When a codec is active the runtimes
    pass actual payload sizes via ``nbytes``; otherwise a transfer costs
    the full fp32 model (``model_bytes``).

    **The uplink ledger, in one place** (everything else cross-checks
    against this — tests/test_obs.py):

        uplink_bytes == upload_payload_bytes + scalar_report_bytes

    ``upload_payload_bytes`` intentionally EXCLUDES the scalar V
    reports: it is the codec-compressible model traffic ``byte_ccr``
    measures, while ``uplink_bytes`` is everything on the wire.  The
    per-client ledgers (``RunResult.client_uplink_bytes`` /
    ``client_downlink_bytes``) reconcile as: event-driven runtimes
    attribute ALL uplink bytes (reports included) to the reporting
    client, so their sum equals ``uplink_bytes``; the round-based and
    sync-barrier runtimes attribute only upload payloads (a whole
    round's reports are recorded in one bulk call with no per-client
    split), so their sum equals ``upload_payload_bytes``."""
    model_uploads: int = 0
    scalar_reports: int = 0
    broadcasts: int = 0
    model_bytes: int = 0          # bytes per *uncompressed* model transfer
    uplink_bytes: int = 0
    downlink_bytes: int = 0
    upload_payload_bytes: int = 0     # actual on-the-wire upload bytes
    scalar_report_bytes: int = 0      # wire bytes of the scalar V reports

    def record_upload(self, n: int = 1, nbytes: Optional[int] = None):
        """n uploads costing ``nbytes`` total (full models when None)."""
        self.model_uploads += n
        b = n * self.model_bytes if nbytes is None else int(nbytes)
        self.uplink_bytes += b
        self.upload_payload_bytes += b

    def record_report(self, n: int = 1):
        self.scalar_reports += n
        self.scalar_report_bytes += n * 4  # one fp32 scalar each
        self.uplink_bytes += n * 4

    def record_broadcast(self, n: int = 1, nbytes: Optional[int] = None):
        self.broadcasts += n
        b = n * self.model_bytes if nbytes is None else int(nbytes)
        self.downlink_bytes += b

    @property
    def broadcast_payload_bytes(self) -> int:
        """Actual on-the-wire broadcast bytes.  Alias: the downlink carries
        nothing but model broadcasts (unlike the uplink, where
        upload_payload_bytes excludes the scalar V reports)."""
        return self.downlink_bytes

    @property
    def total_wire_bytes(self) -> int:
        """Everything on the wire, both directions: upload payloads +
        scalar reports + broadcasts."""
        return self.uplink_bytes + self.downlink_bytes

    @property
    def byte_ccr(self) -> float:
        """Eq. 4 on bytes *within* this run: 1 - (payload bytes on the
        wire) / (bytes the same uploads would cost uncompressed).  0 for
        identity; composes with the cross-run count CCR (gating)."""
        full = self.model_uploads * self.model_bytes
        return ccr(full, self.upload_payload_bytes)


def ccr(c_t0: float, c_t1: float) -> float:
    """Eq. 4: communication compression rate (C_t0 - C_t1)/C_t0.
    C_t0 = communications before compression (the AFL baseline),
    C_t1 = after (the gated algorithm)."""
    if c_t0 <= 0:
        return 0.0
    return (c_t0 - c_t1) / c_t0


@dataclass
class RoundRecord:
    round: int
    time: float
    global_acc: float
    uploads_so_far: int
    selected: List[int] = field(default_factory=list)
    values: Optional[List[float]] = None
    client_accs: Optional[List[float]] = None
    # how many events_per_eval boundaries this record spans.  The batched
    # engine evaluates at WINDOW granularity: when a window covers w > epe
    # events, the boundaries that fell inside it collapse into one record
    # with boundaries_crossed > 1 (the per-boundary globals between two
    # mix points are not materialised).  Sequential/round runtimes always
    # record exactly one boundary per record.
    boundaries_crossed: int = 1


@dataclass
class RunResult:
    algorithm: str
    records: List[RoundRecord]
    comm: CommStats
    target_acc: float
    uploads_to_target: Optional[int] = None   # comm times when target first hit
    rounds_to_target: Optional[int] = None
    time_to_target: Optional[float] = None
    # mean per-client fraction of simulated wall-clock spent idle — set by
    # the wall-clock runtimes (event-driven + sync barrier), None for the
    # round-based runtime where no clock is simulated
    idle_fraction: Optional[float] = None
    # scenario-aware simulation surface (repro.sim, docs/SCENARIOS.md).
    # Set by every runtime that simulates a clock; the round-based runtime
    # fills them only under an active scenario= (otherwise its "time" is
    # the round index, as before).  Bytes are the actual on-the-wire
    # payloads attributed per client (uplink includes scalar V reports in
    # event mode); failed_rounds counts mid-round failures whose work an
    # availability model discarded.
    sim_time: Optional[float] = None                   # final simulated clock
    client_idle: Optional[List[float]] = None          # per-client idle frac
    client_uplink_bytes: Optional[List[int]] = None
    client_downlink_bytes: Optional[List[int]] = None
    client_failed_rounds: Optional[List[int]] = None
    # observability surface (repro_torch.obs, docs/OBSERVABILITY.md) —
    # set by Observer.finish when the run had obs enabled: ``trace_path``
    # is the exported trace file (JSONL or Chrome trace_event JSON),
    # ``metrics`` the registry snapshot ({"counters": ..., "gauges":
    # ..., "histograms": ...}, including the jit_compiles gauge).
    trace_path: Optional[str] = None
    metrics: Optional[dict] = None

    @property
    def best_acc(self) -> float:
        return max((r.global_acc for r in self.records), default=0.0)

    @property
    def byte_ccr(self) -> float:
        """Within-run byte compression of the upload path (codec effect)."""
        return self.comm.byte_ccr

    def to_summary(self) -> dict:
        """The run as one JSON-ready dict (the Table III harness's per-run
        numbers, ``repro_torch.bench.fl_common.table3_row``)."""
        c = self.comm
        # scalar percentiles from the pow2 histograms (repro_torch.obs)
        # where a caller wants one number, not a bucket dict; None when
        # the run had obs off or never touched the histogram
        from repro_torch.obs.metrics import snapshot_percentile
        hists = (self.metrics or {}).get("histograms", {})
        return {
            "algorithm": self.algorithm,
            "target_acc": self.target_acc,
            "best_acc": round(self.best_acc, 4),
            "records": len(self.records),
            "uploads": c.model_uploads,
            "scalar_reports": c.scalar_reports,
            "broadcasts": c.broadcasts,
            "uplink_mb": round(c.uplink_bytes / 1e6, 3),
            "downlink_mb": round(c.downlink_bytes / 1e6, 3),
            "total_wire_mb": round(c.total_wire_bytes / 1e6, 3),
            "byte_ccr": round(self.byte_ccr, 4),
            "uploads_to_target": self.uploads_to_target,
            "rounds_to_target": self.rounds_to_target,
            "time_to_target": self.time_to_target,
            "sim_time": self.sim_time,
            "mean_idle": (None if self.idle_fraction is None
                          else round(self.idle_fraction, 4)),
            "failed_rounds": (None if self.client_failed_rounds is None
                              else int(sum(self.client_failed_rounds))),
            "staleness_p95": snapshot_percentile(hists.get("staleness"), 95),
            "queue_depth_p95": snapshot_percentile(hists.get("queue_depth"), 95),
            "commit_latency_ms_p95": snapshot_percentile(hists.get("commit_latency_ms"), 95),
            "trace_path": self.trace_path,
        }

    def finalize_target(self):
        for r in self.records:
            if r.global_acc >= self.target_acc:
                self.uploads_to_target = r.uploads_so_far
                self.rounds_to_target = r.round
                self.time_to_target = r.time
                break
        return self
