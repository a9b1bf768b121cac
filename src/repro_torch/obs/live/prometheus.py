"""Prometheus text exposition over ``MetricsRegistry`` snapshots.  Copy
of ``repro.obs.live.prometheus``: its text is byte-equal to the
reference's for the same snapshot, metric names (``repro_``) included.

Renders the version-0.0.4 text format any Prometheus-compatible scraper
ingests: counters become ``repro_<name>_total``, gauges ``repro_<name>``,
and the pow2 histograms become a full histogram family
(``_bucket{le="2^k"}`` cumulative counts, ``+Inf``, ``_sum``,
``_count``) plus derived ``_p50``/``_p95``/``_p99`` gauges from the
bucket interpolation in :func:`repro_torch.obs.metrics.snapshot_percentile` —
the quantile surface dashboards actually plot.

``sources`` is a list of ``(labels, snapshot)`` pairs so one endpoint
serves many federations (``MultiTenantServer`` passes a ``tenant``
label per server); HELP/TYPE headers are emitted once per family across
all sources, as the format requires.  Per-client data deliberately has
NO place here: it belongs in the ``/clients`` scoreboard.
"""
from __future__ import annotations

import math
import re

from repro_torch.obs.metrics import snapshot_percentile

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")
_PERCENTILES = ((50, "_p50"), (95, "_p95"), (99, "_p99"))


def metric_name(name: str, suffix: str = "") -> str:
    """Sanitise a registry name into the exposition charset, with the
    ``repro_`` namespace prefix."""
    return "repro_" + _NAME_OK.sub("_", name) + suffix


def escape_label_value(v: str) -> str:
    """Label-value escaping per the exposition format: backslash, the
    double quote and newline."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def format_labels(labels: dict, extra: dict = None) -> str:
    """``{k="v",...}`` (sorted, escaped), or "" when there are none."""
    merged = dict(labels or {})
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(f'{k}="{escape_label_value(v)}"'
                     for k, v in sorted(merged.items()))
    return "{" + inner + "}"


def _num(v) -> str:
    v = float(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _header(lines, emitted, fam: str, kind: str, help_: str) -> None:
    if fam not in emitted:
        lines.append(f"# HELP {fam} {help_}")
        lines.append(f"# TYPE {fam} {kind}")
        emitted.add(fam)


def render_prometheus(sources, *, rates: dict = None) -> str:
    """The whole exposition: every source's counters, gauges and
    histograms, plus (optionally) ``rates`` — {labels_key: {name:
    per_sec}} keyed by each source's index — as a shared
    ``repro_counter_rate`` gauge family tagged ``metric="<name>"``
    (names come from the registry, a bounded set)."""
    lines: list = []
    emitted: set = set()
    for idx, (labels, snap) in enumerate(sources):
        for name, v in snap.get("counters", {}).items():
            fam = metric_name(name, "_total")
            _header(lines, emitted, fam, "counter",
                    f"repro.obs counter {name}")
            lines.append(f"{fam}{format_labels(labels)} {_num(v)}")
        for name, v in snap.get("gauges", {}).items():
            if v is None:
                continue
            fam = metric_name(name)
            _header(lines, emitted, fam, "gauge",
                    f"repro.obs gauge {name}")
            lines.append(f"{fam}{format_labels(labels)} {_num(v)}")
        for name, h in snap.get("histograms", {}).items():
            fam = metric_name(name)
            _header(lines, emitted, fam, "histogram",
                    f"repro.obs pow2 histogram {name}")
            cum = 0
            bk = {int(k): v for k, v in h["buckets"].items()}
            for k in sorted(bk):
                cum += bk[k]
                le = _num(2 ** k if k > 0 else 1)
                lines.append(f"{fam}_bucket"
                             f"{format_labels(labels, {'le': le})} {cum}")
            lines.append(f"{fam}_bucket"
                         f"{format_labels(labels, {'le': '+Inf'})} "
                         f"{h['count']}")
            lines.append(f"{fam}_sum{format_labels(labels)} "
                         f"{_num(h['sum'])}")
            lines.append(f"{fam}_count{format_labels(labels)} "
                         f"{h['count']}")
            for q, suffix in _PERCENTILES:
                p = snapshot_percentile(h, q)
                if p is None:
                    continue
                pf = metric_name(name, suffix)
                _header(lines, emitted, pf, "gauge",
                        f"p{q} of {name} (pow2-bucket interpolation)")
                lines.append(f"{pf}{format_labels(labels)} {_num(p)}")
        src_rates = (rates or {}).get(idx) or {}
        for name, per_sec in sorted(src_rates.items()):
            fam = "repro_counter_rate"
            _header(lines, emitted, fam, "gauge",
                    "per-second counter movement over the sampler's "
                    "latest window")
            lines.append(f"{fam}"
                         f"{format_labels(labels, {'metric': name})} "
                         f"{_num(round(per_sec, 6))}")
    return "\n".join(lines) + "\n"
