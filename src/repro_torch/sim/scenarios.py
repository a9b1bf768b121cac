"""The scenario zoo — named ``ScenarioConfig`` presets.

``get_scenario(name)`` is what ``FLRunConfig(scenario="...")`` resolves
through; ``register_scenario`` adds new presets (third-party names must
not collide; registering before use from anywhere is fine).  Each preset
returns a FRESH ScenarioConfig copy so callers may mutate kwargs without
poisoning the registry.

* ``default``       — today's simulation exactly: paper-testbed compute,
  no network cost, always-on clients (bit-exact with scenario=None)
* ``paper_testbed`` — the paper's §IV-A devices on a home LAN: same
  compute, 40/100 Mbit links with 2 ms latency
* ``mobile_fleet``  — a lognormal phone fleet on cellular links (slow,
  heterogeneous, jittery uplink) with diurnal participation
* ``flaky_edge``    — heavy-tailed edge boxes on congested links with
  dropout and mid-round failure
* ``datacenter``    — a homogeneous fast fleet on 10 GbE: communication
  is (nearly) free, compute dominates
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.sim.registry import ScenarioConfig

_SCENARIOS: Dict[str, ScenarioConfig] = {}
_BUILTIN = set()


def register_scenario(cfg: ScenarioConfig) -> None:
    if cfg.name in _SCENARIOS and cfg.name not in _BUILTIN:
        raise ValueError(f"scenario {cfg.name!r} already registered")
    _SCENARIOS[cfg.name] = cfg
    _BUILTIN.discard(cfg.name)


def get_scenario(name: str) -> ScenarioConfig:
    if name not in _SCENARIOS:
        known = ", ".join(sorted(_SCENARIOS))
        raise ValueError(f"unknown scenario: {name!r}; "
                         f"registered scenarios: {known}")
    cfg = _SCENARIOS[name]
    return dataclasses.replace(
        cfg, compute_kw=dict(cfg.compute_kw), network_kw=dict(cfg.network_kw),
        availability_kw=dict(cfg.availability_kw))


def available_scenarios() -> tuple:
    return tuple(sorted(_SCENARIOS))


def _builtin(cfg: ScenarioConfig) -> None:
    _SCENARIOS[cfg.name] = cfg
    _BUILTIN.add(cfg.name)


_builtin(ScenarioConfig(name="default"))

_builtin(ScenarioConfig(
    name="paper_testbed",
    compute="paper_testbed",
    network="bandwidth",
    network_kw=dict(up_mbps=40.0, down_mbps=100.0, latency_s=0.002),
))

_builtin(ScenarioConfig(
    name="mobile_fleet",
    compute="lognormal_fleet",
    compute_kw=dict(median=2.5, spread=0.5),
    network="bandwidth",
    network_kw=dict(up_mbps=2.0, down_mbps=8.0, latency_s=0.05,
                    het=0.5, jitter=0.3),
    availability="diurnal",
    availability_kw=dict(duty=0.7, period=240.0),
))

_builtin(ScenarioConfig(
    name="flaky_edge",
    compute="pareto_fleet",
    compute_kw=dict(scale=1.5, alpha=1.5),
    network="bandwidth",
    network_kw=dict(up_mbps=5.0, down_mbps=20.0, latency_s=0.03,
                    het=0.3, jitter=0.5),
    availability="flaky",
    availability_kw=dict(p_drop=0.05, off_mean=30.0, p_fail=0.1),
))

_builtin(ScenarioConfig(
    name="datacenter",
    compute="uniform_fleet",
    compute_kw=dict(lo=0.9, hi=1.1, sigma=0.05),
    network="bandwidth",
    network_kw=dict(up_mbps=10000.0, down_mbps=10000.0, latency_s=1e-4),
))
