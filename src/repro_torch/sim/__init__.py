"""``repro_torch.sim`` — pluggable client-heterogeneity & byte-aware network
simulation.  A copy of ``repro.sim`` (numpy only), imports rewritten; the
parity tests (tests/test_torch_sim.py) keep it bit-identical to the
original (docs/SCENARIOS.md describes both).

A *scenario* is three models behind string registries, mirroring
``repro_torch.algorithms``:

* **compute** — per-client local-round service-time distributions
  (``repro_torch.sim.compute``)
* **network** — link delay computed from each event's *actual*
  compressed payload bytes (``repro_torch.sim.network``) — codecs couple to
  the simulated clock
* **availability** — dropout/rejoin, mid-round failure, diurnal
  participation (``repro_torch.sim.availability``)

Select one per run with ``FLRunConfig(scenario="mobile_fleet")`` /
``Federation(..., scenario=...)`` — a zoo name or an explicit
``ScenarioConfig``.  The default (``scenario=None`` or the all-defaults
config) reproduces pre-scenario runs bit-exactly.

All randomness is counter-based per (seed, stream, client, draw-index)
(``repro_torch.sim.base``): traces are invariant to engine scheduling order,
schedulers snapshot/restore as plain arrays, and byte-only ablations
(identity vs topk_int8) are exactly coupled draw-for-draw.
"""
from repro_torch.sim.base import (AlwaysOn, CounterModel, IdealNetwork,
                            exponential, normal, u01)
from repro_torch.sim.registry import (AVAILABILITY, COMPUTE, NETWORK,
                                ScenarioConfig, available_models,
                                build_model, register_availability,
                                register_compute, register_network)
from repro_torch.sim.scenarios import (available_scenarios, get_scenario,
                                 register_scenario)


def resolve_scenario(scenario):
    """Normalise a ``scenario=`` knob: None passes through, a string is
    looked up in the zoo, a ScenarioConfig is validated.  This is what
    ``FLRunConfig.__post_init__`` calls."""
    if scenario is None:
        return None
    if isinstance(scenario, str):
        return get_scenario(scenario)
    if isinstance(scenario, ScenarioConfig):
        return scenario.validate()
    raise ValueError(
        "scenario must be None, a registered scenario name, or a "
        f"repro_torch.sim.ScenarioConfig; got {scenario!r}")


__all__ = [
    "AVAILABILITY", "COMPUTE", "NETWORK", "AlwaysOn", "CounterModel",
    "IdealNetwork", "ScenarioConfig", "available_models",
    "available_scenarios", "build_model", "exponential", "get_scenario",
    "normal", "register_availability", "register_compute",
    "register_network", "register_scenario", "resolve_scenario", "u01",
]
