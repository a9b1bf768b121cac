"""String registries for the three scenario-model kinds + ScenarioConfig.

Mirrors ``repro_torch.algorithms.registry``: builtin factories are registered
lazily on first lookup, third-party registrations made *before* the
builtin load win (a deliberate override survives), and an unknown name
fails loudly listing what is registered.

A factory has the signature ``factory(num_clients, seed, **kw) -> model``
and returns an object satisfying the matching protocol in
``repro_torch.sim.base``.  Models built from factories whose product carries
``active = False`` (the ``ideal`` network, ``always_on`` availability)
cost nothing: the scheduler treats them as absent and stays on the
bit-exact default arithmetic.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict

COMPUTE, NETWORK, AVAILABILITY = "compute", "network", "availability"

_REGISTRIES: Dict[str, Dict[str, Callable]] = {
    COMPUTE: {}, NETWORK: {}, AVAILABILITY: {}}
_BUILTIN_OWNED = {COMPUTE: set(), NETWORK: set(), AVAILABILITY: set()}
_builtins_loaded = False


def _load_builtins():
    global _builtins_loaded
    if _builtins_loaded:
        return
    _builtins_loaded = True
    from repro_torch.sim import availability as av
    from repro_torch.sim import compute as cp
    from repro_torch.sim import network as nw
    builtin = {
        COMPUTE: {"paper_testbed": cp.paper_testbed,
                  "uniform_fleet": cp.uniform_fleet,
                  "lognormal_fleet": cp.lognormal_fleet,
                  "pareto_fleet": cp.pareto_fleet,
                  "device_classes": cp.device_classes,
                  "time_varying": cp.time_varying},
        NETWORK: {"ideal": nw.ideal, "bandwidth": nw.bandwidth},
        AVAILABILITY: {"always_on": av.always_on, "dropout": av.dropout,
                       "flaky": av.flaky, "diurnal": av.diurnal},
    }
    for kind, entries in builtin.items():
        for name, factory in entries.items():
            if name not in _REGISTRIES[kind]:   # pre-registration wins
                _REGISTRIES[kind][name] = factory
                _BUILTIN_OWNED[kind].add(name)


def _register(kind: str, name: str, factory: Callable) -> None:
    _load_builtins()
    if name in _REGISTRIES[kind] and name not in _BUILTIN_OWNED[kind]:
        raise ValueError(f"{kind} model {name!r} already registered")
    _REGISTRIES[kind][name] = factory
    _BUILTIN_OWNED[kind].discard(name)


def register_compute(name: str, factory: Callable) -> None:
    _register(COMPUTE, name, factory)


def register_network(name: str, factory: Callable) -> None:
    _register(NETWORK, name, factory)


def register_availability(name: str, factory: Callable) -> None:
    _register(AVAILABILITY, name, factory)


def _get(kind: str, name: str) -> Callable:
    _load_builtins()
    if name not in _REGISTRIES[kind]:
        known = ", ".join(sorted(_REGISTRIES[kind]))
        raise ValueError(f"unknown {kind} model: {name!r}; "
                         f"registered {kind} models: {known}")
    return _REGISTRIES[kind][name]


def available_models(kind: str) -> tuple:
    _load_builtins()
    return tuple(sorted(_REGISTRIES[kind]))


def build_model(kind: str, name: str, num_clients: int, seed: int = 0,
                **kw):
    return _get(kind, name)(num_clients, seed, **kw)


@dataclass
class ScenarioConfig:
    """One simulation scenario: a compute fleet, a network, an
    availability pattern — each a registered model name plus kwargs.
    The all-defaults config IS today's simulation (paper-testbed
    compute, ideal network, always-on clients) and reproduces
    ``scenario=None`` runs bit-exactly."""
    name: str = "custom"
    compute: str = "paper_testbed"
    compute_kw: dict = field(default_factory=dict)
    network: str = "ideal"
    network_kw: dict = field(default_factory=dict)
    availability: str = "always_on"
    availability_kw: dict = field(default_factory=dict)

    def build(self, num_clients: int, seed: int = 0):
        """Instantiate the three models for one run: ``(compute,
        network, availability)``.  Validates all three names (an unknown
        one raises listing the registered names)."""
        c = build_model(COMPUTE, self.compute, num_clients, seed,
                        **self.compute_kw)
        n = build_model(NETWORK, self.network, num_clients, seed,
                        **self.network_kw)
        a = build_model(AVAILABILITY, self.availability, num_clients, seed,
                        **self.availability_kw)
        return c, n, a

    def is_default(self) -> bool:
        """True when this config IS the pre-scenario world: paper-testbed
        compute with no overrides, free network, always-on clients.  The
        runtimes treat such a config exactly like ``scenario=None`` — in
        particular the round-based runtime keeps its round-index time
        axis — so the documented bit-exactness holds by construction."""
        return (self.compute == "paper_testbed" and not self.compute_kw
                and self.network == "ideal"
                and self.availability == "always_on")

    def validate(self) -> "ScenarioConfig":
        """Fail fast on unknown model names (used by FLRunConfig so a
        typo surfaces at construction, not deep inside a runtime)."""
        for kind, name in ((COMPUTE, self.compute), (NETWORK, self.network),
                           (AVAILABILITY, self.availability)):
            _get(kind, name)
        return self
