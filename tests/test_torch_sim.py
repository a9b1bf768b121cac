"""repro_torch's copies of the scheduler and the scenario simulator,
against repro's on the CPU.

Both are numpy only, and the port's are copies with their imports
rewritten: driven with the same draws and byte counts, they must agree
exactly (pop order, times, idle fractions, byte ledgers, failed rounds,
snapshots), on the default scheduler and on all five zoo scenarios.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.sim as jsim  # noqa: E402
from repro.core import scheduler as jsched  # noqa: E402
import repro_torch.sim as tsim  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402

N, SEED, POPS = 7, 3, 200
SCENARIOS = [None, "default", "paper_testbed", "mobile_fleet", "flaky_edge", "datacenter"]
UP, DOWN = 48_431, 170_792     # a topk0.1_int8 upload and an fp32 broadcast of the CNN


def build(sim, sched_mod, scenario, seed=SEED):
    """One package's scheduler for ``scenario`` (None: the paper testbed,
    no network or availability model)."""
    if scenario is None:
        return sched_mod.EventScheduler(N, sched_mod.SpeedModel.paper_testbed(N, seed))
    compute, net, avail = sim.get_scenario(scenario).build(N, seed)
    return sched_mod.EventScheduler(N, compute, network=net, availability=avail)


def drive(sched, pops, start=0):
    """``pops`` pop/reschedule cycles with byte counts that vary by
    event; the trace of (time, client) pairs."""
    trace = []
    for k in range(start, start + pops):
        t, c = sched.pop()
        trace.append((t, c))
        sched.schedule(c, upload_bytes=UP + 17 * (k % 5), download_bytes=DOWN)
    return trace


def ledger(sched):
    return (sched.now, sched.idle_fraction().tolist(), sched.client_busy_time.tolist(),
            sched.client_net_delay.tolist(), sched.client_up_bytes.tolist(),
            sched.client_down_bytes.tolist(), sched.client_failed_rounds.tolist())


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_scheduler_matches_reference(scenario):
    ref, port = build(jsim, jsched, scenario), build(tsim, tsched, scenario)
    assert drive(port, POPS) == drive(ref, POPS)
    assert ledger(port) == ledger(ref)
    if scenario == "flaky_edge":
        assert sum(port.client_failed_rounds) > 0     # the availability model acted


def _flat(state):
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in _flat(v).items()})
        else:
            out[k] = np.asarray(v).tolist()
    return out


@pytest.mark.parametrize("scenario", [None, "mobile_fleet", "flaky_edge"])
def test_snapshot_restore_round_trips(scenario):
    """A snapshot equals the reference's, and restoring it into a fresh
    scheduler continues exactly where the original went on."""
    ref, port = build(jsim, jsched, scenario), build(tsim, tsched, scenario)
    drive(ref, 100)
    drive(port, 100)
    snap = port.snapshot()
    assert _flat(snap) == _flat(ref.snapshot())
    ahead = drive(port, 100, start=100)
    fresh = build(tsim, tsched, scenario).restore(snap)
    assert drive(fresh, 100, start=100) == ahead
    assert ledger(fresh) == ledger(port)


@pytest.mark.parametrize("name", ["paper_testbed", "uniform_fleet", "lognormal_fleet",
                                  "pareto_fleet", "device_classes", "time_varying"])
def test_compute_models_match_reference(name):
    ref = jsim.build_model(jsim.COMPUTE, name, N, SEED)
    port = tsim.build_model(tsim.COMPUTE, name, N, SEED)
    np.testing.assert_array_equal(port.base, ref.base)
    draws = [(c, 37.5 * k) for k in range(5) for c in range(N)]
    assert [port.sample(c, t) for c, t in draws] == [ref.sample(c, t) for c, t in draws]


def test_counter_streams_match_reference():
    args = [(s, st, c, k) for s in (0, 7, 2 ** 40) for st in (1, 4) for c in (0, 5) for k in (0, 9)]
    for fn in ("u01", "normal", "exponential"):
        assert ([getattr(tsim, fn)(*a) for a in args]
                == [getattr(jsim, fn)(*a) for a in args]), fn


def test_scenario_zoo_and_resolution():
    assert tsim.available_scenarios() == jsim.available_scenarios()
    for kind in (tsim.COMPUTE, tsim.NETWORK, tsim.AVAILABILITY):
        assert tsim.available_models(kind) == jsim.available_models(kind)
    for name in tsim.available_scenarios():
        assert vars(tsim.get_scenario(name)) == vars(jsim.get_scenario(name))
    assert tsim.get_scenario("default").is_default()
    assert not tsim.get_scenario("paper_testbed").is_default()
    cfg = tsim.get_scenario("mobile_fleet")
    cfg.network_kw["up_mbps"] = 1.0              # a fresh copy: the zoo is untouched
    assert tsim.get_scenario("mobile_fleet").network_kw["up_mbps"] == 2.0
    assert tsim.resolve_scenario(None) is None
    assert tsim.resolve_scenario("datacenter").name == "datacenter"
    with pytest.raises(ValueError, match="registered scenarios"):
        tsim.resolve_scenario("moon_base")
    with pytest.raises(ValueError, match="registered compute models"):
        tsim.ScenarioConfig(compute="abacus").validate()
    with pytest.raises(ValueError):
        tsim.resolve_scenario(3)
