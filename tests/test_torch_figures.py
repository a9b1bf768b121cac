"""The paper's other figures and the FL entry points on repro_torch,
against repro on the CPU.

* ``repro_torch.core.server``'s back-compat names, and ``ALGORITHMS`` as
  a live view of the registry (a late registration shows up).
* The Fig. 4 and Fig. 5/6 harnesses and the value ablation print the
  reference's CSV header, and rows of its shape, at a tiny
  ``BenchScale`` (the numbers are torch's own RNG, not the reference's).
* Each stacked ablation variant against the reference's
  ``variant_backend`` on the same trees: ``full``, ``no_acc`` and
  ``no_diff`` to rtol 1e-5; ``random`` in [0, 1) and reproducible from
  its seed.
* ``repro_torch.examples.quickstart`` and ``fl_mnist_vafl`` run at
  ``--rounds 2 --samples 100 --device cpu``.
"""
import io
import re
import runpy
import sys
from contextlib import redirect_stdout

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs a test process per core

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from benchmarks import ablation_value as jablation  # noqa: E402
from benchmarks import fig4_convergence as jfig4, fig5_clients as jfig5  # noqa: E402
from benchmarks.fl_common import BenchScale as JScale  # noqa: E402
from repro_torch.algorithms import Algorithm, UploadPolicy  # noqa: E402
from repro_torch.algorithms import registry as treg  # noqa: E402
from repro_torch.bench import ablation_value, fig4_convergence, fig5_clients  # noqa: E402
from repro_torch.bench.fl_common import BenchScale  # noqa: E402

TINY = dict(samples_per_client=40, rounds=2, test_samples=60)


def _csv(fn, *args, **kwargs):
    """What ``fn`` prints, as lists of fields, and its return value."""
    out = io.StringIO()
    with redirect_stdout(out):
        ret = fn(*args, **kwargs)
    return [line.split(",") for line in out.getvalue().splitlines()], ret


def _shape(rows, numeric):
    """A CSV's header, and each row with its ``numeric`` columns replaced
    by the kind of number they hold."""
    def kind(v):
        if re.fullmatch(r"-?\d+", v):
            return "int"
        assert re.fullmatch(r"-?\d+\.\d+", v), v
        return "float"
    return [rows[0]] + [[kind(v) if j in numeric else v for j, v in enumerate(r)]
                        for r in rows[1:]]


# ----------------------------------------------------- back-compat names ---

def test_core_server_names():
    import repro_torch.core as core
    from repro_torch.core import server
    from repro_torch.core.config import FLRunConfig
    from repro_torch.core.runtimes import run_event_driven, run_round_based
    assert server.FLRunConfig is FLRunConfig
    assert server.run_event_driven is run_event_driven
    assert server.run_round_based is run_round_based
    assert server.available_algorithms is treg.available_algorithms
    assert set(server.__all__) == {"ALGORITHMS", "FLRunConfig", "run_event_driven",
                                   "run_round_based", "available_algorithms"}
    assert server.ALGORITHMS == core.ALGORITHMS == treg.available_algorithms()
    assert server.ALGORITHMS[:4] == ("afl", "vafl", "eaflm", "fedavg")
    with pytest.raises(AttributeError):
        server.NOT_A_NAME


def test_algorithms_view_tracks_a_late_registration():
    import repro_torch.core as core
    from repro_torch.core import server
    assert "x-late" not in server.ALGORITHMS
    treg.register_algorithm(Algorithm(name="x-late", policy_factory=lambda cfg: UploadPolicy()))
    try:
        assert server.ALGORITHMS[-1] == "x-late" and core.ALGORITHMS[-1] == "x-late"
    finally:
        del treg._REGISTRY["x-late"]
    assert "x-late" not in core.ALGORITHMS


# -------------------------------------------------------------- harnesses ---

def test_fig4_csv_matches_reference():
    want, _ = _csv(jfig4.run, scale=JScale(**TINY), experiments=["a"])
    got, curves = _csv(fig4_convergence.run, scale=BenchScale(**TINY), experiments=["a"],
                       device="cpu")
    assert got[0] == ["experiment", "algorithm", "round", "acc"]
    assert _shape(got, {3}) == _shape(want, {3})
    assert all(0.0 <= acc <= 1.0 for c in curves.values() for _, acc in c)


def test_fig5_csv_matches_reference():
    want, _ = _csv(jfig5.run, scale=JScale(**TINY), experiments=["c"])
    got, _ = _csv(fig5_clients.run, scale=BenchScale(**TINY), experiments=["c"], device="cpu")
    assert got[0] == ["experiment", "round", "client", "acc"]
    assert _shape(got, {3}) == _shape(want, {3})
    assert [r[2] for r in got[1:]].count("-1") == TINY["rounds"]


def test_ablation_csv_matches_reference():
    scale = dict(TINY, target_acc=0.94)
    want, _ = _csv(jablation.run, "a", JScale(**scale))
    got, rows = _csv(ablation_value.run, "a", BenchScale(**scale), device="cpu")
    assert got[0] == ["experiment", "variant", "comm_times", "best_acc", "ccr_vs_afl"]
    assert _shape(got, {2, 3, 4}) == _shape(want, {2, 3, 4})
    assert [r[0] for r in rows] == ["full", "no_acc", "no_diff", "random", "strong_acc"]


def test_ablation_corrupt_clients_runs():
    got, rows = _csv(ablation_value.run, "a", BenchScale(**dict(TINY, rounds=1)),
                     corrupt_clients=1, device="cpu")
    assert len(got) == 7 and len(rows) == 5


# ---------------------------------------------------- stacked variants ---

def _trees(w=3, seed=0):
    rng = np.random.RandomState(seed)
    shapes = [(6, 5), (5,), (2, 3, 4)]
    return [{f"p{j}": rng.randn(w, *s).astype(np.float32) for j, s in enumerate(shapes)}
            for _ in range(2)]


@pytest.mark.parametrize("kind", ["full", "no_acc", "no_diff"])
def test_ablation_variant_matches_reference(kind):
    gp, gc = _trees()
    want = [float(jablation.variant_backend(kind)(
        {k: jnp.asarray(v[w]) for k, v in gp.items()},
        {k: jnp.asarray(v[w]) for k, v in gc.items()})) for w in range(3)]
    got = ablation_value.variant_backend(kind)(
        {k: torch.from_numpy(v) for k, v in gp.items()},
        {k: torch.from_numpy(v) for k, v in gc.items()})
    assert got.shape == (3,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), rtol=1e-5)


def test_ablation_random_variant_is_seeded_uniform():
    gp, gc = ({k: torch.from_numpy(v) for k, v in t.items()} for t in _trees(w=5))
    a, b, c = (ablation_value.variant_backend("random", seed=s) for s in (3, 3, 4))
    draws_a = torch.cat([a(gp, gc) for _ in range(40)])
    draws_b = torch.cat([b(gp, gc) for _ in range(40)])
    assert draws_a.shape == (200,) and draws_a.dtype == torch.float32
    assert float(draws_a.min()) >= 0.0 and float(draws_a.max()) < 1.0
    assert torch.equal(draws_a, draws_b)
    assert not torch.equal(draws_a[:5], c(gp, gc))
    assert 0.3 < float(draws_a.mean()) < 0.7


def test_ablation_unknown_variant():
    with pytest.raises(ValueError):
        ablation_value.variant_backend("nope")


# --------------------------------------------------------------- examples ---

@pytest.mark.parametrize("name", ["quickstart", "fl_mnist_vafl"])
def test_example_runs_on_the_cpu(name, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name, "--rounds", "2", "--samples", "100",
                                      "--device", "cpu"])
    out = io.StringIO()
    with redirect_stdout(out):
        runpy.run_module(f"repro_torch.examples.{name}", run_name="__main__")
    text = out.getvalue()
    if name == "quickstart":
        assert "best Acc" in text and "scalar V reports" in text and "sim wall-clock" in text
    else:
        summary = text.split("=== summary (experiment d, scaled) ===")[1].splitlines()
        assert [line.split()[0] for line in summary[2:5]] == ["afl", "eaflm", "vafl"]
