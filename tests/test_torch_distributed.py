"""repro_torch.distributed (the value-gated collective on
torch.distributed, and its collective counter) against
repro.distributed.gated.

Four gloo ranks on the CPU (spawned processes, rendezvous through a
``file://`` store in ``tmp_path``, never a fixed port) run the port's
gated aggregation; the reference's ``make_gated_allreduce`` runs on four
placeholder host devices in a subprocess, as tests/test_distributed.py
runs it.  The selection and ``any_sel`` must be equal; the aggregate is
held to rtol 1e-6 (gloo's ring sums in another order than XLA's
all-reduce).  Cases: the reference test's 4.75 case cut to four pods
(pods 0, 3, 4, 5 of its eight), all-equal values, and random ones.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.distributed.gated import pod_values as jpod_values  # noqa: E402
from repro_torch.distributed import hlo  # noqa: E402
from repro_torch.distributed.gated import pod_values  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4


def cases():
    """name -> (updates: leaf -> (WORLD, ...) array, values (WORLD,), weights (WORLD,))."""
    rs = np.random.RandomState(0)
    rows = np.array([0.0, 3.0, 4.0, 5.0], np.float32)
    tree = lambda: {"b": rs.randn(WORLD, 7).astype(np.float32),
                    "w": rs.randn(WORLD, 3, 5).astype(np.float32)}
    return {
        "ref475": ({"w": (rows[:, None] * np.ones((WORLD, 3))).astype(np.float32)},
                   np.array([0.0, 0.0, 9.0, 9.0], np.float32),
                   np.array([1.0, 1.0, 1.0, 3.0], np.float32)),
        "equal": (tree(), np.full(WORLD, 2.5, np.float32),
                  np.array([1.0, 2.0, 3.0, 4.0], np.float32)),
        "random": (tree(), rs.rand(WORLD).astype(np.float32),
                   (rs.rand(WORLD) + 0.5).astype(np.float32)),
    }


PORT_RANK = textwrap.dedent("""
    import json, sys
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.distributed import hlo
    from repro_torch.distributed.gated import make_gated_allreduce, should_sync
    rank, world, init, cases_path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    fn = make_gated_allreduce()
    out = {}
    for name, (upd, vals, wts) in json.load(open(cases_path)).items():
        hlo.reset()
        tree = {k: torch.tensor(v[rank], dtype=torch.float32) for k, v in upd.items()}
        agg, sel, any_sel = fn(tree, torch.tensor(vals[rank]), torch.tensor(wts[rank]))
        out[name] = {"agg": {k: v.tolist() for k, v in agg.items()},
                     "sel": sel.tolist(), "any": bool(any_sel),
                     "counts": hlo.collective_counts(), "bytes": hlo.collective_bytes()}
        hlo.reset()
        out[name]["sync"] = should_sync(torch.tensor(vals[rank]))
        out[name]["sync_bytes"] = hlo.collective_bytes()
    dist.destroy_process_group()
    print(json.dumps(out))
""")

REF = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=%d"
    sys.path.insert(0, "src")
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.distributed.gated import make_gated_allreduce
    from repro.distributed.sharding import make_mesh
    mesh = make_mesh((%d,), ("pod",))
    out = {}
    for name, (upd, vals, wts) in json.load(open(sys.argv[1])).items():
        upd = {k: jnp.asarray(v, jnp.float32) for k, v in upd.items()}
        specs = {k: P(*([None] * (v.ndim - 1))) for k, v in upd.items()}
        fn = make_gated_allreduce(mesh, specs)
        agg, sel, any_sel = fn(upd, jnp.asarray(vals, jnp.float32), jnp.asarray(wts, jnp.float32))
        out[name] = {"agg": {k: np.asarray(v).tolist() for k, v in agg.items()},
                     "sel": np.asarray(sel).ravel().tolist(), "any": bool(any_sel)}
    print(json.dumps(out))
""") % (WORLD, WORLD)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's four ranks and the reference, each once, in parallel."""
    tmp = tmp_path_factory.mktemp("gated")
    cpath = tmp / "cases.json"
    cpath.write_text(json.dumps({n: ({k: v.tolist() for k, v in u.items()}, vals.tolist(),
                                     wts.tolist()) for n, (u, vals, wts) in cases().items()}))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    init = f"file://{tmp / 'rendezvous'}"
    procs = [subprocess.Popen([sys.executable, "-c", PORT_RANK, str(r), str(WORLD), init,
                               str(cpath)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    ref = subprocess.Popen([sys.executable, "-c", REF, str(cpath)], cwd=ROOT,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ranks = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
        ranks.append(json.loads(out.strip().splitlines()[-1]))
    out, err = ref.communicate(timeout=240)
    assert ref.returncode == 0, err[-3000:]
    return ranks, json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["ref475", "equal", "random"])
def test_selection_and_any_equal_reference(runs, name):
    ranks, ref = runs
    assert [r[name]["sel"][0] for r in ranks] == ref[name]["sel"]
    assert all(r[name]["any"] == ref[name]["any"] for r in ranks)


@pytest.mark.parametrize("name", ["ref475", "equal", "random"])
def test_aggregate_matches_reference_on_every_rank(runs, name):
    ranks, ref = runs
    for r in ranks:
        for k, want in ref[name]["agg"].items():
            np.testing.assert_allclose(np.asarray(r[name]["agg"][k], np.float32),
                                       np.asarray(want, np.float32), rtol=1e-6, atol=1e-7)


def test_reference_test_case_selects_the_above_mean_pods(runs):
    """tests/test_distributed.py's case cut to four pods: only the two
    pods at V = 9 aggregate, (4*1 + 5*3)/4 = 4.75."""
    ranks, _ = runs
    assert [r["ref475"]["sel"][0] for r in ranks] == [0.0, 0.0, 1.0, 1.0]
    for r in ranks:
        assert abs(r["ref475"]["agg"]["w"][0] - 4.75) < 1e-5 and r["ref475"]["any"]


def test_all_equal_values_select_every_rank(runs):
    ranks, _ = runs
    assert all(r["equal"]["sel"] == [1.0] for r in ranks)
    assert all(r["equal"]["sync"] for r in ranks)     # Algorithm 1's >=: all sync


def test_counter_counts_what_was_issued(runs):
    """One all-reduce of V (4 bytes), one of the weight (4 bytes), one a
    leaf of the update (its fp32 bytes): the V exchange is O(ranks)
    scalars against the update's O(params); should_sync two scalars."""
    ranks, _ = runs
    for name, (upd, _, _) in cases().items():
        leaf_bytes = sum(v[0].size * 4 for v in upd.values())
        for r in ranks:
            assert r[name]["counts"] == {"all-reduce": 2 + len(upd)}
            assert r[name]["bytes"] == {"all-reduce": 8 + leaf_bytes, "total": 8 + leaf_bytes}
            assert r[name]["sync_bytes"] == {"all-reduce": 8, "total": 8}


def test_counter_api():
    hlo.reset()
    assert hlo.collective_counts() == {} and hlo.collective_bytes() == {"total": 0}
    hlo.record("all-gather", 64)
    hlo.record("all-reduce", 8)
    hlo.record("all-reduce", 8)
    assert hlo.collective_counts() == {"all-gather": 1, "all-reduce": 2}
    assert hlo.collective_bytes() == {"all-gather": 64, "all-reduce": 16, "total": 80}
    with pytest.raises(ValueError):
        hlo.record("all-reduce-done", 8)
    hlo.reset()
    assert set(hlo.COLLECTIVES) == {"all-gather", "all-reduce", "reduce-scatter",
                                     "all-to-all", "collective-permute"}


@pytest.mark.parametrize("acc", [0.0, 0.37, 1.0])
def test_pod_values_match_reference(acc):
    rs = np.random.RandomState(3)
    a = {"w": rs.randn(6, 5).astype(np.float32), "b": [rs.randn(9).astype(np.float32)]}
    b = {"w": rs.randn(6, 5).astype(np.float32), "b": [rs.randn(9).astype(np.float32)]}
    got = pod_values(from_jax_params(a), from_jax_params(b), acc, 4)
    want = jpod_values(jax.tree.map(jnp.asarray, a), jax.tree.map(jnp.asarray, b), acc, 4)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
