"""repro_torch's FedAsync plugin, dense int8/int4 codecs and Table III
harness, against repro on the CPU.

* FedAsync: the three variants registered, each one's 4096-entry
  staleness table bit-equal to the reference's, and its mix changing an
  event-mode trajectory against AFL's (whole-run parity on all three
  runtimes is in tests/test_torch_batched.py).
* The dense codecs on the full-width CNN's tree and on a 2^20 randn
  leaf: payload ``nbytes``, planes, scales and decoded trees bit-equal
  to the reference's, for int8 and int4, at seeds above 2^32 too.  The
  reference quantizes eagerly, so its scale max|x| / qmax is a true
  division; so is the port's.
* The Table III harness: ``table3_row`` equal to the reference's on the
  same run summaries, and one smoke-scale run of experiment ``a`` on the
  port's own RNG that prints the reference's CSV.
"""
import io
from contextlib import redirect_stdout

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs a test process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from benchmarks import fl_common as jbench  # noqa: E402
from repro.algorithms import get_algorithm as j_get  # noqa: E402
from repro.compress.quantize import QuantCodec as JQuantCodec  # noqa: E402
from repro.core import FLRunConfig as JConfig  # noqa: E402
from repro.core.metrics import CommStats as JComm, RunResult as JResult  # noqa: E402
from repro_torch.algorithms import available_algorithms, get_algorithm  # noqa: E402
from repro_torch.bench import fl_common as tbench, table3_ccr  # noqa: E402
from repro_torch.compress import get_codec  # noqa: E402
from repro_torch.compress.quantize import QuantCodec, stochastic_quantize  # noqa: E402
from repro_torch.core.client import LocalSpec  # noqa: E402
from repro_torch.core.config import FLRunConfig as TConfig  # noqa: E402
from repro_torch.core.federation import Federation  # noqa: E402
from repro_torch.core.metrics import CommStats, RoundRecord, RunResult, ccr  # noqa: E402
from repro_torch.data.partition import iid_partition  # noqa: E402
from repro_torch.data.synthetic import synthetic_mnist  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.weights import to_numpy_params  # noqa: E402

VARIANTS = ("fedasync", "fedasync_poly", "fedasync_const")


# --------------------------------------------------------------- FedAsync ---

def test_fedasync_variants_registered():
    names = available_algorithms()
    for name in VARIANTS:
        assert name in names
        alg = get_algorithm(name)
        assert alg.event_mode == "async" and not alg.make_policy(TConfig()).needs_values
        assert alg.description == j_get(name).description


@pytest.mark.parametrize("name", VARIANTS)
def test_fedasync_staleness_tables_match_reference(name):
    """The hinge (a=10, b=6), poly (a=0.5) and const tables, bit for bit;
    ``staleness_kind`` is ignored, as in the reference."""
    taus = list(range(4096)) + [5000, 123_457]
    tagg = get_algorithm(name).make_aggregator(TConfig(staleness_kind="const"))
    jagg = j_get(name).make_aggregator(JConfig(staleness_kind="const"))
    assert [tagg.stale_weight(t) for t in taus] == [jagg.stale_weight(t) for t in taus]
    if name == "fedasync":
        assert tagg.stale_weight(6) == 1.0 and tagg.stale_weight(7) == pytest.approx(1 / 11)


def test_fedasync_differs_from_afl_in_event_mode():
    """The hinge decay changes the trajectory against AFL's poly decay
    (same uploads, different mixing weights), on both engines."""
    xtr, ytr, xte, yte = synthetic_mnist(5 * 200 + 500, 500, seed=0)
    fed = Federation(model=(tcnn.mlp_forward, tcnn.mlp_init, tcnn.MLPConfig(hidden=(32,))),
                     data=iid_partition(xtr, ytr, 5, samples_per_client=200, seed=0),
                     test_data=(xte, yte), local=LocalSpec(32, 1, 1, 0.1), seed=7,
                     device="cpu")
    for engine in ("sequential", "batched"):
        a = fed.run(rounds=3, mode="event", algorithm="afl", engine=engine)
        f = fed.run(rounds=3, mode="event", algorithm="fedasync", engine=engine)
        assert a.comm.model_uploads == f.comm.model_uploads == 15
        assert [r.global_acc for r in a.records] != [r.global_acc for r in f.records]


# ----------------------------------------------------------- dense codecs ---

def _trees():
    cnn = to_numpy_params(tcnn.cnn_init(tcnn.CNNConfig(), torch.Generator().manual_seed(5)))
    big = {"x": np.random.RandomState(3).randn(2 ** 20).astype(np.float32)}
    return {"cnn": cnn, "randn2^20": big}


@pytest.mark.parametrize("seed", [0, 12345, 2 ** 32 + 5, 2 ** 40 + 3])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("tree", ["cnn", "randn2^20"])
def test_dense_codec_bitexact_vs_reference(tree, bits, seed):
    t = _trees()[tree]
    want = JQuantCodec(bits).encode(jax.tree.map(jnp.asarray, t), seed=seed)
    got = get_codec(f"int{bits}").encode({k: _tensors(v) for k, v in t.items()}, seed=seed)
    assert isinstance(get_codec(f"int{bits}"), QuantCodec)
    assert got.nbytes == want.nbytes and got.codec == want.codec == f"int{bits}"
    assert got.wire_overhead == want.wire_overhead == 4 * len(jax.tree.leaves(t))
    assert sorted(got.planes) == sorted(want.planes)
    for k, plane in want.planes.items():
        assert got.planes[k].dtype == plane.dtype
        np.testing.assert_array_equal(got.planes[k], plane)
    assert got.meta["scales"] == want.meta["scales"]
    dec_ref = jax.tree.leaves(JQuantCodec(bits).decode(want))
    dec = [x for x in _leaves(QuantCodec(bits).decode(got))]
    for a, b in zip(dec_ref, dec):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy().view(np.int32), np.asarray(a).view(np.int32))


def _tensors(v):
    if isinstance(v, dict):
        return {k: _tensors(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_tensors(x) for x in v]
    return None if v is None else torch.from_numpy(v)


def _leaves(tree):
    from repro_torch.common.pytree import tree_leaves
    return tree_leaves(tree)


def test_dense_scale_is_a_true_division():
    """max|x| / qmax as the reference computes it eagerly: a true
    division, which the reciprocal multiply misses at some inputs."""
    x = torch.from_numpy(np.random.RandomState(9).randn(4096, 2).astype(np.float32))
    hits = 0
    for row in x:
        _, scale = stochastic_quantize(row, 127.0, 0)
        m = np.abs(row.numpy()).max()
        assert float(scale) == float(np.float32(m) / np.float32(127.0))
        hits += float(scale) != float(np.float32(m) * np.float32(1 / 127))
    assert hits > 0


def test_codec_rejects_other_widths():
    with pytest.raises(ValueError, match="4 or 8"):
        QuantCodec(2)


# ------------------------------------------------------- Table III harness ---

def _results(pkg, counts):
    """{alg: RunResult} of one package with the given (uploads, uploads at
    target or None, best accuracy) per algorithm."""
    comm_cls, rec_cls, res_cls = pkg
    out = {}
    for alg, (uploads, at_target, best) in counts.items():
        comm = comm_cls(model_uploads=uploads, model_bytes=4)
        rec = rec_cls(round=1, time=1.0, global_acc=best, uploads_so_far=uploads)
        res = res_cls(alg, [rec], comm, 0.9)
        res.uploads_to_target = at_target
        out[alg] = res
    return out


@pytest.mark.parametrize("counts", [
    {"afl": (39, None, 0.91234), "eaflm": (25, 20, 0.95), "vafl": (28, None, 0.8)},
    {"afl": (84, 60, 0.97), "eaflm": (45, None, 0.5), "vafl": (43, 31, 0.961)},
])
def test_table3_row_matches_reference(counts):
    from repro.core.metrics import RoundRecord as JRecord
    want = jbench.table3_row("b", _results((JComm, JRecord, JResult), counts))
    got = tbench.table3_row("b", _results((CommStats, RoundRecord, RunResult), counts))
    assert got == want
    assert tbench.EXPERIMENTS == jbench.EXPERIMENTS and tbench.ALGS == jbench.ALGS
    assert vars(tbench.BenchScale()) == vars(jbench.BenchScale())


def test_table3_smoke_run_on_cpu(monkeypatch):
    """Experiment a at smoke scale on the port's own RNG: the reference's
    CSV header, one row per algorithm, each row's CCR from the runs' own
    upload counts, and vafl uploading no more than afl."""
    seen = {}

    def run_experiment(exp, alg, **kw):
        seen[alg] = tbench.run_experiment(exp, alg, **kw)
        return seen[alg]
    monkeypatch.setattr(table3_ccr, "run_experiment", run_experiment)
    out = io.StringIO()
    with redirect_stdout(out):
        rows = table3_ccr.run(scale=tbench.BenchScale(samples_per_client=200, rounds=3,
                                                      test_samples=300),
                              experiments=["a"], device="cpu")
    lines = out.getvalue().strip().splitlines()
    assert lines[0] == ("experiment,algorithm,communication_times,reached_target,best_acc,"
                        "ccr,paper_comm,paper_ccr")
    assert [ln.split(",")[:2] for ln in lines[1:]] == [["a", a] for a in tbench.ALGS]
    c0 = seen["afl"].uploads_to_target or seen["afl"].comm.model_uploads
    for row, line in zip(rows, lines[1:]):
        res = seen[row["algorithm"]]
        c1 = res.uploads_to_target or res.comm.model_uploads
        assert row["communication_times"] == c1
        assert row["ccr"] == (round(ccr(c0, c1), 4) if row["algorithm"] != "afl" else 0.0)
        assert line.endswith(",".join(str(x) for x in table3_ccr.PAPER_TABLE3[
            ("a", row["algorithm"])]))
    assert seen["vafl"].comm.model_uploads <= seen["afl"].comm.model_uploads


def test_table3_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tbench.build_federation("a", "afl", scale=tbench.BenchScale(samples_per_client=50))
