"""repro_torch's training slice against repro's, on the CPU: the
optimisers and schedules, minicpm_2b, the decoder's loss and its
gradients, ``make_train_step``, the cross-silo ``make_fl_train_step``,
and the federated LM example, on the same numpy inputs and the
reference's own parameters and optimiser states (``from_jax_params``).

Tolerances:
* the optimisers are elementwise IEEE fp32 in both packages, run op by
  op (the reference's update is not jitted here), with ``powf`` for
  ``b ** t`` and a correctly rounded square root: **bit-equal**;
  ``apply_updates`` and the WSD and constant schedules too.  The global
  norm sums in another order: **rtol 1e-6**; the cosine schedule reads
  ``cos`` (numpy's against XLA's): rtol 1e-6, and 1e-6 of the peak where
  ``1 + cos`` cancels near the floor;
* layer outputs, logits, losses and gradients: fp32 sums in another
  order, 1e-4 of the scale (``TOL``, as tests/test_torch_llm_serve.py);
  bf16 compute rounds at other places, 2e-2.  Parameters after Adam
  steps (``adam_close``): Adam moves every entry by about lr whatever its
  gradient's size, so an entry whose gradient is a near-zero cancellation
  (|g| near ``eps``) moves by a share of lr that the gradient's last bits
  decide, by up to 2 lr a step where the two signs differ.  Such entries
  are a few in a million here (2-4 of 1.4 M at fp32), so all but 1e-5 of
  the entries are held to ``TOL`` and every entry to 2 lr a step taken.
  A silo's effective gradient over ``local_steps`` > 1 is
  (theta_start - theta_end) / local_lr, whose rounding is that of the
  parameters: it is held to ``TOL`` of its scale plus two fp32 spacings
  of the leaf's largest parameter over local_lr;
* Eq. 1's V: 1e-5 relative; the silo masks and the FL runs' selections
  and CommStats exactly.
"""
import dataclasses
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs a test process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import optim as jopt  # noqa: E402
from repro.core import Federation as JFederation  # noqa: E402
from repro.core.client import LocalSpec as JLocalSpec  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro.models.registry import get_config as jget_config  # noqa: E402
from repro.models.registry import get_smoke_config as jget_smoke  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.common.pytree import (global_norm, tree_flatten, tree_leaves,  # noqa: E402
                                       tree_map, tree_unflatten)
from repro_torch.data.synthetic import token_stream  # noqa: E402
from repro_torch.examples import fl_llm_finetune as tex  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import fl_train as tfl_train, train as ttrain  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def scaled_close(got, want, tol, what=""):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    err = float(np.abs(g - w).max()) if g.size else 0.0
    assert err <= tol * (float(np.abs(w).max()) + 1e-6), (what, err)


def trees_close(got, want, tol, what=""):
    for i, (g, w) in enumerate(zip(tree_leaves(got), jax.tree.leaves(want))):
        scaled_close(g, w, tol, f"{what} leaf {i}")


def adam_close(got, want, tol, lr, steps, what="", share=1e-5):
    """Parameters after ``steps`` Adam steps at ``lr``: all but ``share``
    of the entries within ``tol`` of each leaf's scale, every entry within
    2 lr a step (the module docstring says why)."""
    diff, scale = [], []
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape, what
        diff.append(np.abs(g - w).ravel())
        scale.append(np.full(w.size, np.abs(w).max() + 1e-6, np.float32))
    diff, scale = np.concatenate(diff), np.concatenate(scale)
    assert (diff > tol * scale).mean() <= share, (what, int((diff > tol * scale).sum()))
    assert diff.max() <= 2 * lr * steps, (what, float(diff.max()))


def trees_equal(got, want):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def rnd_tree(seed, scale=1.0):
    rs = np.random.RandomState(seed)
    return {"w": (rs.randn(40, 7) * scale).astype(np.float32),
            "b": [(rs.randn(33) * scale).astype(np.float32)]}


def configs(arch="minicpm_2b", compute="float32", **kw):
    return (jget_smoke(arch).replace(compute_dtype=compute, **kw),
            registry.get_smoke_config(arch).replace(compute_dtype=compute, **kw))


@pytest.fixture(scope="module")
def ref_params():
    """The reference's minicpm_2b smoke parameters (seed 0), numpy."""
    jcfg, _ = configs()
    return jax.tree.map(np.asarray, jdec.init_params(jcfg, jax.random.key(0)))


def lm_batch(seed, cfg, B, S, lead=()):
    """tokens and labels (-1 on a few positions) for both packages."""
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab_size, size=lead + (B, S)).astype(np.int32)
    labs = rs.randint(0, cfg.vocab_size, size=lead + (B, S)).astype(np.int32)
    labs[..., 0, :3] = -1
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)},
            {"tokens": torch.from_numpy(toks).long(), "labels": torch.from_numpy(labs).long()})


# ------------------------------------------------------------ optimisers ---

OPTIMISERS = {
    "adamw": lambda m: m.adamw(3e-4, weight_decay=0.01),
    "adam": lambda m: m.adam(1e-3),
    "sgd": lambda m: m.sgd(0.1),
    "momentum": lambda m: m.sgd(0.1, momentum=0.9),
    "nesterov": lambda m: m.sgd(0.05, momentum=0.9, nesterov=True),
    "adamw_wsd": lambda m: m.adamw(m.wsd(1e-2, 5, 10, 20), weight_decay=0.1),
}


@pytest.mark.parametrize("name", sorted(OPTIMISERS))
def test_optimiser_updates_bit_equal(name):
    """40 steps from the reference's own initial state: every update,
    state leaf and parameter bit for bit."""
    (ji, ju), (ti, tu) = OPTIMISERS[name](jopt), OPTIMISERS[name](topt)
    jp, tp = jax.tree.map(jnp.asarray, rnd_tree(0)), from_jax_params(rnd_tree(0))
    js = ji(jp)
    ts = from_jax_params(jax.tree.map(np.asarray, js))
    assert tree_map(lambda x: x.shape, ts) == tree_map(lambda x: x.shape, ti(tp))
    for step in range(40):
        g = rnd_tree(100 + step, scale=1.0 + 0.1 * step)
        jupd, js = ju(jax.tree.map(jnp.asarray, g), js, jp, step)
        tupd, ts = tu(from_jax_params(g), ts, tp, step)
        trees_equal(tupd, jupd)
        trees_equal(ts, js)
        jp, tp = jopt.apply_updates(jp, jupd), topt.apply_updates(tp, tupd)
        trees_equal(tp, jp)


def test_apply_updates_keeps_the_param_dtype():
    p = {"a": np.random.RandomState(1).randn(64).astype(np.float32)}
    u = {"a": np.random.RandomState(2).randn(64).astype(np.float32) * 1e-3}
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        got = topt.apply_updates(tree_map(lambda x: x.to(dt), from_jax_params(p)),
                                 from_jax_params(u))
        want = jopt.apply_updates(jax.tree.map(lambda x: jnp.asarray(x, jdt), p),
                                  jax.tree.map(jnp.asarray, u))
        assert got["a"].dtype == dt
        np.testing.assert_array_equal(_np(got["a"]), _np(want["a"]))


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm(max_norm):
    g = rnd_tree(3, scale=2.0)
    tc, tn = topt.clip_by_global_norm(from_jax_params(g), max_norm)
    jc, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(float(global_norm(from_jax_params(g))), float(jn), rtol=1e-6)
    for a, b in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)


SCHEDULES = {"wsd": lambda m: m.wsd(1e-2, 20, 60, 100, floor_ratio=0.1),
             "wsd_short": lambda m: m.wsd(3e-3, 1, 0, 7, floor_ratio=0.05),
             "constant": lambda m: m.constant(3e-4),
             "cosine": lambda m: m.cosine(1e-3, 10, 150, floor=1e-5),
             "cosine_nowarm": lambda m: m.cosine(2e-3, 0, 50)}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_over_steps_0_to_200(name):
    js, ts = SCHEDULES[name](jopt), SCHEDULES[name](topt)
    want = np.array([float(js(jnp.int32(s))) for s in range(201)], np.float32)
    got = np.array([ts(s) for s in range(201)], np.float32)
    if name.startswith("cosine"):
        # numpy's cos against XLA's: an ulp of cos near -1 is amplified
        # where (1 + cos) cancels, so near the floor the bound is 1e-6 of
        # the peak rather than of the value
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * float(want.max()))
    else:
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ minicpm_2b ---

def test_minicpm_2b_config_equals_reference():
    for t, j in ((registry.get_config("minicpm_2b"), jget_config("minicpm_2b")),
                 (registry.get_smoke_config("minicpm-2b"), jget_smoke("minicpm_2b"))):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    cfg = registry.get_config("minicpm_2b")
    assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff,
            cfg.vocab_size, cfg.tie_embeddings) == (2304, 36, 36, 64, 5760, 122753, True)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_minicpm_2b_forward_logits(ref_params, compute):
    """scale_emb, the residual depth scale, logits_scale and the tied
    table, held against the reference's forward."""
    jcfg, tcfg = configs(compute=compute)
    toks = np.random.RandomState(4).randint(0, jcfg.vocab_size, size=(2, 48)).astype(np.int32)
    jl, _ = jdec.forward(jcfg, ref_params, jnp.asarray(toks), remat=False)
    tl, _ = tdec.forward(tcfg, from_jax_params(ref_params), torch.from_numpy(toks).long())
    scaled_close(tl, jl, TOL[compute], f"{compute} logits")


# -------------------------------------------------------------- loss_fn ---

@pytest.fixture(scope="module")
def ref_loss_grads(ref_params):
    """The reference's loss and jax.grad of its loss_fn on one batch."""
    jcfg, _ = configs()
    jb, _ = lm_batch(5, jcfg, 2, 40)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jdec.loss_fn(jcfg, p, b), has_aux=True))(ref_params, jb)
    return float(loss), grads


@pytest.fixture(scope="module")
def port_loss_grads(ref_params):
    """The port's loss and gradients with and without remat."""
    jcfg, tcfg = configs()
    _, tb = lm_batch(5, jcfg, 2, 40)
    out = {}
    for remat in (True, False):
        out[remat] = tsteps.value_and_grad(
            lambda p, b: tdec.loss_fn(tcfg, p, b, remat=remat),
            from_jax_params(ref_params), tb)
    return out


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_every_leaf_gradient_match_reference(ref_loss_grads, port_loss_grads, remat):
    want_loss, want_grads = ref_loss_grads
    loss, grads = port_loss_grads[remat]
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    assert len(tree_leaves(grads)) == len(jax.tree.leaves(want_grads))
    trees_close(grads, want_grads, TOL["float32"], "grad")


def test_remat_changes_no_number(port_loss_grads):
    (la, ga), (lb, gb) = port_loss_grads[True], port_loss_grads[False]
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(ga), tree_leaves(gb)))


def test_loss_masks_labels():
    """Masked labels carry no loss: all -1 but one position is that
    position's NLL; all -1 is a zero loss."""
    _, tcfg = configs()
    params = tdec.init_params(tcfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.RandomState(6).randint(0, 512, size=(1, 12))).long()
    labs = torch.full((1, 12), -1)
    labs[0, 4] = 7
    loss, _ = tdec.loss_fn(tcfg, params, {"tokens": toks, "labels": labs})
    logits, _ = tdec.forward(tcfg, params, toks)
    want = -torch.log_softmax(logits.float(), -1)[0, 4, 7]
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=1e-6)
    zero, _ = tdec.loss_fn(tcfg, params, {"tokens": toks, "labels": torch.full((1, 12), -1)})
    assert float(zero) == 0.0


def test_rwkv6_trains_on_the_cpu_through_the_plain_scan():
    _, tcfg = configs("rwkv6_3b")
    step, opt_init = tsteps.make_train_step(tcfg)
    params = tdec.init_params(tcfg, torch.Generator().manual_seed(0))
    _, tb = lm_batch(7, tcfg, 2, 16)
    params2, _, info = step(params, opt_init(params), tb, 0)
    assert np.isfinite(float(info["loss"])) and float(info["grad_norm"]) > 0
    assert all(not torch.equal(a, b) for a, b in zip(tree_leaves(params), tree_leaves(params2)))


# ------------------------------------------------------- make_train_step ---

@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_train_step_three_steps_match_reference(ref_params, compute):
    jcfg, tcfg = configs(compute=compute)
    jstep, jinit = jsteps.make_train_step(jcfg, q_chunk=None)
    tstep, tinit = tsteps.make_train_step(tcfg)
    jstep = jax.jit(jstep)
    jp, tp = ref_params, from_jax_params(ref_params)
    js = jinit(jp)
    ts = from_jax_params(jax.tree.map(np.asarray, js))
    for s in range(3):
        jb, tb = lm_batch(10 + s, jcfg, 2, 32)
        jp, js, jinfo = jstep(jp, js, jb, jnp.int32(s))
        tp, ts, tinfo = tstep(tp, ts, tb, s)
        np.testing.assert_allclose(float(tinfo["loss"]), float(jinfo["loss"]),
                                   rtol=10 * TOL[compute])
        np.testing.assert_allclose(float(tinfo["grad_norm"]), float(jinfo["grad_norm"]),
                                   rtol=10 * TOL[compute])
        adam_close(tp, jp, TOL[compute], 3e-4, s + 1, f"step {s} params")


def test_train_cli_runs_on_the_cpu(tmp_path):
    losses = ttrain.run("minicpm_2b", smoke=True, steps=3, batch=2, seq=16, lr=1e-3,
                        ckpt_dir=str(tmp_path), device="cpu", verbose=False)
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert any(tmp_path.iterdir())


# -------------------------------------------------------- make_fl_train_step ---

FL_CASES = [("vafl", 2, 1), ("vafl", 3, 2), ("afl", 2, 2), ("afl", 3, 1),
            ("eaflm", 2, 1), ("eaflm", 3, 2)]


@pytest.mark.parametrize("algorithm,pods,local_steps", FL_CASES)
def test_fl_train_step_three_steps_match_reference(ref_params, algorithm, pods, local_steps):
    jcfg, tcfg = configs()
    kw = dict(n_pods=pods, algorithm=algorithm, local_steps=local_steps)
    jstep, jinit = jsteps.make_fl_train_step(jcfg, q_chunk=None, **kw)
    tstep, tinit = tsteps.make_fl_train_step(tcfg, **kw)
    jstep = jax.jit(jstep)
    jp, tp = ref_params, from_jax_params(ref_params)
    js = jinit(jp)
    ts = from_jax_params(jax.tree.map(np.asarray, js))
    jprev = jax.tree.map(lambda x: jnp.zeros((pods,) + x.shape, jnp.float32), jp)
    tprev = tree_map(lambda x: torch.zeros((pods,) + tuple(x.shape)), tp)
    lead = (pods,) if local_steps == 1 else (pods, local_steps)
    for s in range(3):
        jb, tb = lm_batch(20 + s, jcfg, 2, 24, lead)
        start = tp
        jp, js, jprev, jinfo = jstep(jp, js, jprev, jb, jnp.int32(s))
        tp, ts, tprev, tinfo = tstep(tp, ts, tprev, tb, s)
        np.testing.assert_allclose(_np(tinfo["V"]), _np(jinfo["V"]), rtol=1e-5)
        np.testing.assert_array_equal(_np(tinfo["mask"]), _np(jinfo["mask"]))
        np.testing.assert_allclose(float(tinfo["loss"]), float(jinfo["loss"]), rtol=1e-4)
        adam_close(tp, jp, TOL["float32"], 3e-4, s + 1, f"step {s} params")
        for i, (g, w, p0) in enumerate(zip(tree_leaves(tprev), jax.tree.leaves(jprev),
                                           tree_leaves(start))):
            g, w = _np(g), _np(w)
            slack = 0.0 if local_steps == 1 else (
                2 * float(np.spacing(np.abs(_np(p0)).max())) / 1e-2)   # local_lr
            err = float(np.abs(g - w).max())
            assert err <= TOL["float32"] * float(np.abs(w).max()) + slack, (s, i, err)


def test_fl_train_step_comm_dtype_matches_reference(ref_params):
    """comm_dtype=bf16: the silo gradients travel in bf16, and the first
    step's Eq. 1 reads fp32 zeros against them.  Both packages round the
    same fp32 gradients to bf16, up to an element whose fp32 values
    straddle a rounding boundary: V within 1e-3, the masks equal."""
    jcfg, tcfg = configs()
    jstep, jinit = jsteps.make_fl_train_step(jcfg, n_pods=2, q_chunk=None,
                                             comm_dtype=jnp.bfloat16)
    tstep, _ = tsteps.make_fl_train_step(tcfg, n_pods=2, comm_dtype=torch.bfloat16)
    jp, tp = ref_params, from_jax_params(ref_params)
    js = jinit(jp)
    ts = from_jax_params(jax.tree.map(np.asarray, js))
    jprev = jax.tree.map(lambda x: jnp.zeros((2,) + x.shape, jnp.float32), jp)
    tprev = tree_map(lambda x: torch.zeros((2,) + tuple(x.shape)), tp)
    for s in range(2):
        jb, tb = lm_batch(70 + s, jcfg, 2, 24, (2,))
        jp, js, jprev, jinfo = jax.jit(jstep)(jp, js, jprev, jb, jnp.int32(s))
        tp, ts, tprev, tinfo = tstep(tp, ts, tprev, tb, s)
        assert all(x.dtype == torch.bfloat16 for x in tree_leaves(tprev))
        np.testing.assert_allclose(_np(tinfo["V"]), _np(jinfo["V"]), rtol=1e-3)
        np.testing.assert_array_equal(_np(tinfo["mask"]), _np(jinfo["mask"]))
        adam_close(tp, jp, TOL["float32"], 3e-4, s + 1, f"step {s} params")


def test_fl_train_step_falls_back_to_the_strongest_silo(monkeypatch):
    """A gate that selects no silo: the step aggregates the silo with the
    largest V alone (and so still moves the parameters as AdamW on that
    silo's gradient), as the reference's step does."""
    from repro_torch.algorithms import base, registry as algs
    from repro_torch.algorithms.builtin import VAFLPolicy

    class NonePolicy(VAFLPolicy):
        def gate_stacked(self, values=None, sq_norms=None, server_delta_sq=None):
            return torch.zeros_like(values)

    monkeypatch.setitem(algs._REGISTRY, "gate_none", base.Algorithm(
        name="gate_none", policy_factory=NonePolicy, description="selects nothing"))
    _, tcfg = configs()
    params = tdec.init_params(tcfg, torch.Generator().manual_seed(0))
    prev = tree_map(lambda x: torch.zeros((2,) + tuple(x.shape)), params)
    _, tb = lm_batch(30, tcfg, 2, 16, (2,))
    outs = {}
    for alg in ("gate_none", "vafl"):
        step, opt_init = tsteps.make_fl_train_step(tcfg, n_pods=2, algorithm=alg)
        outs[alg] = step(params, opt_init(params), prev, tb, 0)
    info = outs["gate_none"][3]
    V = info["V"]
    assert info["mask"].tolist() == (V == V.max()).float().tolist()
    assert info["mask"].tolist() == outs["vafl"][3]["mask"].tolist()   # P = 2: the larger V
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(outs["gate_none"][0]),
                                                 tree_leaves(outs["vafl"][0])))


def test_stacked_gates():
    """vafl's silo mask is Eq. 2 on V; afl's is all ones; eaflm's is the
    norm threshold."""
    from repro_torch.algorithms import get_algorithm
    from repro_torch.core.config import FLRunConfig
    V = torch.tensor([1.0, 5.0, 2.0, 3.0])
    vafl = get_algorithm("vafl").make_policy(FLRunConfig(algorithm="vafl"))
    afl = get_algorithm("afl").make_policy(FLRunConfig(algorithm="afl"))
    eaflm = get_algorithm("eaflm").make_policy(FLRunConfig(algorithm="eaflm"))
    assert vafl.gate_stacked(values=V).tolist() == [0.0, 1.0, 0.0, 1.0]
    assert afl.gate_stacked(values=V).tolist() == [1.0] * 4
    none = eaflm.gate_stacked(sq_norms=V, server_delta_sq=torch.tensor(1e9))
    assert none.tolist() == [0.0] * 4
    with pytest.raises(ValueError):
        afl.gate_stacked()


def test_fl_train_cli_runs_on_the_cpu():
    infos = tfl_train.run("minicpm_2b", smoke=True, steps=2, pods=2, batch_per_pod=2, seq=16,
                          lr=1e-3, device="cpu", verbose=False)
    assert len(infos) == 2 and all(i["V"].shape == (2,) for i in infos)
    assert all(1 <= i["mask"].sum() <= 2 for i in infos)


def test_unknown_algorithm_fails_early():
    _, tcfg = configs()
    with pytest.raises(ValueError, match="registered algorithms"):
        tsteps.make_fl_train_step(tcfg, n_pods=2, algorithm="nope")


# ------------------------------------------------------ the FL LM example ---

def _load_reference_example():
    spec = importlib.util.spec_from_file_location(
        "ref_fl_llm_finetune", ROOT / "examples" / "fl_llm_finetune.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ref_permutations(m, n, rounds, n_ep, seed=0):
    """The permutations the reference's round runtime draws: key(seed)
    split once for init, then per round -> per client -> per epoch."""
    rng, _ = jax.random.split(jax.random.key(seed))
    perms = {}
    for t in range(1, rounds + 1):
        rng, urng = jax.random.split(rng)
        for i, ck in enumerate(jax.random.split(urng, n)):
            for e, ek in enumerate(jax.random.split(ck, n_ep + 1)[:n_ep]):
                perms[(i, t, e)] = np.asarray(jax.random.permutation(ek, m)).astype(np.int64)
    return perms


@pytest.mark.parametrize("algorithm", ["afl", "vafl"])
def test_fl_llm_example_matches_reference(algorithm):
    """The example's federation (explicit-fns mode, the LM loss under the
    local update's vmap over clients) at fp32 compute, a smaller corpus
    and 2 rounds, from the reference's initial parameters and
    permutations: the same selections, uploads and CommStats, the final
    parameters within 1e-4.  (At bf16 the two packages round at other
    places, enough to move a vafl selection.)"""
    jex = _load_reference_example()
    jcfg, tcfg = configs(vocab_size=128)
    N, rounds = 3, 2
    fed = tex.build_federation(tcfg, N, seqs_per_client=16, seq_len=24)
    jfed = jex.build_federation(jcfg, N, seqs_per_client=16, seq_len=24)
    np.testing.assert_array_equal(fed.images, jfed.images)
    test_toks, _ = token_stream(8, 24, 128, seed=7, structure_seed=7)
    seen = {}

    def jinit(k):
        p = jdec.init_params(jcfg, k)
        seen["init"] = jax.tree.map(np.asarray, p)
        return p

    jeval = jex.make_lm_evaluator(jcfg, test_toks)

    def jeval_capture(p):
        seen["ref_final"] = jax.tree.map(np.asarray, p)
        return jeval(p)

    local = tex.LOCAL
    ref = JFederation(
        data=jfed, algorithm=algorithm, init_params_fn=jinit, loss_fn=jex.make_lm_loss(jcfg),
        evaluate_fn=jeval_capture, client_eval_fn=jeval,
        local=JLocalSpec(batch_size=local.batch_size, local_epochs=local.local_epochs,
                         local_rounds=local.local_rounds, lr=local.lr),
        target_acc=tex.TARGET_ACC).run(rounds=rounds)
    perms = ref_permutations(16, N, rounds, local.local_epochs * local.local_rounds)
    tfed = tex.make_federation(tcfg, fed, algorithm, device="cpu",
                               init_params_fn=lambda g: from_jax_params(seen["init"]),
                               test_tokens=test_toks)
    teval = tfed.evaluate_fn

    def teval_capture(p):
        seen["port_final"] = p
        return teval(p)

    tfed.evaluate_fn, tfed.client_eval_fn = teval_capture, teval
    res = tfed.run(rounds=rounds,
                   perm_fn=lambda i, t, e, m: torch.from_numpy(perms[(i, t, e)]))
    assert [r.selected for r in res.records] == [r.selected for r in ref.records]
    assert dataclasses.asdict(res.comm) == dataclasses.asdict(ref.comm)
    np.testing.assert_allclose([r.global_acc for r in res.records],
                               [r.global_acc for r in ref.records], atol=1e-6)
    trees_close(seen["port_final"], seen["ref_final"], TOL["float32"], "final params")


# ------------------------------------------------------------ on the card ---

@pytest.fixture
def cuda():
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on an H100 host)")
    try:
        build.nvcc_path()
        build.require_hopper()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda")


def _card_steps(cfg, params, device, steps=3, **kw):
    from repro_torch.kernels.flash_attention import ops as fa_ops
    step, opt_init = tsteps.make_train_step(cfg, **kw)
    p = tree_map(lambda x: x.to(device), params)
    st = opt_init(p)
    before = (fa_ops.launches, fa_ops.bwd_launches)
    losses = []
    for s in range(steps):
        _, tb = lm_batch(40 + s, cfg, 2, 48)
        p, st, info = step(p, st, tree_map(lambda x: x.to(device), tb), s)
        losses.append(float(info["loss"]))
    return p, losses, (fa_ops.launches - before[0], fa_ops.bwd_launches - before[1])


@pytest.mark.gpu
def test_gpu_train_step_matches_cpu(cuda, ref_params):
    """Three steps of minicpm_2b's smoke model at fp32 compute on the card
    (the attention through the forward and backward kernels, each layer
    checkpointed: two forwards and one backward a layer a step) against
    the CPU path from the same parameters."""
    _, tcfg = configs()
    params = from_jax_params(ref_params)
    pc, lc, nc = _card_steps(tcfg, params, cuda)
    pp, lp, _ = _card_steps(tcfg, params, "cpu")
    assert nc == (2 * 2 * 3, 2 * 3)
    np.testing.assert_allclose(lc, lp, rtol=1e-5)
    adam_close(tree_map(lambda x: x.cpu(), pc), tree_map(lambda x: x.numpy(), pp),
               TOL["float32"], 3e-4, 3, "card vs cpu params")


@pytest.mark.gpu
def test_gpu_train_step_reproducible(cuda, ref_params):
    _, tcfg = configs(compute="bfloat16")
    params = from_jax_params(ref_params)
    (pa, la, _), (pb, lb, _) = (_card_steps(tcfg, params, cuda) for _ in range(2))
    assert la == lb
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(pa), tree_leaves(pb)))


@pytest.mark.gpu
def test_gpu_fl_train_step_matches_cpu(cuda, ref_params):
    from repro_torch.kernels.grad_diff_norm import ops as gd_ops
    _, tcfg = configs()
    out = {}
    for dev in (cuda, torch.device("cpu")):
        step, opt_init = tsteps.make_fl_train_step(tcfg, n_pods=2, algorithm="vafl")
        p = from_jax_params(ref_params, dev)
        st = opt_init(p)
        prev = tree_map(lambda x: torch.zeros((2,) + tuple(x.shape), device=dev), p)
        before, vs, masks = gd_ops.launches, [], []
        for s in range(3):
            _, tb = lm_batch(50 + s, tcfg, 2, 24, (2,))
            p, st, prev, info = step(p, st, prev, tree_map(lambda x: x.to(dev), tb), s)
            vs.append(_np(info["V"]))
            masks.append(_np(info["mask"]))
        out[dev.type] = (vs, masks, gd_ops.launches - before)
    assert out["cuda"][2] == 3 and out["cpu"][2] == 0
    np.testing.assert_allclose(np.array(out["cuda"][0]), np.array(out["cpu"][0]), rtol=1e-4)
    np.testing.assert_array_equal(np.array(out["cuda"][1]), np.array(out["cpu"][1]))


RWKV_LR = 3e-4


def _rwkv_steps(cfg, params, device, steps=3):
    """``make_train_step`` at ``RWKV_LR`` on rwkv6_3b's smoke model: (final
    parameters, losses, step 1's gradients, the linear_scan launches of
    the steps, forward and backward)."""
    from repro_torch.kernels.linear_scan import ops as ls_ops
    step, opt_init = tsteps.make_train_step(cfg, lr=RWKV_LR)
    p = tree_map(lambda x: x.to(device), params)
    batch = lambda s: tree_map(lambda x: x.to(device), lm_batch(60 + s, cfg, 2, 48)[1])
    _, grads = tsteps.value_and_grad(lambda pp, b: tdec.loss_fn(cfg, pp, b), p, batch(0))
    st = opt_init(p)
    before = (ls_ops.launches, ls_ops.bwd_launches)
    losses = []
    for s in range(steps):
        p, st, info = step(p, st, batch(s), s)
        losses.append(float(info["loss"]))
    return p, losses, grads, (ls_ops.launches - before[0], ls_ops.bwd_launches - before[1])


@pytest.mark.gpu
def test_gpu_rwkv6_train_step_matches_cpu(cuda):
    """Three steps of rwkv6_3b's smoke model at fp32 compute on the card,
    the time-mix recurrence through the linear_scan kernel forward and
    backward (each layer checkpointed: two forwards and one backward a
    layer a step), against the CPU path from the same parameters: step
    1's gradients at 1e-4 of each leaf's scale, the losses at 1e-5, and
    the parameters after the 3 steps by ``adam_close`` with a share of
    5e-5 (24 of rwkv6's 491,520 entries) beyond 1e-4 of their leaf's
    scale, in place of its 1e-5: Adam moves an entry whose gradient is a
    near-zero cancellation by a share of lr that the gradient's last bits
    decide, and the card's first run read 6 such entries, more than 1e-5
    of a model this small allows."""
    _, tcfg = configs("rwkv6_3b")
    params = tdec.init_params(tcfg, torch.Generator().manual_seed(0))
    pc, lc, gc, nc = _rwkv_steps(tcfg, params, cuda)
    pp, lp, gp, _ = _rwkv_steps(tcfg, params, "cpu")
    assert nc == (2 * 3 * tcfg.num_layers, 3 * tcfg.num_layers)
    np.testing.assert_allclose(lc, lp, rtol=1e-5)
    for i, (a, b) in enumerate(zip(tree_leaves(gc), tree_leaves(gp))):
        assert bool(torch.isfinite(a).all()) and float(b.abs().max()) > 0, i
        scaled_close(a.cpu(), b, TOL["float32"], f"step 1 grad leaf {i}")
    adam_close(tree_map(lambda x: x.cpu(), pc), tree_map(lambda x: x.numpy(), pp),
               TOL["float32"], RWKV_LR, 3, "params after 3 steps", share=5e-5)


@pytest.mark.gpu
def test_gpu_rwkv6_train_steps_reproducible(cuda):
    """bf16 compute: two runs of three steps from one seed on the card give
    the same losses and parameters, bit for bit (no atomics in the
    linear_scan backward: du is summed over the batch in order)."""
    _, tcfg = configs("rwkv6_3b", compute="bfloat16")
    params = tdec.init_params(tcfg, torch.Generator().manual_seed(0))
    (pa, la, _, _), (pb, lb, _, _) = (_rwkv_steps(tcfg, params, cuda) for _ in range(2))
    assert la == lb and all(np.isfinite(la))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(pa), tree_leaves(pb)))
