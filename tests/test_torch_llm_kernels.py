"""repro_torch's flash_attention and linear_scan against repro's, and
against their plain versions on the card.

On the CPU the port's wrappers take the plain PyTorch versions; those
are held to the reference's Pallas kernels (interpret mode) and oracles
on the same numpy inputs, at the reference's tolerances
(tests/test_kernels.py): flash_attention 2e-5 in fp32 and 2e-2 in bf16,
linear_scan 2e-4 in fp32 and 3e-2 in bf16.  The tests marked ``gpu``
hold the CUDA kernels to the plain versions on an H100 and skip
themselves (inside the ``cuda`` fixture) elsewhere:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_*.py
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs a test process per core

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import ops as jfa_ops, ref as jfa_ref  # noqa: E402
from repro.kernels.flash_attention.kernel import flash_attention as jflash  # noqa: E402
from repro.kernels.linear_scan import kernel as jls_kernel, ref as jls_ref  # noqa: E402
from repro.models.recurrence import linear_recurrence as jlinear_recurrence  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref  # noqa: E402
from repro_torch.kernels.linear_scan import ops as ls_ops, ref as ls_ref  # noqa: E402

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FA_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LS_TOL = {"float32": 2e-4, "bfloat16": 3e-2}


def randn(seed, shape, dtype="float32"):
    """The same numbers for both packages: numpy draws, rounded to dtype."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return np.array(jnp.asarray(x, dtype).astype(jnp.float32)) if dtype != "float32" else x


def both(x, dtype="float32"):
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(TORCH_DT[dtype])


def close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ------------------------------------------------------- flash attention ---

class TestFlashAttentionPlain:
    @pytest.mark.parametrize("S,bq,bk", [(128, 64, 64), (256, 128, 64)])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_pallas_and_oracle(self, S, bq, bk, dtype):
        BH, D = 3, 64
        (jq, q), (jk, k), (jv, v) = (both(randn(i, (BH, S, D), dtype), dtype) for i in range(3))
        got = fa_ref.attention(q, k, v)
        assert got.dtype == TORCH_DT[dtype]
        close(got, jflash(jq, jk, jv, bq=bq, bk=bk), FA_TOL[dtype])   # Pallas, interpret
        close(got, jfa_ref.attention(jq, jk, jv), FA_TOL[dtype])

    @pytest.mark.parametrize("window", [32, 64])
    def test_sliding_window(self, window):
        BH, S, D = 2, 128, 32
        (jq, q), (jk, k), (jv, v) = (both(randn(3 + i, (BH, S, D))) for i in range(3))
        got = fa_ref.attention(q, k, v, window=window)
        close(got, jflash(jq, jk, jv, bq=64, bk=64, window=window), 2e-5)
        close(got, jfa_ref.attention(jq, jk, jv, window=window), 2e-5)

    @pytest.mark.parametrize("window", [None, 32])
    def test_gqa_layout_matches_reference_wrapper(self, window):
        B, S, H, KV, hd = 2, 128, 4, 2, 32
        jq, q = both(randn(6, (B, S, H, hd)))
        (jk, k), (jv, v) = (both(randn(7 + i, (B, S, KV, hd))) for i in range(2))
        before = fa_ops.launches
        got = fa_ops.gqa_flash_attention(q, k, v, window=window)   # CPU: the plain version
        assert fa_ops.launches == before
        close(got, jfa_ops.gqa_flash_attention(jq, jk, jv, window=window, bq=64, bk=64), 2e-5)

    def test_ragged_sequence(self):
        """The Pallas wrapper needs S % bq == 0; the port takes any S."""
        B, S, H, KV, hd = 1, 100, 4, 1, 32
        q = torch.from_numpy(randn(9, (B, S, H, hd)))
        k, v = (torch.from_numpy(randn(10 + i, (B, S, KV, hd))) for i in range(2))
        got = fa_ops.gqa_flash_attention(q, k, v, window=40)
        def to_bh(x):
            x = np.repeat(x.numpy(), H // x.shape[2], 2)
            return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B * H, S, hd))
        want = jfa_ref.attention(to_bh(q), to_bh(k), to_bh(v), window=40)
        close(got.permute(0, 2, 1, 3).reshape(B * H, S, hd), want, 2e-5)

    def test_rejects_bad_inputs(self):
        q = torch.zeros(1, 8, 4, 32)
        with pytest.raises(ValueError):
            fa_ops.gqa_flash_attention(q, torch.zeros(1, 8, 3, 32), torch.zeros(1, 8, 3, 32))
        with pytest.raises(ValueError):
            fa_ops.gqa_flash_attention(q, q[:, :, :2], q[:, :, :2].double())
        with pytest.raises(ValueError):
            fa_ops.gqa_flash_attention(q, q, q, window=0)


# ----------------------------------------------------------- linear scan ---

def scan_inputs(seed, BH, S, K, Vd, dtype="float32", la_scale=0.2):
    q, k = randn(seed, (BH, S, K), dtype), randn(seed + 1, (BH, S, K), dtype)
    v = randn(seed + 2, (BH, S, Vd), dtype)
    la = -np.abs(randn(seed + 3, (BH, S, K))) * la_scale
    u = np.abs(randn(seed + 4, (BH, K)))
    return q, k, v, la.astype(np.float32), u


class TestLinearScanPlain:
    @pytest.mark.parametrize("S,chunk", [(64, 32), (128, 64)])
    @pytest.mark.parametrize("form", ["mamba", "rwkv"])
    def test_matches_pallas_and_oracle(self, S, chunk, form):
        q, k, v, la, u = scan_inputs(0, 4, S, 16, 8)
        J = [jnp.asarray(x) for x in (q, k, v, la)]
        T = [torch.from_numpy(x) for x in (q, k, v, la)]
        if form == "mamba":
            got = ls_ref.linear_scan(*T)
            pallas = jls_kernel.linear_scan(*J, chunk=chunk)
            oracle = jls_ref.linear_scan(*J)
        else:
            got = ls_ref.linear_scan(*T, torch.from_numpy(u), include_current=False)
            pallas = jls_kernel.linear_scan(*J, jnp.asarray(u), chunk=chunk,
                                            include_current=False)
            oracle = jls_ref.linear_scan(*J, jnp.asarray(u), include_current=False)
        close(got, pallas, 2e-4)
        close(got, oracle, 2e-4)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_dtypes(self, dtype):
        q, k, v, la, _ = scan_inputs(5, 2, 64, 8, 8, dtype, la_scale=0.1)
        got = ls_ref.linear_scan(*(torch.from_numpy(x).to(TORCH_DT[dtype]) for x in (q, k, v)),
                                 torch.from_numpy(la))
        assert got.dtype == TORCH_DT[dtype]
        J = [jnp.asarray(x, dtype) for x in (q, k, v)] + [jnp.asarray(la)]
        close(got, jls_kernel.linear_scan(*J, chunk=32), LS_TOL[dtype])
        close(got, jls_ref.linear_scan(*J), LS_TOL[dtype])

    @pytest.mark.parametrize("form", ["mamba", "rwkv"])
    def test_layer_wrapper_and_final_state_match_model_recurrence(self, form):
        """ops.recurrence (y and the final state, from an initial state)
        against repro.models.recurrence.linear_recurrence(decay_per='dim')."""
        B, S, H, K, Vd = 2, 64, 2, 8, 8
        rs = np.random.RandomState(12)
        q, k = rs.randn(B, S, H, K).astype(np.float32), rs.randn(B, S, H, K).astype(np.float32)
        v = rs.randn(B, S, H, Vd).astype(np.float32)
        la = (-np.abs(rs.randn(B, S, H, K)) * 0.2).astype(np.float32)
        u = np.abs(rs.randn(H, K)).astype(np.float32) if form == "rwkv" else None
        s0 = rs.randn(B, H, K, Vd).astype(np.float32)
        cur = form == "mamba"
        want_y, want_s = jlinear_recurrence(
            *(jnp.asarray(x) for x in (q, k, v, la)), u=None if u is None else jnp.asarray(u),
            include_current=cur, initial_state=jnp.asarray(s0), chunk=32, decay_per="dim")
        got_y, got_s = ls_ops.recurrence(
            *(torch.from_numpy(x) for x in (q, k, v, la)),
            None if u is None else torch.from_numpy(u), include_current=cur,
            initial_state=torch.from_numpy(s0))
        assert got_s.dtype == torch.float32 and got_s.shape == (B, H, K, Vd)
        close(got_y, want_y, 2e-4)
        close(got_s, want_s, 2e-4)

    def test_no_overflow_where_the_factorised_form_does(self):
        """la = -2 over a chunk of 64 sums to -128: the reference kernel's
        k * exp(-cumsum) overflows fp32 there; the port's exact recurrence
        stays finite and matches the sequential oracle."""
        BH, S, K, Vd = 2, 128, 8, 8
        q, k, v, _, u = scan_inputs(20, BH, S, K, Vd)
        la = np.full((BH, S, K), -2.0, np.float32)
        J = [jnp.asarray(x) for x in (q, k, v, la)]
        for cur in (True, False):
            uu = None if cur else u
            got = ls_ref.linear_scan(*(torch.from_numpy(x) for x in (q, k, v, la)),
                                     None if uu is None else torch.from_numpy(uu),
                                     include_current=cur)
            assert bool(torch.isfinite(got).all())
            close(got, jls_ref.linear_scan(*J, None if uu is None else jnp.asarray(uu),
                                           include_current=cur), 2e-4)

    def test_clamps_log_decay(self):
        q, k, v, _, _ = scan_inputs(30, 1, 16, 4, 4)
        la = np.full((1, 16, 4), -30.0, np.float32)
        got = ls_ref.linear_scan(*(torch.from_numpy(x) for x in (q, k, v, la)))
        clamped = ls_ref.linear_scan(*(torch.from_numpy(x) for x in (q, k, v)),
                                     torch.full((1, 16, 4), ls_ref.LOG_A_MIN))
        assert torch.equal(got, clamped)

    def test_rejects_bad_inputs(self):
        q = torch.zeros(1, 4, 2, 8)
        with pytest.raises(ValueError):
            ls_ops.recurrence(q, q, q, q, torch.zeros(3, 8))
        with pytest.raises(ValueError):
            ls_ops.recurrence(q, q, q, q[:, :3])
        with pytest.raises(ValueError):
            ls_ops.recurrence(q, q, q, q, initial_state=torch.zeros(1, 2, 8, 4))


# ------------------------------------------------------------ on the card ---

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on an H100 host)")
    try:
        build.nvcc_path()
        build.require_hopper()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,hd,window", [
    (2, 256, 8, 2, 128, None), (1, 1000, 4, 1, 64, None), (2, 300, 4, 4, 32, 64),
    (1, 512, 6, 2, 128, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_flash_attention_matches_plain(cuda, B, S, H, KV, hd, window, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    dt = TORCH_DT[dtype]
    q = torch.randn(B, S, H, hd, generator=g, device=cuda).to(dt)
    k, v = (torch.randn(B, S, KV, hd, generator=g, device=cuda).to(dt) for _ in range(2))
    before = fa_ops.launches
    got = fa_ops.gqa_flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1 and got.dtype == dt
    want = fa_ref.gqa_attention(q, k, v, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=FA_TOL[dtype], atol=FA_TOL[dtype])
    # strided inputs (views of a fused qkv projection) give the same result
    qkv = torch.cat([q, k, v], dim=2)
    got2 = fa_ops.gqa_flash_attention(qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:],
                                      window=window)
    assert torch.equal(got, got2)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,K,V", [(2, 200, 3, 64, 64), (1, 77, 2, 32, 16), (1, 64, 2, 8, 40)])
@pytest.mark.parametrize("form", ["mamba", "rwkv"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_linear_scan_matches_plain(cuda, B, S, H, K, V, form, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    dt = TORCH_DT[dtype]
    q, k = (torch.randn(B, S, H, K, generator=g, device=cuda).to(dt) for _ in range(2))
    v = torch.randn(B, S, H, V, generator=g, device=cuda).to(dt)
    la = -torch.rand(B, S, H, K, generator=g, device=cuda) * 9.0   # reaches the clamp
    u = torch.rand(H, K, generator=g, device=cuda) if form == "rwkv" else None
    s0 = torch.randn(B, H, K, V, generator=g, device=cuda)
    cur = form == "mamba"
    before = ls_ops.launches
    y, s = ls_ops.recurrence(q, k, v, la, u, include_current=cur, initial_state=s0)
    torch.cuda.synchronize()
    assert ls_ops.launches == before + 1 and y.dtype == dt
    wy, ws = ls_ref.recurrence(q, k, v, la, u, include_current=cur, initial_state=s0)
    torch.testing.assert_close(y.float(), wy.float(), rtol=LS_TOL[dtype], atol=LS_TOL[dtype])
    torch.testing.assert_close(s, ws, rtol=2e-4, atol=2e-4)
