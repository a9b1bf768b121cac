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

import jax  # noqa: E402
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


class TestFlashAttentionGrad:
    """The autograd Function around the kernels, on the CPU: its gradient
    (the plain backward, autograd through ``ref.gqa_attention``) against
    ``jax.vjp`` of the reference's ``ref.attention`` on the same inputs,
    its vmap rule against a loop, and a float64 gradcheck.  fp32 sums in
    another order: 1e-5 of the gradients' scale."""

    @staticmethod
    def _ref_vjp(q, k, v, do, window):
        B, S, H, hd = q.shape
        G = H // k.shape[2]

        def attn(jq, jk, jv):
            to_bh = lambda x: jnp.transpose(x, (0, 2, 1, 3)).reshape(B * H, S, hd)
            o = jfa_ref.attention(to_bh(jq), to_bh(jnp.repeat(jk, G, 2)),
                                  to_bh(jnp.repeat(jv, G, 2)), window=window)
            return jnp.transpose(o.reshape(B, H, S, hd), (0, 2, 1, 3))

        _, vjp = jax.vjp(attn, *(jnp.asarray(x) for x in (q, k, v)))
        return vjp(jnp.asarray(do))

    @pytest.mark.parametrize("window", [None, 24])
    @pytest.mark.parametrize("H,KV", [(4, 2), (4, 4)])
    def test_grads_match_reference(self, window, H, KV):
        B, S, hd = 2, 64, 32
        q = randn(20, (B, S, H, hd))
        k, v = (randn(21 + i, (B, S, KV, hd)) for i in range(2))
        do = randn(23, (B, S, H, hd))
        tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
        before = fa_ops.bwd_launches
        o = fa_ops.gqa_flash_attention(tq, tk, tv, window=window)
        got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
        assert fa_ops.bwd_launches == before            # CPU: the plain backward
        for g, w in zip(got, self._ref_vjp(q, k, v, do, window)):
            w = _np(w)
            assert np.abs(_np(g) - w).max() <= 1e-5 * np.abs(w).max()

    def test_bf16_grads_in_the_input_dtype(self):
        B, S, H, KV, hd = 1, 40, 4, 2, 32
        q, k, v = (torch.from_numpy(randn(30 + i, (B, S, h, hd), "bfloat16")).to(torch.bfloat16)
                   .requires_grad_(True) for i, h in enumerate((H, KV, KV)))
        o = fa_ops.gqa_flash_attention(q, k, v)
        got = torch.autograd.grad(o.float().sum(), (q, k, v))
        assert all(g.dtype == torch.bfloat16 for g in got)
        want = fa_ref.gqa_attention_bwd(q.detach(), k.detach(), v.detach(), torch.ones_like(o))
        for g, w in zip(got, want):
            assert torch.equal(g, w)

    @pytest.mark.parametrize("window", [None, 5])
    def test_vmap_equals_a_loop(self, window):
        n, B, S, H, KV, hd = 3, 2, 20, 4, 2, 32
        q = torch.from_numpy(randn(40, (n, B, S, H, hd))).requires_grad_(True)
        k = torch.from_numpy(randn(41, (n, B, S, KV, hd))).requires_grad_(True)
        v = torch.from_numpy(randn(42, (B, S, KV, hd)))           # shared: in_dim None
        f = lambda a, b: fa_ops.gqa_flash_attention(a, b, v, window=window)
        o = torch.func.vmap(f)(q, k)
        gq, gk = torch.autograd.grad(o.square().sum(), (q, k))
        q2, k2 = (x.detach().requires_grad_(True) for x in (q, k))
        o2 = torch.stack([f(q2[i], k2[i]) for i in range(n)])
        gq2, gk2 = torch.autograd.grad(o2.square().sum(), (q2, k2))
        for a, b in ((o, o2), (gq, gq2), (gk, gk2)):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("window", [None, 3])
    def test_gradcheck_float64(self, window):
        g = torch.Generator().manual_seed(0)
        q = torch.randn(1, 7, 2, 32, dtype=torch.float64, generator=g, requires_grad=True)
        k, v = (torch.randn(1, 7, 1, 32, dtype=torch.float64, generator=g, requires_grad=True)
                for _ in range(2))
        assert torch.autograd.gradcheck(
            lambda a, b, c: fa_ops.gqa_flash_attention(a, b, c, window=window), (q, k, v))

    def test_no_grad_forward_is_the_plain_forward(self):
        q = torch.from_numpy(randn(50, (1, 16, 4, 32)))
        k, v = (torch.from_numpy(randn(51 + i, (1, 16, 2, 32))) for i in range(2))
        with torch.no_grad():
            got = fa_ops.gqa_flash_attention(q, k, v)
        assert torch.equal(got, fa_ref.gqa_attention(q, k, v)) and not got.requires_grad


def _qkv_views(B, S, H, KV, hd, dtype, lead=0, pad=0):
    """q, k, v as views of one fused (B, S, lead + (H + 2 KV) hd + pad)
    buffer, as a fused qkv projection gives them."""
    buf = torch.zeros(B, S, lead + (H + 2 * KV) * hd + pad, dtype=dtype)
    w = buf[..., lead:lead + (H + 2 * KV) * hd].unflatten(-1, (H + 2 * KV, hd))
    return w[:, :, :H], w[:, :, H:H + KV], w[:, :, H + KV:]


class TestFlashAttentionLayout:
    """The wrapper's decision to copy an input the bf16 kernel's 16-byte
    cp.async rows cannot read in place (ops.needs_copy)."""

    @pytest.mark.parametrize("case,want", [
        ("contiguous", False), ("fused_qkv_views", False), ("offset_one_element", True),
        ("row_stride_not_16_bytes", True), ("head_dim_strided", True),
        ("fp32_offset_one_element", False), ("fp32_head_dim_strided", True)])
    def test_needs_copy(self, case, want):
        B, S, H, KV, hd = 2, 16, 4, 2, 32
        bf = torch.bfloat16
        if case == "contiguous":
            xs = [torch.zeros(B, S, H, hd, dtype=bf)]
        elif case == "fused_qkv_views":
            xs = list(_qkv_views(B, S, H, KV, hd, bf))
        elif case == "offset_one_element":       # base 2 bytes past an aligned one
            xs = [torch.zeros(B * S * H * hd + 1, dtype=bf)[1:].view(B, S, H, hd)]
        elif case == "row_stride_not_16_bytes":  # rows of (H + 2 KV) hd + 1 elements
            xs = list(_qkv_views(B, S, H, KV, hd, bf, pad=1))
        elif case == "head_dim_strided":
            xs = [torch.zeros(B, S, H, 2 * hd, dtype=bf)[..., ::2]]
        elif case == "fp32_offset_one_element":  # the fp32 route reads single elements
            xs = list(_qkv_views(B, S, H, KV, hd, torch.float32, lead=1, pad=1))
        else:
            xs = [torch.zeros(B, S, H, 2 * hd)[..., ::2]]
        assert [fa_ops.needs_copy(x) for x in xs] == [want] * len(xs)
        if want:   # what the wrapper hands the kernel instead
            assert not any(fa_ops.needs_copy(x.clone(memory_format=torch.contiguous_format))
                           for x in xs)

    def test_unaligned_views_give_the_contiguous_result(self):
        B, S, H, KV, hd = 1, 40, 4, 2, 32
        q, k, v = _qkv_views(B, S, H, KV, hd, torch.float32, lead=1, pad=3)
        rs = np.random.RandomState(8)
        for x in (q, k, v):
            x.copy_(torch.from_numpy(rs.randn(*x.shape).astype(np.float32)))
        got = fa_ops.gqa_flash_attention(q, k, v, window=9)
        want = fa_ops.gqa_flash_attention(*(x.contiguous() for x in (q, k, v)), window=9)
        assert torch.equal(got, want)


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


def _to_bh(x):
    """(B, S, H, .) numpy -> (B*H, S, .), the reference oracle's layout."""
    B, S, H = x.shape[:3]
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(B * H, S, -1))


class TestLinearScanChunkedModel:
    """ref.chunked, the plain model of the bf16 kernel's chunked form
    (chunks of 32, cut at 16 and again at 8 steps, the decay of each pair
    of blocks factored about the step between them), against the
    sequential oracles."""

    @staticmethod
    def inputs(seed, B, S, H, K, Vd, la):
        rs = np.random.RandomState(seed)
        q, k = (rs.randn(B, S, H, K).astype(np.float32) for _ in range(2))
        v = rs.randn(B, S, H, Vd).astype(np.float32)
        if la == "clamp":     # at or below the clamp everywhere
            la = (-8.0 - 4.0 * np.abs(rs.randn(B, S, H, K))).astype(np.float32)
        else:
            la = (-np.abs(rs.randn(B, S, H, K)) * 0.5).astype(np.float32)
        u = np.abs(rs.randn(H, K)).astype(np.float32)
        s0 = rs.randn(B, H, K, Vd).astype(np.float32)
        return q, k, v, la, u, s0

    @pytest.mark.parametrize("S", [31, 33, 65, 1000])
    @pytest.mark.parametrize("form", ["mamba", "rwkv"])
    def test_matches_sequential_oracles(self, S, form):
        B, H, K, Vd = 2, 2, 8, 8
        q, k, v, la, u, s0 = self.inputs(40 + S, B, S, H, K, Vd, "model")
        cur = form == "mamba"
        uu = None if cur else u
        T = [torch.from_numpy(x) for x in (q, k, v, la)]
        tu = None if uu is None else torch.from_numpy(uu)
        exps = []
        y, st = ls_ref.chunked(*T, tu, include_current=cur,
                               initial_state=torch.from_numpy(s0), exponents=exps)
        wy, ws = ls_ref.recurrence(*T, tu, include_current=cur,
                                   initial_state=torch.from_numpy(s0))
        close(y, wy, 2e-4)
        close(st, ws, 2e-4)
        assert exps and max(exps) <= 0.0
        # the JAX package's oracle has no initial state: compare from zeros
        y0, _ = ls_ref.chunked(*T, tu, include_current=cur)
        jy = jls_ref.linear_scan(*(jnp.asarray(_to_bh(x)) for x in (q, k, v, la)),
                                 None if uu is None else jnp.asarray(np.tile(uu, (B, 1))),
                                 include_current=cur)
        close(_to_bh(y0.numpy()), jy, 2e-4)

    @pytest.mark.parametrize("form", ["mamba", "rwkv"])
    def test_finite_at_the_clamp_where_the_factorised_form_is_not(self, form):
        """la <= -8 everywhere: a chunk of 32 sums to -256 or less.  The
        chunked model stays finite and takes no positive exponent; the
        reference kernel's k * exp(-cum) overflows there."""
        B, S, H, K, Vd = 1, 64, 2, 8, 8
        q, k, v, la, u, s0 = self.inputs(7, B, S, H, K, Vd, "clamp")
        cur = form == "mamba"
        uu = None if cur else u
        T = [torch.from_numpy(x) for x in (q, k, v, la)]
        tu = None if uu is None else torch.from_numpy(uu)
        exps = []
        y, st = ls_ref.chunked(*T, tu, include_current=cur,
                               initial_state=torch.from_numpy(s0), exponents=exps)
        assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
        assert max(exps) <= 0.0 and min(exps) <= -256.0
        wy, ws = ls_ref.recurrence(*T, tu, include_current=cur,
                                   initial_state=torch.from_numpy(s0))
        close(y, wy, 2e-4)
        close(st, ws, 2e-4)
        J = [jnp.asarray(_to_bh(x)) for x in (q, k, v, la)]
        ju = None if uu is None else jnp.asarray(np.tile(uu, (B, 1)))
        y0, _ = ls_ref.chunked(*T, tu, include_current=cur)
        close(_to_bh(y0.numpy()), jls_ref.linear_scan(*J, ju, include_current=cur), 2e-4)
        pallas = jls_kernel.linear_scan(*J, ju, chunk=32, include_current=cur)
        assert not bool(np.isfinite(np.asarray(pallas)).all())



class TestLinearScanLayout:
    """The wrapper's preparation of what the bf16 kernel's 16-byte
    cp.async rows read (ops.needs_copy, ops.kernel_operands)."""

    @pytest.mark.parametrize("case,want", [
        ("contiguous", False), ("layer_projection", False), ("offset_one_element", True),
        ("row_stride_not_16_bytes", True), ("last_dim_strided", True),
        ("la_offset_one_float", True), ("fp32_offset_one_element", False)])
    def test_needs_copy(self, case, want):
        B, S, H, K = 2, 16, 3, 64
        bf = torch.bfloat16
        rows16 = case != "fp32_offset_one_element"
        if case == "contiguous":
            x = torch.zeros(B, S, H, K, dtype=bf)
        elif case == "layer_projection":        # models/recurrence.py: (B, S, H*K) -> heads
            x = torch.zeros(B, S, H * K, dtype=bf).reshape(B, S, H, K)
        elif case == "offset_one_element":      # base 2 bytes past an aligned one
            x = torch.zeros(B * S * H * K + 1, dtype=bf)[1:].view(B, S, H, K)
        elif case == "row_stride_not_16_bytes":
            x = torch.zeros(B, S, H, K + 1, dtype=bf)[..., :K]
        elif case == "last_dim_strided":
            x = torch.zeros(B, S, H, 2 * K, dtype=bf)[..., ::2]
        elif case == "la_offset_one_float":     # la is fp32 beside bf16 q/k/v
            x = torch.zeros(B * S * H * K + 1)[1:].view(B, S, H, K)
        else:                                   # the fp32 route reads single elements
            x = torch.zeros(B * S * H * K + 1)[1:].view(B, S, H, K)
        assert ls_ops.needs_copy(x, rows16) == want
        if want:   # what the wrapper hands the kernel instead
            assert not ls_ops.needs_copy(x.clone(memory_format=torch.contiguous_format), rows16)

    @pytest.mark.parametrize("layout", ["K12_V20", "offset_views", "fp32_K12_V20"])
    @pytest.mark.parametrize("form", ["mamba", "rwkv"])
    def test_kernel_operands_give_the_same_result(self, layout, form):
        """Padded and copied operands, sliced back as the wrapper does,
        give the plain version's y and final state on the caller's."""
        B, S, H = 2, 37, 3
        K, V = (12, 20) if layout != "offset_views" else (64, 64)
        dt = torch.float32 if layout.startswith("fp32") else torch.bfloat16
        rs = np.random.RandomState(13)
        if layout == "offset_views":   # q, k, v 2 bytes off a 16-byte boundary
            buf = torch.from_numpy(rs.randn(B, S, H, 1 + 3 * K).astype(np.float32)).to(dt)
            q, k, v = (buf[..., 1 + K * i:1 + K * (i + 1)] for i in range(3))
        else:
            q, k = (torch.from_numpy(rs.randn(B, S, H, K).astype(np.float32)).to(dt)
                    for _ in range(2))
            v = torch.from_numpy(rs.randn(B, S, H, V).astype(np.float32)).to(dt)
        la = -torch.from_numpy(np.abs(rs.randn(B, S, H, K)).astype(np.float32))
        u = torch.from_numpy(rs.rand(H, K).astype(np.float32)) if form == "rwkv" else None
        s0 = torch.from_numpy(rs.randn(B, H, K, V).astype(np.float32))
        kq, kk, kv, kla, ku, ks0 = ls_ops.kernel_operands(q, k, v, la, u, s0)
        rows16 = dt == torch.bfloat16
        assert not any(ls_ops.needs_copy(x, rows16) for x in (kq, kk, kv, kla))
        if rows16:
            assert kq.shape[-1] % 8 == 0 and kv.shape[-1] % 8 == 0
        else:
            assert (kq.shape[-1], kv.shape[-1]) == (K, V)
        cur = form == "mamba"
        y, st = ls_ref.recurrence(kq, kk, kv, kla, ku, include_current=cur, initial_state=ks0)
        wy, ws = ls_ref.recurrence(q, k, v, la, u, include_current=cur, initial_state=s0)
        torch.testing.assert_close(y[..., :V], wy)
        torch.testing.assert_close(st[:, :, :K, :V], ws)
        assert not st[:, :, K:].any() and not st[..., V:].any()   # padding stays zero


# the bf16 backward's launch plan: the chunks of a GQA group (ops.bwd_plan)
@pytest.mark.parametrize("B,S,H,KV,sms,want", [
    (4, 2048, 24, 2, 132, 3), (4, 1024, 36, 36, 132, 1), (1, 256, 12, 1, 132, 12),
    (2, 300, 4, 4, 132, 1), (8, 4096, 24, 2, 132, 1), (2, 1000, 24, 2, 132, 9)])
def test_bwd_plan_gives_two_waves_within_the_group(B, S, H, KV, sms, want):
    chunks = fa_ops.bwd_plan(B, S, H, KV, sms)
    blocks = -(-S // fa_ops.BWD_TILE) * KV * B
    assert chunks == want and 1 <= chunks <= H // KV
    assert chunks == H // KV or chunks * blocks >= 2 * sms * fa_ops.BWD_BLOCKS_PER_SM


@pytest.mark.parametrize("bad", ["o", "do", "k", "lse"])
def test_launch_bwd_rejects_mismatched_shapes(bad):
    """The backward's wrapper checks every shape before a pointer reaches
    the kernel (the check runs before any build, so on the CPU too)."""
    B, S, H, KV, hd = 1, 8, 4, 2, 32
    x = {"q": torch.zeros(B, S, H, hd), "k": torch.zeros(B, S, KV, hd),
         "v": torch.zeros(B, S, KV, hd), "o": torch.zeros(B, S, H, hd),
         "do": torch.zeros(B, S, H, hd), "lse": torch.zeros(B, H, S)}
    x[bad] = x[bad][..., :-1]
    with pytest.raises(ValueError, match="backward takes"):
        fa_ops._launch_bwd(x["q"], x["k"], x["v"], x["o"], x["do"], x["lse"], None)


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


# the new tiles' edges: flash_attention's 128-query and 64-key tiles,
# linear_scan's 32-step chunks and 16-step sub-chunks

@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 17, 127, 128, 129, 2047])
@pytest.mark.parametrize("hd", [64, 128])
def test_gpu_flash_attention_bf16_tile_edges(cuda, S, hd):
    B, H, KV = 1, 24, 2                      # starcoder2's group of G = 12
    g = torch.Generator(device=cuda).manual_seed(S)
    bf = torch.bfloat16
    q = torch.randn(B, S, H, hd, generator=g, device=cuda).to(bf)
    k, v = (torch.randn(B, S, KV, hd, generator=g, device=cuda).to(bf) for _ in range(2))
    got = fa_ops.gqa_flash_attention(q, k, v)
    want = fa_ref.gqa_attention(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), rtol=FA_TOL["bfloat16"],
                               atol=FA_TOL["bfloat16"])


@pytest.mark.gpu
@pytest.mark.parametrize("S,window", [(300, 1), (300, 37), (300, 100), (513, 191), (129, 64),
                                      (2047, 1000)])
def test_gpu_flash_attention_bf16_windows_ending_inside_a_tile(cuda, S, window):
    B, H, KV, hd = 2, 24, 2, 128
    g = torch.Generator(device=cuda).manual_seed(window)
    bf = torch.bfloat16
    q = torch.randn(B, S, H, hd, generator=g, device=cuda).to(bf)
    k, v = (torch.randn(B, S, KV, hd, generator=g, device=cuda).to(bf) for _ in range(2))
    got = fa_ops.gqa_flash_attention(q, k, v, window=window)
    want = fa_ref.gqa_attention(q, k, v, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=FA_TOL["bfloat16"],
                               atol=FA_TOL["bfloat16"])


@pytest.mark.gpu
def test_gpu_flash_attention_bf16_unaligned_view(cuda):
    """Views whose rows start 2 bytes past a 16-byte boundary are copied
    (ops.needs_copy) and give the contiguous inputs' result exactly."""
    B, S, H, KV, hd = 2, 200, 8, 2, 64
    g = torch.Generator(device=cuda).manual_seed(5)
    buf = torch.randn(B, S, 1 + (H + 2 * KV) * hd, generator=g, device=cuda).to(torch.bfloat16)
    w = buf[..., 1:].unflatten(-1, (H + 2 * KV, hd))
    q, k, v = w[:, :, :H], w[:, :, H:H + KV], w[:, :, H + KV:]
    assert all(fa_ops.needs_copy(x) for x in (q, k, v))
    before = fa_ops.launches
    got = fa_ops.gqa_flash_attention(q, k, v, window=77)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    want = fa_ops.gqa_flash_attention(*(x.contiguous() for x in (q, k, v)), window=77)
    assert torch.equal(got, want)
    torch.testing.assert_close(got.float(), fa_ref.gqa_attention(q, k, v, window=77).float(),
                               rtol=FA_TOL["bfloat16"], atol=FA_TOL["bfloat16"])


def _scan_case(cuda, seed, B, S, H, K, V, form, la_kind, dt=torch.bfloat16):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k = (torch.randn(B, S, H, K, generator=g, device=cuda).to(dt) for _ in range(2))
    v = torch.randn(B, S, H, V, generator=g, device=cuda).to(dt)
    if la_kind == "clamp":   # at or below the clamp everywhere
        la = -8.0 - 4.0 * torch.rand(B, S, H, K, generator=g, device=cuda)
    else:                    # reaches the clamp now and then
        la = -torch.rand(B, S, H, K, generator=g, device=cuda) * 9.0
    u = torch.rand(H, K, generator=g, device=cuda) if form == "rwkv" else None
    s0 = torch.randn(B, H, K, V, generator=g, device=cuda)
    return q, k, v, la, u, s0


def _check_scan(q, k, v, la, u, s0, cur):
    before = ls_ops.launches
    y, s = ls_ops.recurrence(q, k, v, la, u, include_current=cur, initial_state=s0)
    torch.cuda.synchronize()
    assert ls_ops.launches == before + 1 and y.dtype == v.dtype
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    wy, ws = ls_ref.recurrence(q, k, v, la, u, include_current=cur, initial_state=s0)
    tol = LS_TOL["bfloat16" if v.dtype == torch.bfloat16 else "float32"]
    torch.testing.assert_close(y.float(), wy.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(s, ws, rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 1000])
@pytest.mark.parametrize("form", ["mamba", "rwkv"])
def test_gpu_linear_scan_bf16_chunk_edges(cuda, S, form):
    _check_scan(*_scan_case(cuda, S, 2, S, 3, 64, 64, form, "model"), form == "mamba")


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["mamba", "rwkv"])
def test_gpu_linear_scan_bf16_at_the_clamp(cuda, form):
    _check_scan(*_scan_case(cuda, 9, 2, 257, 3, 64, 64, form, "clamp"), form == "mamba")


@pytest.mark.gpu
@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("form", ["mamba", "rwkv"])
def test_gpu_linear_scan_bf16_v_slices(cuda, split, form):
    """B * H on both sides of the launch's rule: two 32-column V slices
    per (b, h) where 2 B H blocks find an SM each, else one block."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    H = 4
    B = sms // (2 * H) if split else sms // H + 1
    _check_scan(*_scan_case(cuda, 14, B, 45, H, 64, 64, form, "model"), form == "mamba")


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["K12_V20", "offset_views"])
def test_gpu_linear_scan_bf16_rows_not_16_byte_aligned(cuda, layout):
    """K, V not multiples of 8, or views 2 bytes off a 16-byte boundary:
    the wrapper zero-pads K and V and copies the views (kernel_operands)
    before the kernel's 16-byte cp.async reads them."""
    if layout == "K12_V20":
        q, k, v, la, u, s0 = _scan_case(cuda, 11, 2, 70, 3, 12, 20, "rwkv", "model")
    else:
        q, k, v, la, u, s0 = _scan_case(cuda, 12, 2, 70, 3, 64, 64, "rwkv", "model")
        buf = torch.zeros(2, 70, 3, 1 + 3 * 64, dtype=torch.bfloat16, device=cuda)
        for i, x in enumerate((q, k, v)):
            buf[..., 1 + 64 * i:1 + 64 * (i + 1)] = x
        q, k, v = (buf[..., 1 + 64 * i:1 + 64 * (i + 1)] for i in range(3))
    _check_scan(q, k, v, la, u, s0, False)


# the backward kernel (csrc/flash_attention_bwd.cu) against the plain
# backward: fp32 at 1e-4 of the gradients' scale (sums in another order,
# the forward's exp against the backward's), bf16 at 2e-2 (the gradients
# are rounded to bf16, as the forward's output is); the scale is floored
# at 1e-2, since at S = 1 the exact dq and dk are 0 (one key: the softmax
# is constant) and the kernel's are its rounding, about 1e-7
FA_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _grad_case(cuda, seed, B, S, H, KV, hd, dt):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(B, S, H, hd, generator=g, device=cuda).to(dt)
    k, v = (torch.randn(B, S, KV, hd, generator=g, device=cuda).to(dt) for _ in range(2))
    do = torch.randn(B, S, H, hd, generator=g, device=cuda).to(dt)
    return q, k, v, do


def _kernel_grads(q, k, v, do, window):
    req = [x.detach().requires_grad_(True) for x in (q, k, v)]
    o = fa_ops.gqa_flash_attention(*req, window=window)
    return torch.autograd.grad(o, req, do)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,hd,window", [
    (2, 256, 8, 2, 128, None), (1, 1000, 4, 1, 64, None), (2, 300, 4, 4, 32, 64),
    (1, 512, 6, 2, 128, 100), (1, 65, 36, 36, 64, None), (1, 1, 2, 1, 32, None)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_flash_attention_backward_matches_plain(cuda, B, S, H, KV, hd, window, dtype):
    dt = TORCH_DT[dtype]
    q, k, v, do = _grad_case(cuda, S, B, S, H, KV, hd, dt)
    before = fa_ops.bwd_launches
    got = _kernel_grads(q, k, v, do, window)
    torch.cuda.synchronize()
    assert fa_ops.bwd_launches == before + 1
    want = fa_ref.gqa_attention_bwd(q, k, v, do, window=window)
    for a, b in zip(got, want):
        assert a.dtype == dt and bool(torch.isfinite(a).all())
        err = float((a.float() - b.float()).abs().max())
        assert err <= FA_BWD_TOL[dtype] * max(float(b.float().abs().max()), 1e-2), err


def _check_bwd(cuda, seed, B, S, H, KV, hd, window, dtype):
    """The kernel's gradients against the plain backward, each within
    FA_BWD_TOL of its scale.  The scale is floored at 0.1: where every
    query sees only its own key (S = 1, window 1) the exact dq and dk are
    0 and the kernel's are the rounding of dP - D, two sums of hd products
    (1e-6 to 3e-6 in fp32 at hd 64, card run); every other scale must lie
    above 0.1, so that the floor binds nowhere else."""
    dt = TORCH_DT[dtype]
    q, k, v, do = _grad_case(cuda, seed, B, S, H, KV, hd, dt)
    before = fa_ops.bwd_launches
    got = _kernel_grads(q, k, v, do, window)
    torch.cuda.synchronize()
    assert fa_ops.bwd_launches == before + 1
    want = fa_ref.gqa_attention_bwd(q, k, v, do, window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dt and bool(torch.isfinite(a).all()), name
        err, scale = float((a.float() - b.float()).abs().max()), float(b.float().abs().max())
        assert scale > 0.1 or (name != "dv" and (S == 1 or window == 1)), (name, scale)
        assert err <= FA_BWD_TOL[dtype] * max(scale, 0.1), (name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 129, 1000])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_flash_attention_backward_tile_edges(cuda, S, hd, dtype):
    """S on either side of the bf16 route's 64-row tiles, at every head
    dim, with a group of 3 query heads split over chunks."""
    _check_bwd(cuda, S + hd, 1, S, 3, 1, hd, None, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("S,window", [(300, 1), (300, 37), (300, 100), (513, 191), (129, 64),
                                      (1000, 65)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_flash_attention_backward_windows_ending_inside_a_tile(cuda, S, window, dtype):
    _check_bwd(cuda, window, 2, S, 6, 2, 64, window, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 300, 12, 12, 64),     # G = 1: dK and dV written directly
    (2, 257, 6, 2, 128),      # G = 3
    (1, 200, 12, 1, 32),      # G = 12, B H far too small to fill the card: 12 chunks
    (4, 512, 24, 2, 128)])    # starcoder2's group of 12 at a short S
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_flash_attention_backward_gqa_groups(cuda, B, S, H, KV, hd, dtype):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    chunks = fa_ops.bwd_plan(B, S, H, KV, sms)
    assert 1 <= chunks <= H // KV and (chunks > 1) == (H // KV > 1)
    _check_bwd(cuda, H, B, S, H, KV, hd, None, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,hd", [(2, 700, 24, 2, 128), (4, 2048, 24, 2, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_flash_attention_backward_reproducible(cuda, B, S, H, KV, hd, dtype):
    """No atomics: two backward launches on one input give the same bits,
    also at starcoder2_3b's shape, where the bf16 route splits each GQA
    group over chunks and sums their partials."""
    q, k, v, do = _grad_case(cuda, 7, B, S, H, KV, hd, TORCH_DT[dtype])
    a, b = _kernel_grads(q, k, v, do, None), _kernel_grads(q, k, v, do, None)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
def test_gpu_serving_forward_unchanged_by_the_lse(cuda):
    """The forward with grad enabled (writing the logsumexp) and under
    no_grad (serving: no lse) give the same output bits."""
    q, k, v, _ = _grad_case(cuda, 8, 2, 333, 8, 2, 64, torch.bfloat16)
    with torch.no_grad():
        served = fa_ops.gqa_flash_attention(q, k, v)
    trained = fa_ops.gqa_flash_attention(*(x.requires_grad_(True) for x in (q, k, v)))
    assert torch.equal(served, trained.detach())


@pytest.mark.gpu
def test_gpu_flash_attention_vmap_equals_a_loop(cuda):
    q, k, v, _ = _grad_case(cuda, 9, 3, 96, 4, 2, 32, torch.float32)
    q = q.requires_grad_(True)
    f = lambda a: fa_ops.gqa_flash_attention(a.unsqueeze(0), k[:1], v[:1])[0]
    o = torch.func.vmap(f)(q)
    g, = torch.autograd.grad(o.sum(), q)
    q2 = q.detach().requires_grad_(True)
    o2 = torch.stack([f(q2[i]) for i in range(3)])
    g2, = torch.autograd.grad(o2.sum(), q2)
    assert torch.equal(o, o2) and torch.equal(g, g2)
