"""Kernel 7 and the Mamba-2 mixer on the CPU: the plain version of the
port's SSD chunk kernel against the reference's Pallas kernel (interpret
mode) and its oracle, the bf16 inter-chunk scan against
``jax.lax.associative_scan``, and ``ssd_mixer``/``ssd_decode_step`` against
the model's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import mamba2 as jmamba
from repro.models import model as jmodel
from repro.models.layers import pack_bf16, unpack_bf16
from repro_torch.configs import get_config
from repro_torch.convert import bf16_from_bits, lm_params_from_numpy
from repro_torch.kernels import ops, ssd_scan
from repro_torch.models import mamba2 as tmamba

# f32 on both sides; only the order of the f32 sums differs (L terms of N
# products): 2e-5 x max|reference|.
TOL = 2e-5


def _inputs(bh, c, n_l, p, n, rate=0.1, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bh, c, n_l, p)).astype(np.float32)
    acs = np.cumsum(-rate * np.abs(rng.standard_normal((bh, c, n_l))), axis=-1).astype(np.float32)
    bm = rng.standard_normal((bh, c, n_l, n)).astype(np.float32)
    cm = rng.standard_normal((bh, c, n_l, n)).astype(np.float32)
    return x, acs, bm, cm


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def _ref(a) -> torch.Tensor:
    """A reference array as a tensor: its uint16 entries are bf16 bit patterns."""
    a = np.asarray(a)
    return bf16_from_bits(a) if a.dtype == np.uint16 else torch.from_numpy(np.array(a))


# the reference kernel test's shapes (tests/test_kernels.py) and the Zamba2
# chunk (L 256, N 64, P 64)
@pytest.mark.parametrize("bh,c,n_l,p,n", [(2, 3, 64, 32, 16), (1, 1, 128, 64, 32),
                                          (2, 2, 256, 64, 64)])
def test_plain_matches_pallas_kernel(bh, c, n_l, p, n):
    x, acs, bm, cm = _inputs(bh, c, n_l, p, n)
    y_want, s_want = jops.ssd_chunk(*(jnp.asarray(a) for a in (x, acs, bm, cm)))
    y, s = ssd_scan.ssd_chunk_plain(*(torch.from_numpy(a) for a in (x, acs, bm, cm)))
    _close(y, y_want)
    _close(s, s_want)


@pytest.mark.parametrize("n_l,p,n", [(32, 16, 16), (100, 48, 80)])
def test_plain_matches_oracle_per_chunk(n_l, p, n):
    x, acs, bm, cm = _inputs(2, 2, n_l, p, n, seed=1)
    y, s = ssd_scan.ssd_chunk_plain(*(torch.from_numpy(a) for a in (x, acs, bm, cm)))
    for i in range(2):
        for j in range(2):
            yr, sr = jref.ssd_chunk_ref(x[i, j], acs[i, j], bm[i, j], cm[i, j])
            _close(y[i, j], yr)
            _close(s[i, j], sr)


def test_steep_decay_stays_finite():
    """exp(A_i - A_j) overflows to inf above the diagonal here; like the TPU
    kernel's ``where``, the plain version never multiplies it in."""
    x, acs, bm, cm = _inputs(1, 2, 128, 16, 16, rate=20.0, seed=2)
    with np.errstate(over="ignore"):
        assert np.isinf(np.exp(acs[0, 0, :, None] - acs[0, 0, None, :])).any()
    y, s = ssd_scan.ssd_chunk_plain(*(torch.from_numpy(a) for a in (x, acs, bm, cm)))
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    y_want, s_want = jops.ssd_chunk(*(jnp.asarray(a) for a in (x, acs, bm, cm)))
    _close(y, y_want)
    _close(s, s_want)


def _bf16_bc(x, acs, bm, cm):
    """The inputs with B and C rounded to bf16: torch tensors (B, C in
    bf16) and the same values in f32 numpy."""
    tb, tc = (torch.from_numpy(a).to(torch.bfloat16) for a in (bm, cm))
    return (torch.from_numpy(x), torch.from_numpy(acs), tb, tc), (tb.float().numpy(),
                                                                  tc.float().numpy())


@pytest.mark.parametrize("bh,c,n_l,p,n", [(2, 3, 64, 32, 16), (2, 2, 256, 64, 64),
                                          (1, 2, 100, 48, 80)])
def test_plain_with_bf16_b_c_is_the_f32_plain_on_widened_values(bh, c, n_l, p, n):
    """B and C in bf16 are widened to f32 first: bit for bit the f32 plain
    version on the same values."""
    (tx, ta, tb, tc), _ = _bf16_bc(*_inputs(bh, c, n_l, p, n, seed=3))
    y, s = ssd_scan.ssd_chunk_plain(tx, ta, tb, tc)
    y32, s32 = ssd_scan.ssd_chunk_plain(tx, ta, tb.float(), tc.float())
    assert y.dtype == s.dtype == torch.float32
    assert torch.equal(y, y32) and torch.equal(s, s32)


@pytest.mark.parametrize("bh,c,n_l,p,n", [(2, 3, 64, 32, 16), (1, 2, 128, 64, 32)])
def test_plain_with_bf16_b_c_matches_pallas_kernel(bh, c, n_l, p, n):
    """The reference kernel fed the same bf16 B and C (it widens them
    inside, as the port's kernel does)."""
    x, acs, bm, cm = _inputs(bh, c, n_l, p, n, seed=4)
    targs, (b16, c16) = _bf16_bc(x, acs, bm, cm)
    y_want, s_want = jops.ssd_chunk(jnp.asarray(x), jnp.asarray(acs),
                                    jnp.asarray(b16).astype(jnp.bfloat16),
                                    jnp.asarray(c16).astype(jnp.bfloat16))
    y, s = ssd_scan.ssd_chunk_plain(*targs)
    _close(y, y_want)
    _close(s, s_want)


def test_bf16_mixer_hands_the_kernel_bf16_b_and_c(monkeypatch):
    """In a bf16 model B and C reach ``ops.ssd_chunk`` in bf16 (no f32
    copies); x and the decays stay f32."""
    cfg = get_config("zamba2-2.7b", smoke=True)
    from repro_torch.models.model import init_params

    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lp = {k: v[0, 1] for k, v in params["layers"].items()}
    seen = []

    def spy(x, a, b, c):
        seen.append((x.dtype, a.dtype, b.dtype, c.dtype))
        return ssd_scan.ssd_chunk_plain(x, a, b, c)

    monkeypatch.setattr(ops, "ssd_chunk", spy)
    x = torch.randn(2, 40, cfg.d_model, generator=torch.Generator().manual_seed(1))
    y, _ = tmamba.ssd_mixer(cfg, lp, x.to(torch.bfloat16))
    assert seen == [(torch.float32, torch.float32, torch.bfloat16, torch.bfloat16)]
    assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()


def _fp32_limit(n_terms: int, want) -> float:
    """The fp32 rule of ``chip_smoke.py::compare``: max(1e-5, 4 sqrt(n)
    2^-24) x max|plain| for n terms summed into one output."""
    return max(1e-5, 4 * n_terms ** 0.5 * 2.0 ** -24) * float(want.abs().max())


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32 (10 mantissa bits, half away from zero)
    by integer rounding of their bit patterns."""
    bits = (t.contiguous().view(torch.int32) + 0x1000) & -0x2000
    return bits.view(torch.float32)


def _plain_one_tf32_pass(x, a, bm, cm):
    """``ssd_chunk_plain`` with the operands of its three products rounded
    to TF32 (a tensor-core GEMM on one TF32 pass, f32 sums)."""
    x, a, bm, cm = (t.to(torch.float32) for t in (x, a, bm, cm))
    n = x.shape[2]
    causal = torch.ones((n, n), dtype=torch.bool).tril()
    decay = torch.where(causal, torch.exp(a[..., :, None] - a[..., None, :]), 0.0)
    scores = _tf32(cm) @ _tf32(bm).transpose(-1, -2)
    y = _tf32(scores * decay) @ _tf32(x)
    s = _tf32(bm * torch.exp(a[..., -1:] - a)[..., None]).transpose(-1, -2) @ _tf32(x)
    return y, s


def _f64_rounded(x, a, bm, cm):
    """The function in f64, rounded to f32: the correctly rounded kernel."""
    x, a, bm, cm = (t.double() for t in (x, a, bm, cm))
    n = x.shape[2]
    causal = torch.ones((n, n), dtype=torch.bool).tril()
    decay = torch.where(causal, torch.exp(a[..., :, None] - a[..., None, :]), 0.0)
    y = ((cm @ bm.transpose(-1, -2)) * decay) @ x
    s = (bm * torch.exp(a[..., -1:] - a)[..., None]).transpose(-1, -2) @ x
    return y.float(), s.float()


def test_fp32_rule_passes_f64_and_fails_one_tf32_pass():
    """The premise of the card's per-layer check of kernel 7: at the serving
    chunk (L 256, N = P 64, B and C bf16-valued) the fp32 rule passes the
    function correctly rounded and fails it computed on one TF32 pass, for
    y and for the state, each by a wide margin."""
    n_l, n = 256, 64
    (tx, ta, tb, tc), _ = _bf16_bc(*_inputs(2, 2, n_l, 64, n, seed=5))
    want = ssd_scan.ssd_chunk_plain(tx, ta, tb, tc)
    assert ta.dtype == torch.float32 and ta.abs().max() > 1.0  # real decays across the chunk
    limits = (_fp32_limit(n_l * n, want[0]), _fp32_limit(n_l, want[1]))
    for name, got, (lo, hi) in (("f64", _f64_rounded(tx, ta, tb, tc), (0.0, 0.1)),
                                ("tf32", _plain_one_tf32_pass(tx, ta, tb, tc), (3.0, 1e3))):
        for what, g, w, limit in zip(("y", "state"), got, want, limits):
            ratio = float((g - w).abs().max()) / limit
            assert lo <= ratio <= hi, (name, what, ratio)


def test_cpu_runs_the_plain_version_and_counts_no_launch():
    args = [torch.from_numpy(a) for a in _inputs(1, 2, 32, 16, 16)]
    before = ops.ssd_chunk.launches
    y, s = ops.ssd_chunk(*args)
    y2, s2 = ssd_scan.ssd_chunk_plain(*args)
    assert ops.ssd_chunk.launches == before
    assert torch.equal(y, y2) and torch.equal(s, s2)


def _jax_combine(e1, e2):  # the reference mixer's combine (models/mamba2.py)
    d1, s1 = e1
    d2, s2 = e2
    s = unpack_bf16(s1).astype(jnp.float32) * d2[..., None, None] + unpack_bf16(s2).astype(
        jnp.float32)
    return d1 * d2, pack_bf16(s.astype(jnp.bfloat16))


@pytest.mark.parametrize("n_chunks", [1, 2, 3, 5, 8, 13, 16])
def test_bf16_state_scan_is_the_references_bit_for_bit(n_chunks):
    rng = np.random.default_rng(n_chunks)
    d = np.exp(-np.abs(rng.standard_normal((2, n_chunks, 3)))).astype(np.float32)
    s = rng.standard_normal((2, n_chunks, 3, 8, 4)).astype(np.float32)
    jd, js = jax.lax.associative_scan(
        _jax_combine, (jnp.asarray(d), pack_bf16(jnp.asarray(s).astype(jnp.bfloat16))), axis=1)
    td, ts = tmamba.associative_scan(
        tmamba._combine_states, [torch.from_numpy(d), torch.from_numpy(s).to(torch.bfloat16)], 1)
    assert np.array_equal(np.asarray(jd), td.numpy())
    assert np.array_equal(np.asarray(unpack_bf16(js).astype(jnp.float32)), ts.float().numpy())


@pytest.fixture(scope="module")
def layer():
    """One Mamba layer of the zamba2 SMOKE config in f32, from the
    reference's init, on both sides."""
    jcfg = dataclasses.replace(jget_config("zamba2-2.7b", smoke=True), dtype="float32")
    tcfg = dataclasses.replace(get_config("zamba2-2.7b", smoke=True), dtype="float32")
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    return (jcfg, jax.tree_util.tree_map(lambda a: a[0, 1], jp["layers"]),
            tcfg, {k: v[0, 1] for k, v in tp["layers"].items()})


# One chunk (32) keeps the bf16 state out of y; from two chunks on, y reads
# states rounded to bf16, and the port's chunk states differ from the
# reference's in their last f32 bits (sums in another order), so a rounded
# state can land one bf16 ulp (2^-8) away. Through c . h that moves y by
# well under 1e-3 x max|y| (measured up to 6e-5); the final state is held
# element by element to one bf16 ulp (at most 2^-7 of the value).
@pytest.mark.parametrize("s,tol", [(32, 2e-5), (20, 2e-5), (64, 1e-3), (70, 1e-3), (128, 1e-3)])
def test_ssd_mixer_matches_model(layer, s, tol):
    jcfg, jp, tcfg, tp = layer
    x = np.random.default_rng(s).standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    y_want, st_want = jmamba.ssd_mixer(jcfg, jp, jnp.asarray(x), return_state=True)
    y, st = tmamba.ssd_mixer(tcfg, tp, torch.from_numpy(x), return_state=True)
    _close(y, y_want, tol)
    for name in ("conv_x", "conv_b", "conv_c"):  # bf16 roundings of f32 projections
        got, want = getattr(st, name).float().numpy(), _ref(getattr(st_want, name)).float().numpy()
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-6 * np.abs(want).max())
    h_want = np.asarray(st_want.h)
    np.testing.assert_allclose(st.h.numpy(), h_want, rtol=2.0 ** -7,
                               atol=1e-6 * np.abs(h_want).max())


def test_ssd_mixer_without_state_returns_none(layer):
    jcfg, _, tcfg, tp = layer
    x = torch.randn(1, 40, tcfg.d_model, generator=torch.Generator().manual_seed(0))
    y, st = tmamba.ssd_mixer(tcfg, tp, x)
    assert st is None and y.shape == x.shape


@pytest.mark.parametrize("seed", [0, 1])
def test_ssd_decode_step_matches_model(layer, seed):
    jcfg, jp, tcfg, tp = layer
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 1, jcfg.d_model)).astype(np.float32)
    km1, din, gn = jcfg.ssm_conv - 1, jcfg.d_inner, jcfg.ssm_ngroups * jcfg.ssm_state
    conv = [rng.standard_normal((3, km1, c)).astype(np.float32) for c in (din, gn, gn)]
    h = rng.standard_normal((3, jcfg.ssm_nheads, jcfg.ssm_headdim, jcfg.ssm_state)).astype(
        np.float32)
    jstate = jmamba.SsmState(*(pack_bf16(jnp.asarray(c).astype(jnp.bfloat16)) for c in conv),
                             h=jnp.asarray(h))
    y_want, st_want = jmamba.ssd_decode_step(jcfg, jp, jnp.asarray(x), jstate)
    tstate = tmamba.SsmState(*(_ref(a) for a in jstate))
    y, st = tmamba.ssd_decode_step(tcfg, tp, torch.from_numpy(x), tstate)
    _close(y, y_want, 1e-5)
    _close(st.h, st_want.h, 1e-5)
    for name in ("conv_x", "conv_b", "conv_c"):
        got, want = getattr(st, name), _ref(getattr(st_want, name))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), rtol=2.0 ** -7,
                                   atol=1e-6)


# -- the backward pass ---------------------------------------------------------

# (BH, C, L, P, N, rate): the shapes above and odd ones, a steep decay whose
# exp overflows above the diagonal included
BWD_SHAPES = [(2, 3, 64, 32, 16, 0.1), (1, 1, 128, 64, 32, 0.1), (2, 2, 32, 16, 16, 0.1),
              (1, 2, 50, 12, 20, 0.1), (2, 1, 17, 5, 3, 0.1)]
# f32 on both sides, sums in other orders: 1e-5 of each gradient's max|want|
BWD_TOL = 1e-5


def _bwd_case(bh, c, n_l, p, n, rate, seed=2):
    args = [torch.from_numpy(a) for a in _inputs(bh, c, n_l, p, n, rate=rate, seed=seed)]
    rng = np.random.default_rng(seed + 1)
    dy = torch.from_numpy(rng.standard_normal((bh, c, n_l, p)).astype(np.float32))
    ds = torch.from_numpy(rng.standard_normal((bh, c, n, p)).astype(np.float32))
    return args, dy, ds


@pytest.mark.parametrize("bh,c,n_l,p,n,rate", BWD_SHAPES + [(2, 2, 64, 16, 16, 8.0)])
def test_plain_backward_matches_autograd_of_plain_forward(bh, c, n_l, p, n, rate):
    args, dy, ds = _bwd_case(bh, c, n_l, p, n, rate)
    got = ssd_scan.ssd_chunk_bwd_plain(*args, dy, ds)
    leaves = [a.clone().requires_grad_() for a in args]
    want = torch.autograd.grad(ssd_scan.ssd_chunk_plain(*leaves), leaves, (dy, ds))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.isfinite(g).all()
        _close(g, w, BWD_TOL)


@pytest.mark.parametrize("bh,c,n_l,p,n,rate", BWD_SHAPES)
def test_plain_backward_matches_jax_vjp_of_oracle(bh, c, n_l, p, n, rate):
    args, dy, ds = _bwd_case(bh, c, n_l, p, n, rate)
    got = ssd_scan.ssd_chunk_bwd_plain(*args, dy, ds)
    for i in range(bh):
        for j in range(c):
            _, vjp = jax.vjp(jref.ssd_chunk_ref, *(jnp.asarray(a[i, j].numpy()) for a in args))
            want = vjp((jnp.asarray(dy[i, j].numpy()), jnp.asarray(ds[i, j].numpy())))
            for g, w in zip(got, want):
                _close(g[i, j], w, BWD_TOL)


def test_plain_backward_with_bf16_b_c_returns_bf16():
    args, dy, ds = _bwd_case(2, 2, 32, 16, 16, 0.1)
    x, a, bm, cm = args
    dx, da, db, dc = ssd_scan.ssd_chunk_bwd_plain(x, a, bm.bfloat16(), cm.bfloat16(), dy, ds)
    assert (dx.dtype, da.dtype, db.dtype, dc.dtype) == (torch.float32, torch.float32,
                                                        torch.bfloat16, torch.bfloat16)
    want = ssd_scan.ssd_chunk_bwd_plain(x, a, bm.bfloat16().float(), cm.bfloat16().float(),
                                        dy, ds)
    assert torch.equal(dx, want[0]) and torch.equal(da, want[1])
    assert torch.equal(db, want[2].bfloat16()) and torch.equal(dc, want[3].bfloat16())


def test_function_passes_gradcheck_in_f64():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 2, 6, 3), dtype=torch.float64, generator=g, requires_grad=True)
    a = torch.cumsum(-0.3 * torch.randn((1, 2, 6), dtype=torch.float64, generator=g).abs(), -1)
    a.requires_grad_()
    bm = torch.randn((1, 2, 6, 4), dtype=torch.float64, generator=g, requires_grad=True)
    cm = torch.randn((1, 2, 6, 4), dtype=torch.float64, generator=g, requires_grad=True)
    assert torch.autograd.gradcheck(ops.ssd_chunk, (x, a, bm, cm))


def test_grad_takes_the_function_and_no_grad_launches_as_before(monkeypatch):
    fwd, bwd = [], []
    orig_fwd, orig_bwd = ssd_scan._forward, ssd_scan.ssd_chunk_bwd

    def spy_fwd(*args):
        fwd.append(1)
        return orig_fwd(*args)

    def spy_bwd(*args):
        bwd.append(1)
        return orig_bwd(*args)

    monkeypatch.setattr(ssd_scan, "_forward", spy_fwd)
    monkeypatch.setattr(ssd_scan, "ssd_chunk_bwd", spy_bwd)
    args, dy, ds = _bwd_case(1, 2, 32, 16, 16, 0.1)
    args[0].requires_grad_()
    with torch.no_grad():
        y, s = ops.ssd_chunk(*args)
    assert fwd == [1] and not y.requires_grad
    y, s = ops.ssd_chunk(*args)
    assert fwd == [1, 1] and y.requires_grad and s.requires_grad
    torch.autograd.backward((y, s), (dy, ds))
    assert bwd == [1] and args[0].grad is not None


def test_mixer_grads_match_model():
    """``ssd_mixer`` over one chunk differentiated by jax (the reference's
    state scan carries no cotangent, so one chunk, where it has no part)
    against the port's through ``SsdChunk``, f32."""
    jcfg = dataclasses.replace(jget_config("zamba2-2.7b", smoke=True), dtype="float32")
    cfg = dataclasses.replace(get_config("zamba2-2.7b", smoke=True), dtype="float32")
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    jp = jax.tree_util.tree_map(lambda t: t[0, 1], jparams["layers"])
    params = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    p = {k: v[0, 1].detach().requires_grad_() for k, v in params["layers"].items()}
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    dout = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    _, vjp = jax.vjp(lambda p_, x_: jmamba.ssd_mixer(jcfg, p_, x_)[0], jp,
                     jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(dout))
    tx = torch.from_numpy(x).requires_grad_()
    out, _ = tmamba.ssd_mixer(cfg, p, tx)
    names = sorted(p)
    got = torch.autograd.grad(out, [p[n] for n in names] + [tx], torch.from_numpy(dout),
                              allow_unused=True, materialize_grads=True)  # "ln": the block's
    for n, g in zip(names + ["x"], got):
        w = jgx if n == "x" else jgp[n]
        _close(g, w, 1e-4)


# -- the backward kernel's tensor-core products ----------------------------------


def _tf32_read(t: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of an f32 operand: its top 19 bits."""
    return (t.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _tc_product(a: torch.Tensor, b: torch.Tensor, a_exact: bool, b_exact: bool) -> torch.Tensor:
    """a @ b as ``ssd_chunk_bwd.cu`` forms it on TF32 tensor cores: an f32
    operand split into hi (rounded to TF32) and lo (the rest, as the tensor
    core reads it), a bf16-valued operand exact; lo x hi products first,
    lo x lo dropped (3xTF32, or 2xTF32 with one exact operand), sums in f32."""
    ah, al = (a, None) if a_exact else (_tf32(a), _tf32_read(a - _tf32(a)))
    bh, bl = (b, None) if b_exact else (_tf32(b), _tf32_read(b - _tf32(b)))
    out = torch.zeros(a.shape[:-1] + b.shape[-1:])
    if al is not None:
        out = out + al @ bh
    if bl is not None:
        out = out + ah @ bl
    return out + ah @ bh


def _bwd_tc_emulation(x, a, bm, cm, dy, ds, one_pass=False):
    """``ssd_chunk_bwd``'s arithmetic in plain torch, in f32 (dB and dC before
    their rounding to B's dtype): C B^T on bf16 B and C exact in its
    products, every other product through :func:`_tc_product`; or, with
    ``one_pass``, every product on one TF32 pass."""
    exact = bm.dtype == torch.bfloat16
    x, a, bm, cm, dy, ds = (t.float() for t in (x, a, bm, cm, dy, ds))

    def mm(p, q, p_exact=False, q_exact=False):
        if one_pass:
            return _tf32(p) @ _tf32(q)
        if p_exact and q_exact:
            return p @ q  # bf16 x bf16: exact products, f32 sums
        return _tc_product(p, q, p_exact, q_exact)

    decay = ssd_scan._decay(a)
    g = mm(cm, bm.transpose(-1, -2), exact, exact)
    dg = mm(dy, x.transpose(-1, -2)) * decay
    w = torch.exp(a[..., -1:] - a)
    bds = mm(bm, ds, exact)
    dx = mm((g * decay).transpose(-1, -2), dy) + w[..., None] * bds
    dc = mm(dg, bm, False, exact)
    db = mm(dg.transpose(-1, -2), cm, False, exact) + w[..., None] * mm(x, ds.transpose(-1, -2))
    e = dg * g
    wdw = w * (x * bds).sum(dim=-1)
    da = e.sum(dim=-1) - e.sum(dim=-2) - wdw
    da[..., -1] += wdw.sum(dim=-1)
    return dx, da, db, dc


def _jax_vjp_per_chunk(args, dy, ds):
    """``jax.vjp`` of the reference's oracle, chunk by chunk, as tensors
    (dx, da, db, dc) in f32."""
    out = [np.zeros(t.shape, np.float32) for t in args]
    for i in range(args[0].shape[0]):
        for j in range(args[0].shape[1]):
            _, vjp = jax.vjp(jref.ssd_chunk_ref,
                             *(jnp.asarray(t[i, j].float().numpy()) for t in args))
            for o, gr in zip(out, vjp((jnp.asarray(dy[i, j].numpy()),
                                       jnp.asarray(ds[i, j].numpy())))):
                o[i, j] = np.asarray(gr)
    return [torch.from_numpy(o) for o in out]


def _bwd_rule_ratios(got, want, n_l, n, p):
    """Each gradient's max error over its fp32-rule limit, with the rule's
    term counts as ``chip_smoke.ssd_bwd_terms`` gives them."""
    terms = (n_l * max(n, p), n_l * (n + p), n_l * max(n, p), n_l * max(n, p))
    return [float((g - w).abs().max()) / _fp32_limit(nt, w)
            for g, w, nt in zip(got, want, terms)]


@pytest.mark.parametrize("bc_dtype", [torch.bfloat16, torch.float32])
def test_backward_tc_products_hold_the_fp32_rule(bc_dtype):
    """The backward kernel's products emulated (3xTF32, 2xTF32 on a bf16
    operand, C B^T exact on bf16 B and C) at the training chunk (L 256, N =
    P 64) against ``jax.vjp`` of the reference's oracle on the same values:
    every gradient within the fp32 rule the card holds the kernel to."""
    args, dy, ds = _bwd_case(2, 2, 256, 64, 64, 0.1, seed=7)
    args[2], args[3] = args[2].to(bc_dtype), args[3].to(bc_dtype)
    want = _jax_vjp_per_chunk(args, dy, ds)
    ratios = _bwd_rule_ratios(_bwd_tc_emulation(*args, dy, ds), want, 256, 64, 64)
    assert max(ratios) <= 0.2, ratios


def test_backward_fp32_rule_fails_one_tf32_pass():
    """Why no product of the backward kernel is a single TF32 pass: the same
    chunk with every product on one pass misses the fp32 rule by a wide
    margin, where the function in f64 meets it with room to spare."""
    args, dy, ds = _bwd_case(2, 2, 256, 64, 64, 0.1, seed=7)
    args[2], args[3] = args[2].bfloat16(), args[3].bfloat16()
    want = _jax_vjp_per_chunk(args, dy, ds)
    f64 = ssd_scan.ssd_chunk_bwd_plain(*(t.double() for t in args), dy.double(), ds.double())
    passing = _bwd_rule_ratios([t.float() for t in f64], want, 256, 64, 64)
    failing = _bwd_rule_ratios(_bwd_tc_emulation(*args, dy, ds, one_pass=True), want, 256, 64,
                               64)
    assert max(passing) <= 0.2, passing
    assert min(failing) >= 3.0, failing
