"""Kernel 6 on the CPU: the plain version of the port's flash attention
against the reference's Pallas kernel (interpret mode) and its oracle, and
the port's ``gqa_attention``/``decode_attention`` against the model's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.configs import registry
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn

# (b, H, KVH, S, T, D, block_q, block_k): the reference kernel test's four
# shapes (tests/test_kernels.py) and the Zamba2 head dim, 80
SHAPES = [
    (2, 4, 2, 128, 128, 64, 64, 64),
    (1, 8, 4, 64, 256, 32, 32, 64),    # decode-style: T > S
    (2, 2, 2, 100, 100, 64, 32, 32),   # S not a block multiple
    (1, 4, 1, 128, 128, 128, 128, 128),  # MQA
    (2, 4, 4, 96, 96, 80, 32, 32),     # D 80, as in Zamba2
]

# f32: the same f32 softmax attention, online (Pallas) or whole-row (the
# plain version), so only the order of f32 sums and the rescaling steps
# differ. bf16: the Pallas kernel rounds p to bf16 before p @ v, the port
# keeps p in f32 (the model's attention does) and both round the output to
# bf16: a few bf16 ulps (2^-8) of the output's scale apart.
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(b, h, kvh, s, t, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, s, d)).astype(np.float32),
            rng.standard_normal((b, kvh, t, d)).astype(np.float32),
            rng.standard_normal((b, kvh, t, d)).astype(np.float32))


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def _to(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kvh,s,t,d,bq,bk", SHAPES)
def test_plain_matches_pallas_kernel(b, h, kvh, s, t, d, bq, bk, dtype):
    q, k, v = _inputs(b, h, kvh, s, t, d)
    jd = jnp.dtype(dtype)
    want = jops.flash_attention(jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
                                block_q=bq, block_k=bk)
    got = fa.flash_attention_plain(_to(q, dtype), _to(k, dtype), _to(v, dtype))
    assert got.dtype == getattr(torch, dtype)
    _close(got.float(), want.astype(jnp.float32), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kvh,s,t,d,bq,bk", SHAPES)
def test_plain_matches_oracle(b, h, kvh, s, t, d, bq, bk, dtype):
    """Against ``ref.flash_attention_ref`` (f32 on the same, possibly bf16,
    operands): f32 within 2e-5; bf16 within one output rounding, 2^-7."""
    q, k, v = _inputs(b, h, kvh, s, t, d, seed=1)
    jd = jnp.dtype(dtype)
    want = jref.flash_attention_ref(jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd))
    got = fa.flash_attention_plain(_to(q, dtype), _to(k, dtype), _to(v, dtype))
    _close(got.float(), want, 2e-5 if dtype == "float32" else 2.0 ** -7)


def test_non_causal_matches_oracle():
    q, k, v = _inputs(1, 4, 2, 70, 130, 48)
    want = jref.flash_attention_ref(q, k, v, causal=False)
    got = fa.flash_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)), causal=False)
    _close(got, want, 2e-5)


def test_scale_argument():
    q, k, v = _inputs(1, 2, 2, 40, 40, 16)
    want = jref.flash_attention_ref(q, k, v, scale=0.3)
    got = fa.flash_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)), scale=0.3)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kvh,d,chunk", [(2, 70, 4, 2, 16, 32), (1, 96, 4, 4, 80, 2048),
                                               (2, 33, 6, 1, 32, 8)])
def test_gqa_attention_matches_model(b, s, h, kvh, d, chunk, dtype):
    """The model's attention (blockwise jnp, kv chunks of ``chunk``) against
    the port's, which calls ``ops.flash_attention`` on (b, H, s, hd) views."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    jd = jnp.dtype(dtype)
    want = jattn.gqa_attention(jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
                               chunk=chunk)
    got = tattn.gqa_attention(_to(q, dtype), _to(k, dtype), _to(v, dtype))
    assert tuple(got.shape) == (b, s, h, d) and got.dtype == getattr(torch, dtype)
    # bf16: both widen to f32 and round the output once, so one bf16 ulp
    _close(got.float(), want.astype(jnp.float32), 2e-5 if dtype == "float32" else 2.0 ** -7)


@pytest.mark.parametrize("pos", [0, 5, 37])
def test_decode_attention_matches_model(pos):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 1, 6, 16)).astype(np.float32)
    kc = rng.standard_normal((2, 40, 3, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 40, 3, 16)).astype(np.float32)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                  jnp.int32(pos))
    got = tattn.decode_attention(*(torch.from_numpy(x) for x in (q, kc, vc)), pos)
    _close(got, want, 1e-6)


def test_cpu_runs_the_plain_version_and_counts_no_launch():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 2, 1, 20, 20, 16))
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v)
    assert ops.flash_attention is fa.flash_attention
    assert ops.flash_attention.launches == before
    assert torch.equal(got, fa.flash_attention_plain(q, k, v))


def test_shapes_the_kernel_does_not_take_raise():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 2, 1, 30, 20, 16))
    with pytest.raises(ValueError, match="T >= S"):
        fa.flash_attention(q, k, v)  # causal with fewer keys than queries
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q[:, :, :20], torch.cat([k, k, k], 1), torch.cat([v, v, v], 1))


# -- the tensor-core route (bf16): its numerics and its dispatch --------------


def _split_p(p: torch.Tensor):
    """p = p_hi + p_lo, both bf16, as the wgmma kernel splits it."""
    hi = p.to(torch.bfloat16)
    lo = (p - hi.float()).to(torch.bfloat16)
    return hi, lo


def _wgmma_emulation(q, k, v, causal=True, block=128):
    """The bf16 kernel's arithmetic in plain torch: q k^T of the bf16 inputs
    summed in f32, the online softmax in base 2 over 128-key blocks, p split
    into bf16 hi + lo and both products with v summed in f32, the output
    rounded to bf16."""
    b, h, s, d = q.shape
    kvh, t = k.shape[1], k.shape[2]
    g = h // kvh
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    scale_log2 = 1.0 / np.sqrt(d) * 1.4426950408889634
    m = torch.full((b, h, s), -1e30)
    l = torch.zeros((b, h, s))
    acc = torch.zeros((b, h, s, d))
    qpos = torch.arange(s) + (t - s)
    for k0 in range(0, t, block):
        kpos = torch.arange(k0, min(t, k0 + block))
        x = (q.float() @ kf[:, :, kpos].transpose(-1, -2)) * scale_log2
        if causal:
            x = x.masked_fill(qpos[:, None] < kpos[None, :], -1e30)
        m_new = torch.maximum(m, x.max(-1).values)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[..., None])
        l = l * alpha + p.sum(-1)
        hi, lo = _split_p(p)
        acc = acc * alpha[..., None] + hi.float() @ vf[:, :, kpos] + lo.float() @ vf[:, :, kpos]
        m = m_new
    return (acc / l[..., None]).to(torch.bfloat16)


def test_p_split_recovers_p_to_two_to_the_minus_16():
    p = torch.from_numpy(np.random.default_rng(5).random(100_000).astype(np.float32))
    p = torch.cat([p, p * 1e-6, torch.tensor([0.0, 1.0])])
    hi, lo = _split_p(p)
    err = (hi.float() + lo.float() - p).abs()
    assert bool((err <= 2.0 ** -16 * p.abs()).all())


@pytest.mark.parametrize("b,h,kvh,s,t,d,causal", [
    (2, 4, 2, 128, 128, 64, True), (1, 6, 2, 100, 200, 80, True), (1, 3, 3, 77, 77, 28, True),
    (2, 4, 1, 70, 130, 16, False)])
def test_wgmma_numerics_keep_the_models_function(b, h, kvh, s, t, d, causal):
    """The emulated bf16 kernel against the model's gqa_attention (JAX, bf16
    operands widened to f32, p in f32) and the port's plain version. Each
    side rounds its f32 output to bf16 once (2^-8 relative), and p_hi + p_lo
    carries p to 2^-16, far below that: within 2^-7 x max|output|, the
    tolerance the card's comparison uses."""
    q, k, v = _inputs(b, h, kvh, s, t, d, seed=7)
    qb, kb, vb = (_to(x, "bfloat16") for x in (q, k, v))
    got = _wgmma_emulation(qb, kb, vb, causal=causal)
    plain = fa.flash_attention_plain(qb, kb, vb, causal=causal)
    _close(got.float(), plain.float(), 2.0 ** -7)
    if causal:
        want = jattn.gqa_attention(*(jnp.asarray(x, jnp.bfloat16).transpose(0, 2, 1, 3)
                                     for x in (q, k, v)), causal=True, chunk=64)
        _close(got.float().transpose(1, 2), np.asarray(want.astype(jnp.float32)), 2.0 ** -7)
    else:  # the model ignores causal=False (ROADMAP queue 3): the kernels' oracle
        want = jref.flash_attention_ref(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                                        causal=False)
        _close(got.float(), np.asarray(want), 2.0 ** -7)


def test_rounding_p_once_is_a_different_function():
    """Why p is split: with p rounded to bf16 once (as SDPA and the TPU
    kernel do) the output moves by more than the split's, measured against
    the plain version's f32 p."""
    q, k, v = (_to(x, "bfloat16") for x in _inputs(1, 2, 2, 128, 128, 64, seed=8))
    want = fa.flash_attention_plain(q, k, v).float()
    split = _wgmma_emulation(q, k, v).float()
    logits = (q.float() @ k.float().transpose(-1, -2)) / 8.0
    logits = logits.masked_fill(torch.ones(128, 128).triu(1).bool(), -1e30)
    once = (torch.softmax(logits, -1).to(torch.bfloat16).float() @ v.float()).to(torch.bfloat16)
    assert float((split - want).abs().max()) < float((once.float() - want).abs().max())


def _meta(*xs):
    return ([tuple(x.shape) for x in xs], [x.stride() for x in xs], [x.data_ptr() for x in xs])


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"), (torch.float32, "simt")])
def test_dispatch_is_by_dtype(dtype, route):
    q, k, v = (torch.zeros(shape, dtype=dtype) for shape in ((2, 4, 64, 80), (2, 2, 64, 80),
                                                             (2, 2, 64, 80)))
    got, staging = fa.launch_plan(dtype, *_meta(q, k, v))
    assert got == route
    assert staging == ("tma" if route == "wgmma" else None)
    with pytest.raises(ValueError, match="no kernel"):
        fa.launch_plan(torch.float16, *_meta(q, k, v))


def _attention_configs():
    for name in sorted(registry._MODULES):
        for smoke in (False, True):
            cfg = registry.get_config(name, smoke=smoke)
            if cfg.n_heads:
                yield cfg


@pytest.mark.parametrize("cfg", list(_attention_configs()), ids=lambda c: c.name)
def test_every_registered_configs_attention_is_taken(cfg):
    """q, k, v as ``models/attention.py`` passes them: (b, s, heads, hd)
    projections viewed as (b, heads, s, hd). A head dim whose head stride is
    not a multiple of 16 bytes (qwen2-7b SMOKE's 28) takes the kernel's
    ordinary-load staging; every other one the TMA loads."""
    hd = cfg.resolved_head_dim
    b, s = 2, 5
    q = torch.zeros((b, s, cfg.n_heads, hd), dtype=torch.bfloat16).transpose(1, 2)
    k = torch.zeros((b, s, cfg.n_kv_heads, hd), dtype=torch.bfloat16).transpose(1, 2)
    v = torch.zeros((b, s, cfg.n_kv_heads, hd), dtype=torch.bfloat16).transpose(1, 2)
    route, staging = fa.launch_plan(torch.bfloat16, *_meta(q, k, v))
    assert route == "wgmma"
    assert staging == ("threads" if (hd * 2) % 16 else "tma")
    if cfg.name == "qwen2-7b-smoke":
        assert hd == 28 and staging == "threads"
    assert fa.launch_plan(torch.float32, *_meta(q.float(), k.float(), v.float()))[0] == "simt"


def test_offset_views_take_the_ordinary_load_staging():
    """A base address off a 16-byte boundary cannot be a TMA base."""
    buf = torch.zeros((2, 4, 64, 80), dtype=torch.bfloat16)
    q = buf.view(-1)[4:4 + 2 * 4 * 60 * 80].view(2, 4, 60, 80)  # 8 bytes off
    assert fa.launch_plan(torch.bfloat16, *_meta(q, q, q))[1] == "threads"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_what_no_kernel_takes_raises_before_a_launch(dtype):
    def plan(q, k, v, causal=True):
        return fa.launch_plan(dtype, *_meta(q, k, v), causal=causal)

    z = torch.zeros((1, 2, 8, 144), dtype=dtype)
    with pytest.raises(ValueError, match="head dim"):
        plan(z, z, z)
    z = torch.zeros((1, 2, 8, 16), dtype=dtype)
    with pytest.raises(ValueError, match="unit-stride"):
        plan(torch.zeros((1, 2, 16, 8), dtype=dtype).transpose(2, 3), z, z)
    neg = (z.stride(0), z.stride(1), -16, 1)
    with pytest.raises(ValueError, match="non-negative"):
        fa.launch_plan(dtype, [tuple(z.shape)] * 3, [neg, z.stride(), z.stride()], (0, 0, 0))
    with pytest.raises(ValueError, match="T >= S"):
        plan(z, z[:, :, :4], z[:, :, :4])
    with pytest.raises(ValueError, match="multiple"):
        plan(torch.zeros((1, 3, 8, 16), dtype=dtype), z, z)
    assert plan(z, z, z)[0] == fa.ROUTES[dtype]


# -- the backward pass ---------------------------------------------------------

# (b, H, KVH, S, T, D, causal): SHAPES' odd shapes, GQA 1, 2, 3 and 4, S != T
# (the diagonal aligned to the kv end), and the non-causal case
BWD_SHAPES = [(2, 4, 2, 40, 40, 16, True), (1, 8, 4, 24, 56, 32, True),
              (2, 2, 2, 33, 33, 64, True), (1, 4, 1, 20, 20, 80, True),
              (1, 6, 2, 17, 30, 8, True), (1, 4, 2, 19, 27, 16, False)]
# f32 on both sides, sums in other orders: 1e-5 of each gradient's max|want|
# (measured: 4.4e-7 against autograd, 1.0e-6 against jax.vjp)
BWD_TOL = 1e-5


def _bwd_case(b, h, kvh, s, t, d, causal, seed=4):
    q, k, v = (torch.from_numpy(x) for x in _inputs(b, h, kvh, s, t, d, seed=seed))
    do = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal((b, h, s, d))
                          .astype(np.float32))
    out, lse = fa.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    return q, k, v, do, out, lse


@pytest.mark.parametrize("b,h,kvh,s,t,d,causal", BWD_SHAPES)
def test_plain_backward_matches_autograd_of_plain_forward(b, h, kvh, s, t, d, causal):
    q, k, v, do, out, lse = _bwd_case(b, h, kvh, s, t, d, causal)
    got = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
    want = torch.autograd.grad(fa.flash_attention_plain(qr, kr, vr, causal=causal), (qr, kr, vr),
                               do)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        _close(g, w, BWD_TOL)


@pytest.mark.parametrize("b,h,kvh,s,t,d,causal", BWD_SHAPES)
def test_plain_backward_matches_jax_vjp_of_oracle(b, h, kvh, s, t, d, causal):
    q, k, v, do, out, lse = _bwd_case(b, h, kvh, s, t, d, causal)
    got = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
    _, vjp = jax.vjp(lambda q_, k_, v_: jref.flash_attention_ref(q_, k_, v_, causal=causal),
                     *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    for g, w in zip(got, vjp(jnp.asarray(do.numpy()))):
        _close(g, w, BWD_TOL)


def test_lse_is_the_rows_logsumexp():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 4, 2, 30, 50, 16))
    _, lse = fa.flash_attention_plain(q, k, v, return_lse=True)
    logits = (q.reshape(1, 2, 2, 30, 16) @ k[:, :, None].transpose(-1, -2)) / 4.0
    qpos, kpos = torch.arange(30)[:, None] + 20, torch.arange(50)[None, :]
    want = torch.logsumexp(logits.masked_fill(qpos < kpos, -torch.inf), -1).reshape(1, 4, 30)
    torch.testing.assert_close(lse, want, rtol=0, atol=1e-5)
    assert lse.dtype == torch.float32


@pytest.mark.parametrize("causal", [True, False])
def test_function_passes_gradcheck_in_f64(causal):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 4, 5, 3), dtype=torch.float64, generator=g, requires_grad=True)
    k = torch.randn((1, 2, 7, 3), dtype=torch.float64, generator=g, requires_grad=True)
    v = torch.randn((1, 2, 7, 3), dtype=torch.float64, generator=g, requires_grad=True)
    assert torch.autograd.gradcheck(lambda *a: ops.flash_attention(*a, causal=causal), (q, k, v))


def test_grad_takes_the_function_and_no_grad_asks_for_no_lse(monkeypatch):
    """Under no_grad (serving) the forward is called as before, without the
    log-sum-exp; with grad it saves the log-sum-exp and the backward goes
    through ``flash_attention_bwd``, once a call."""
    seen, bwd = [], []
    orig_fwd, orig_bwd = fa._forward, fa.flash_attention_bwd

    def spy_fwd(q, k, v, causal, scale, want_lse):
        seen.append(want_lse)
        return orig_fwd(q, k, v, causal, scale, want_lse)

    def spy_bwd(*args):
        bwd.append(1)
        return orig_bwd(*args)

    monkeypatch.setattr(fa, "_forward", spy_fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd", spy_bwd)
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 2, 1, 20, 20, 16))
    with torch.no_grad():
        out = ops.flash_attention(q.requires_grad_(), k, v)
    assert seen == [False] and not out.requires_grad
    out = ops.flash_attention(q, k, v)
    assert seen == [False, True] and out.requires_grad and bwd == []
    out.sum().backward()
    assert bwd == [1] and q.grad is not None
    assert torch.equal(out.detach(), fa.flash_attention_plain(q.detach(), k, v))


def test_gqa_attention_grads_match_model():
    """The model's attention differentiated by jax against the port's
    ``gqa_attention`` through ``FlashAttention``, on (b, s, heads, hd)."""
    rng = np.random.default_rng(6)
    b, s, h, kvh, d = 2, 37, 6, 2, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    do = rng.standard_normal((b, s, h, d)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jattn.gqa_attention(*a, causal=True, chunk=16),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = torch.autograd.grad(tattn.gqa_attention(tq, tk, tv, causal=True), (tq, tk, tv),
                              torch.from_numpy(do))
    for g, w in zip(got, want):
        _close(g, w, BWD_TOL)


def test_backward_on_a_card_tensor_without_a_card_raises():
    z = torch.zeros((1, 2, 4, 16), device="meta")
    lse = torch.zeros((1, 2, 4), device="meta")
    with pytest.raises(ValueError, match="operands on"):
        fa.flash_attention_bwd(z, z, z, z, lse, z)


# -- the backward's tensor-core route (bf16): its numerics and its dispatch ------

# (b, H, KVH, S, T, D, causal): D 16, 28, 64, 80 and 128, GQA 1, 3 and 8,
# S != T, and non-causal cases (T < S among them)
WGMMA_BWD_SHAPES = [(1, 2, 2, 40, 40, 16, True), (1, 6, 2, 33, 50, 28, True),
                    (1, 8, 1, 48, 48, 64, True), (2, 4, 4, 70, 70, 80, True),
                    (1, 3, 1, 30, 45, 128, True), (1, 8, 1, 20, 36, 80, False),
                    (1, 6, 2, 37, 25, 64, False)]


def _wgmma_bwd_emulation(q, k, v, out, lse, do, causal=True, split=True):
    """The bf16 backward kernels' arithmetic in plain torch, in f32 (before
    the gradients' bf16 rounding): the products of the bf16 operands summed
    in f32, P = exp2(scale log2(e) q k^T - lse log2(e)), delta = rowsum(do
    o), dS = P (dP - delta), and P and dS split into bf16 hi + lo (or, with
    ``split=False``, rounded to bf16 once) before their products with do, q
    and k, each summed in f32."""
    b, h, s, d = q.shape
    kvh, t = k.shape[1], k.shape[2]
    g = h // kvh
    qf, of, dof = q.float(), out.float(), do.float()
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    scale = 1.0 / np.sqrt(d)
    log2e = 1.4426950408889634
    x = (qf @ kf.transpose(-1, -2)) * (scale * log2e) - (lse * log2e)[..., None]
    if causal:
        qpos, kpos = torch.arange(s)[:, None] + (t - s), torch.arange(t)[None, :]
        x = x.masked_fill(qpos < kpos, -torch.inf)
    p = torch.exp2(x)
    ds = p * (dof @ vf.transpose(-1, -2) - (dof * of).sum(-1, keepdim=True))

    def prod(a, bm):  # a (bf16 hi + lo, or rounded once) @ bm, summed in f32
        hi, lo = _split_p(a)
        return hi.float() @ bm + lo.float() @ bm if split else hi.float() @ bm

    dq = prod(ds, kf) * scale
    dk = (prod(ds.transpose(-1, -2), qf) * scale).reshape(b, kvh, g, t, d).sum(2)
    dv = prod(p.transpose(-1, -2), dof).reshape(b, kvh, g, t, d).sum(2)
    return dq, dk, dv


def _bf16_bwd_case(b, h, kvh, s, t, d, causal, seed=10):
    """bf16 q, k, v, do, and the bf16 forward output with its f32 lse, as
    the forward kernel hands them to the backward."""
    q, k, v = (_to(x, "bfloat16") for x in _inputs(b, h, kvh, s, t, d, seed=seed))
    do = _to(np.random.default_rng(seed + 1).standard_normal((b, h, s, d)).astype(np.float32),
             "bfloat16")
    out, lse = fa.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    return q, k, v, out, lse, do


@pytest.mark.parametrize("b,h,kvh,s,t,d,causal", WGMMA_BWD_SHAPES)
def test_wgmma_backward_numerics_keep_the_function(b, h, kvh, s, t, d, causal):
    """The emulated bf16 backward, rounded to bf16 as the kernel writes it,
    against ``jax.vjp`` of the reference's oracle on the same bf16 values
    and against the port's plain backward. Each gradient rounds to bf16 once
    (2^-8 relative) and P, dS carried to 2^-16 sit far below that; the
    oracle forms delta from its own f32 output, the kernels from the bf16
    one: within 2^-7 x max|gradient|, the card's limit."""
    q, k, v, out, lse, do = _bf16_bwd_case(b, h, kvh, s, t, d, causal)
    got = [x.to(torch.bfloat16).float() for x in _wgmma_bwd_emulation(q, k, v, out, lse, do,
                                                                     causal)]
    plain = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
    _, vjp = jax.vjp(lambda q_, k_, v_: jref.flash_attention_ref(q_, k_, v_, causal=causal),
                     *(jnp.asarray(x.float().numpy()) for x in (q, k, v)))
    want = vjp(jnp.asarray(do.float().numpy()))
    for g_, p_, w_ in zip(got, plain, want):
        _close(g_, p_.float(), 2.0 ** -7)
        _close(g_, w_, 2.0 ** -7)


def test_rounding_p_and_ds_once_is_a_different_function():
    """Why P and dS are split: rounded to bf16 once (as SDPA's backward and a
    bf16 wgmma on them would), each gradient moves further from the plain
    version's f32 arithmetic on the same values than with the split."""
    q, k, v, out, lse, do = _bf16_bwd_case(1, 4, 2, 128, 128, 64, True, seed=12)
    want = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), out.float(), lse,
                                        do.float(), True)
    split = _wgmma_bwd_emulation(q, k, v, out, lse, do, True)
    once = _wgmma_bwd_emulation(q, k, v, out, lse, do, True, split=False)
    for w_, s_, o_ in zip(want, split, once):
        err_split, err_once = float((s_ - w_).abs().max()), float((o_ - w_).abs().max())
        assert err_split < 2.0 ** -14 * float(w_.abs().max()) < err_once, (err_split, err_once)


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"), (torch.float32, "simt")])
def test_backward_dispatch_is_by_dtype(dtype, route):
    q, k, v, do = (torch.zeros(shape, dtype=dtype) for shape in ((2, 4, 64, 80), (2, 2, 64, 80),
                                                                 (2, 2, 64, 80), (2, 4, 64, 80)))
    got, staging = fa.bwd_launch_plan(dtype, *_meta(q, k, v, do))
    assert got == route
    assert staging == ("tma" if route == "wgmma" else None)
    with pytest.raises(ValueError, match="no kernel"):
        fa.bwd_launch_plan(torch.float16, *_meta(q, k, v, do))
    assert sorted(fa.flash_attention_bwd.launches_by_route) == ["simt", "wgmma"]


@pytest.mark.parametrize("hd", [28, 80])
def test_backward_staging_follows_tma_rules(hd):
    """The model's (b, s, heads, hd) views: a head stride off a 16-byte
    multiple (head dim 28), or a dout whose base is off a 16-byte boundary,
    takes the ordinary-load staging; the rest TMA."""
    def view(heads):
        return torch.zeros((2, 5, heads, hd), dtype=torch.bfloat16).transpose(1, 2)

    q, k, v, do = view(6), view(2), view(2), view(6)
    want = "threads" if (hd * 2) % 16 else "tma"
    assert fa.bwd_launch_plan(torch.bfloat16, *_meta(q, k, v, do)) == ("wgmma", want)
    buf = torch.zeros(2 * 6 * 5 * hd + 4, dtype=torch.bfloat16)
    do_off = buf[4:].view(2, 6, 5, hd)  # 8 bytes off
    assert fa.bwd_launch_plan(torch.bfloat16, *_meta(q, k, v, do_off))[1] == "threads"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_what_no_backward_kernel_takes_raises_before_a_launch(dtype):
    def plan(q, k, v, do, causal=True):
        return fa.bwd_launch_plan(dtype, *_meta(q, k, v, do), causal=causal)

    z = torch.zeros((1, 2, 8, 16), dtype=dtype)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros((1, 2, 8, 144), dtype=dtype)
        plan(big, big, big, big)
    with pytest.raises(ValueError, match="T >= S"):
        plan(z, z[:, :, :4], z[:, :, :4], z)
    with pytest.raises(ValueError, match="dout"):
        plan(z, z, z, z[:, :, :4])
    with pytest.raises(ValueError, match="unit-stride"):
        plan(z, z, z, torch.zeros((1, 2, 16, 8), dtype=dtype).transpose(2, 3))
    with pytest.raises(ValueError, match="q, k, v, dout"):
        fa.bwd_launch_plan(dtype, *_meta(z, z, z))
    assert plan(z, z, z, z)[0] == fa.ROUTES[dtype]


def test_backward_scratch_holds_padded_rows():
    """The wgmma route's scratch: lse and delta for S rounded up to 128 rows
    a (b, head)."""
    assert fa.bwd_scratch_floats(2, 32, 4096) == 2 * 2 * 32 * 4096
    assert fa.bwd_scratch_floats(1, 3, 1) == 2 * 3 * 128
    assert fa.bwd_scratch_floats(8, 12, 129) == 2 * 8 * 12 * 256
