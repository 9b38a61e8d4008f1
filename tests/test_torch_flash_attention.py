"""Kernel 6 on the CPU: the plain version of the port's flash attention
against the reference's Pallas kernel (interpret mode) and its oracle, and
the port's ``gqa_attention``/``decode_attention`` against the model's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
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
