"""Tucker-factorized LM layers (``repro_torch.models.tucker_layers``) on the
CPU against ``repro.models.tucker_layers`` on the same numpy weights: the
reference's three cases, with the factors compared by their projectors (a
factor's columns may come back with the other sign, or, at the exact rank,
in another basis of the same subspace), the cores in the reference's bases,
and the compression ratios."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import tucker_layers as jtl
from repro_torch.models import tucker_layers as ttl


def _projector(u) -> np.ndarray:
    u = np.asarray(u, np.float64)
    return u @ u.T


def _core_in_basis(core, got_fs, want_fs) -> np.ndarray:
    """The port's core in the reference's factor bases: each mode multiplied
    by Q_n = U_ref^T U_port. At the exact rank the two runs' factors span
    the same subspaces but each picks its own basis in it (the initial
    factors differ), so the cores agree only after this change of basis."""
    core = np.asarray(core, np.float64)
    for n, (a, b) in enumerate(zip(got_fs, want_fs)):
        q = np.asarray(b, np.float64).T @ np.asarray(a, np.float64)
        core = np.moveaxis(np.tensordot(q, core, axes=(1, n)), 0, n)
    return core


def test_tucker_linear_exact_for_low_rank_weight():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((64, 8)) @ rng.standard_normal((8, 48))).astype(np.float32)
    want = jtl.tuckerize_linear(jnp.asarray(w), (8, 8))
    p = ttl.tuckerize_linear(torch.from_numpy(w), (8, 8))
    assert {k: tuple(v.shape) for k, v in p.items()} == {"u1": (64, 8), "core": (8, 8),
                                                         "u2": (48, 8)}
    assert all(v.dtype == torch.float32 and v.device.type == "cpu" for v in p.values())
    for name in ("u1", "u2"):
        np.testing.assert_allclose(_projector(p[name]), _projector(want[name]), atol=1e-4)
    core = _core_in_basis(p["core"], [p["u1"], p["u2"]], [want["u1"], want["u2"]])
    np.testing.assert_allclose(core, np.asarray(want["core"]), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(want["core"])).max())
    x = rng.standard_normal((4, 64)).astype(np.float32)
    got = ttl.tucker_linear_apply(p, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), x @ w, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jtl.tucker_linear_apply(
        want, jnp.asarray(x))), rtol=0, atol=1e-4 * np.abs(x @ w).max())
    # the product keeps the input's dtype, the factors cast to it
    assert ttl.tucker_linear_apply(p, torch.from_numpy(x).to(torch.bfloat16)).dtype \
        == torch.bfloat16


def test_tucker_expert_stack_reconstructs():
    rng = np.random.default_rng(1)
    e, d, f, r = 6, 24, 16, 4
    core = rng.standard_normal((r, r, r))
    ue = np.linalg.qr(rng.standard_normal((e, r)))[0]
    ud = np.linalg.qr(rng.standard_normal((d, r)))[0]
    uf = np.linalg.qr(rng.standard_normal((f, r)))[0]
    experts = np.einsum("abc,ea,db,fc->edf", core, ue, ud, uf).astype(np.float32)
    want = jtl.tuckerize_expert_stack(jnp.asarray(experts), (r, r, r))
    p = ttl.tuckerize_expert_stack(torch.from_numpy(experts), (r, r, r))
    names = ("u_e", "u_d", "u_f")
    for name in names:
        np.testing.assert_allclose(_projector(p[name]), _projector(want[name]), atol=1e-4)
    g = _core_in_basis(p["core"], [p[n] for n in names], [want[n] for n in names])
    np.testing.assert_allclose(g, np.asarray(want["core"]), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(want["core"])).max())
    x = rng.standard_normal((5, d)).astype(np.float32)
    for ei in range(e):
        got = ttl.tucker_expert_apply(p, ei, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, x @ experts[ei], rtol=2e-3, atol=2e-3)
        ref = np.asarray(jtl.tucker_expert_apply(want, ei, jnp.asarray(x)))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("shape, ranks", [((32, 1024, 512), (8, 64, 64)),
                                          ((3584, 18944), (64, 64)), ((64, 48), (8, 8))])
def test_compression_ratios_are_the_references(shape, ranks):
    if len(shape) == 3:
        got, want = ttl.expert_compression_ratio(*shape, ranks), jtl.expert_compression_ratio(
            *shape, ranks)
    else:
        got, want = ttl.linear_compression_ratio(*shape, ranks), jtl.linear_compression_ratio(
            *shape, ranks)
    assert got == pytest.approx(want, rel=1e-12)
    assert ttl.expert_compression_ratio(32, 1024, 512, (8, 64, 64)) > 10


def test_tuckerize_runs_on_the_weights_device():
    """The decomposition runs where the weight lives (here the CPU); a
    weight on the card would be decomposed on the card."""
    w = torch.randn(20, 12, dtype=torch.float64)
    p = ttl.tuckerize_linear(w, (3, 3), method="householder")
    assert all(v.dtype == torch.float32 and v.device == w.device for v in p.values())
