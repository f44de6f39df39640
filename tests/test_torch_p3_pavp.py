"""The port's parallel AVP (ops/pavp.py) against nblic_tpu's, on the CPU,
tolerance 0.

The int64 math on stressed inputs: the B/E/F chains and the segment
freezes, the pivoted elimination on random, wrapping, singular and
rank-deficient systems, the quantized weights at their range limits, the
moment contributions and both predictions on the systems of flat, ramp,
0/255 checkerboard and noise planes, and the whole-plane prediction under
every option.  The JAX side runs under ``jax.enable_x64``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nblic_tpu.ops import pavp as j_pavp
from nblic_tpu_torch.ops import pavp

torch.set_num_threads(1)


def _t(a, dtype=torch.int64):
    return torch.from_numpy(np.array(a)).to(dtype)


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def _stressed_strips(h=16, w=24):
    """(4, h, w) int32: flat, ramp, 0/255 checkerboard, noise."""
    yy, xx = np.mgrid[0:h, 0:w]
    rng = np.random.default_rng(11)
    return np.stack([np.full((h, w), 77), (3 * yy + 5 * xx) % 256,
                     ((yy + xx) % 2) * 255, rng.integers(0, 256, (h, w))]).astype(np.int32)


@pytest.mark.parametrize("first_beta,ab", [(True, None), (False, None), (True, "mix")])
def test_chains(first_beta, ab):
    rng = np.random.default_rng(1)
    c = 2 if ab == "mix" else 5
    x = rng.integers(-(2**40), 2**40, size=(12, c, 7))
    kw_p = dict(first_beta=first_beta, ab=pavp.mix_ab() if ab else None)
    with jax.enable_x64():
        kw_j = dict(first_beta=first_beta, ab=j_pavp.mix_ab() if ab else None)
        xj = jnp.asarray(x)
        refs = [j_pavp.col_chain(xj, **kw_j), j_pavp.e_chain(xj, **kw_j),
                j_pavp.f_chain(xj, **kw_j)]
        if ab is None:
            refs += [j_pavp.e_freeze_extend(xj, 4, first_beta), j_pavp.hold_starts(xj, 3),
                     j_pavp.e_freeze_extend(xj, 5, first_beta)]  # 12 % 5: unchanged
    xp = _t(x)
    ports = [pavp.col_chain(xp, **kw_p), pavp.e_chain(xp, **kw_p), pavp.f_chain(xp, **kw_p)]
    if ab is None:
        ports += [pavp.e_freeze_extend(xp, 4, first_beta), pavp.hold_starts(xp, 3),
                  pavp.e_freeze_extend(xp, 5, first_beta)]
    for p, r in zip(ports, refs):
        _eq(p, r)


def _stats_systems(n):
    """(a (n, n, P), b (n, P)) int64 systems: random ones, some with entries
    near 2^60 whose products wrap, a singular and a rank-deficient block."""
    rng = np.random.default_rng(3)
    p = 64
    a = rng.integers(-(2**40), 2**40, size=(n, n, p))
    a[:, :, :8] = 0
    a[2, :, 8:16] = a[3, :, 8:16]
    a[:, :, 16:24] = rng.integers(-(2**60), 2**60, size=(n, n, 8))
    b = rng.integers(-(2**45), 2**45, size=(n, p))
    return a, b


@pytest.mark.parametrize("n", [6, 10])
def test_solve_batch_and_weights(n):
    a, b = _stats_systems(n)
    solve = jax.jit(j_pavp.solve_batch, static_argnums=2)
    with jax.enable_x64():
        d_j, x_j, ok_j = solve(jnp.asarray(a), jnp.asarray(b), n)
        wq_j = j_pavp.quantize_weights(d_j, x_j)
        # quantize_weights at its range limits: pivots past 2^48, huge and
        # zero numerators
        diag = jnp.asarray([0, 1, -1, 2**50, -(2**62), 3, 2**47 + 5], jnp.int64)
        num = jnp.asarray([5, 2**60, -(2**60), -(2**62), 2**61, 0, -12345], jnp.int64)
        wq_edge = j_pavp.quantize_weights(diag, num)
    d_p, x_p, ok_p = pavp.solve_batch(_t(a), _t(b), n)
    _eq(d_p, d_j)
    _eq(x_p, x_j)
    _eq(ok_p, ok_j)
    assert not bool(ok_p[:8].any())
    _eq(pavp.quantize_weights(d_p, x_p), wq_j)
    _eq(pavp.quantize_weights(_t(np.asarray(diag)), _t(np.asarray(num))), wq_edge)
    feats = np.random.default_rng(4).integers(-128, 128, size=(n, a.shape[2]))
    _eq(pavp.predict_wq(pavp.quantize_weights(d_p, x_p), _t(feats, torch.int32)),
        j_pavp.predict_wq(wq_j, jnp.asarray(feats, jnp.int32)))


def test_solve_and_predict_on_stressed_planes():
    """contributions, solve_batch and the two predictions on the ridge
    systems of flat, ramp, checkerboard and noise planes, each feature a
    shifted copy of its plane."""
    n = 10
    planes = _stressed_strips()
    x = planes.reshape(-1).astype(np.int64)
    feats = np.stack([np.roll(planes, k + 1, axis=2).reshape(-1) - 128
                      for k in range(n)]).astype(np.int64)
    rng = np.random.default_rng(5)
    s_curr = rng.integers(0, 255 << 12, size=x.size)
    s_sum = rng.integers(0, 1 << 22, size=x.size)
    with jax.enable_x64():
        contrib_j = j_pavp.contributions(jnp.asarray(x), jnp.asarray(feats),
                                         jnp.asarray(s_curr), jnp.asarray(s_sum), n)
        # running sums over each plane stand in for the chains' statistics
        stats_j = jnp.cumsum(contrib_j.reshape(-1, 4, x.size // 4), axis=2).reshape(
            -1, x.size)
        amat = stats_j[1 + n :].reshape(n, n, -1) + jnp.eye(n, dtype=jnp.int64)[
            :, :, None] * (8 * n)
        solve_j = j_pavp.solve_batch(amat, stats_j[1 : 1 + n] + (8 << 10), n)
        px_j = j_pavp.predict_from_stats(stats_j, jnp.asarray(feats), n)
        wq_j = j_pavp.predict_from_stats_wq(stats_j, jnp.asarray(feats), n)
    contrib_p = pavp.contributions(_t(x), _t(feats), _t(s_curr), _t(s_sum), n)
    _eq(contrib_p, contrib_j)
    stats_p = torch.cumsum(contrib_p.reshape(-1, 4, x.size // 4), 2).reshape(-1, x.size)
    _eq(stats_p, stats_j)
    for p, r in zip(pavp.solve_batch(_t(np.asarray(amat)), stats_p[1 : 1 + n] + (8 << 10),
                                     n), solve_j):
        _eq(p, r)
    for p, r in zip(pavp.predict_from_stats(stats_p, _t(feats), n), px_j):
        _eq(p, r)
    for p, r in zip(pavp.predict_from_stats_wq(stats_p, _t(feats), n), wq_j):
        _eq(p, r)


@pytest.mark.parametrize("kw", [
    dict(n=10),
    dict(n=10, mix=True),
    dict(n=10, seg_w=4),
    dict(n=10, seg_w=4, w_quant=True),
    dict(n=6),
], ids=["plain", "mix", "seg_stats", "w_pred", "n6"])
def test_predict_plane(kw):
    x = _stressed_strips()
    n = kw["n"]
    args = (n, False, kw.get("seg_w", 0), kw.get("mix", False), kw.get("w_quant", False))
    with jax.enable_x64():
        ref = jax.jit(j_pavp.predict_plane, static_argnums=(1, 2, 3, 4, 5))(
            jnp.asarray(x), *args)
    port = pavp.predict_plane(_t(x, torch.int32), n, seg_w=args[2], mix=args[3],
                              w_quant=args[4])
    _eq(port, ref)
