"""The interop engines' ops against nblic_tpu's, on the same seeded inputs.

Each function of the port that the Q0.2 and NBLIC0.3 walks run is held to
its JAX counterpart with tolerance 0: the fresh causal window at every
border, the two adaptive-bias steps on negative states, the histogram
normalization and decode table, the rANS decode step past a stream's end,
NBLIC0.3's blend predictor and context address, the AutoMapper, the range
coder's symbol walk in both directions at every k_step (with qu == qv
among the pairs), and the int64 AVP: the solve on wrapping, singular and
near-singular systems (the strips' ``solve_batch``, which the walk
shares), the prediction, the update, the column prefix and the dual ridge
strengths.
Everything runs on CPU tensors; JAX runs its int64 functions under x64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nblic_tpu.ops import automapper as j_am
from nblic_tpu.ops import avp as j_avp
from nblic_tpu.ops import context as j_ctx
from nblic_tpu.ops import histogram as j_hist
from nblic_tpu.ops import predict as j_predict
from nblic_tpu.ops import range_coder as j_rc
from nblic_tpu.ops import rans as j_rans
from nblic_tpu.ops import window as j_window
from nblic_tpu.ops.neighbors import Neighbors as JNeighbors
from nblic_tpu_torch.ops import automapper, avp, context, histogram, predict, range_coder, rans
from nblic_tpu_torch.ops import window
from nblic_tpu_torch.ops.neighbors import Neighbors

torch.set_num_threads(1)


def t1(v):
    """A (1,) int64 tensor: the walks' per-pixel scalars."""
    return torch.tensor([int(v)], dtype=torch.int64)


@pytest.mark.parametrize("w", [1, 2, 3, 5])
def test_fresh_window_and_t_tap_every_border(w):
    rng = np.random.default_rng(w)
    cur, prev1, prev2 = (rng.integers(0, 256, w).astype(np.int32) for _ in range(3))
    tc, tp1, tp2 = (torch.from_numpy(r) for r in (cur, prev1, prev2))
    for i in range(4):
        for j in range(w):
            ref = j_window.fresh_window_rows(i, j, jnp.asarray(cur), jnp.asarray(prev1),
                                             jnp.asarray(prev2), w)
            got = window.fresh_window_rows(i, j, tc, tp1, tp2, w)
            assert [int(v) for v in ref] == [int(v) for v in got], (i, j)
            t_ref = j_window.fresh_t_tap(i, j, jnp.asarray(prev1), w, ref.d)
            assert int(t_ref) == int(window.fresh_t_tap(i, j, tp1, w, got.d)), (i, j)


def test_adaptive_bias_steps_on_negative_states():
    rng = np.random.default_rng(1)
    ctx = rng.integers(-(1 << 20), 1 << 20, 4000).astype(np.int32)
    px0 = rng.integers(0, 256, 4000).astype(np.int32)
    err = rng.integers(-255, 256, 4000).astype(np.int32)
    tc, tp, te = (torch.from_numpy(a) for a in (ctx, px0, err))
    for j_fn, fn in ((j_ctx.q_correct_px, context.q_correct_px),
                     (j_ctx.n_correct_px, context.n_correct_px)):
        for a, b in zip(j_fn(jnp.asarray(ctx), jnp.asarray(px0)), fn(tc, tp)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for j_fn, fn in ((j_ctx.q_update_ctx, context.q_update_ctx),
                     (j_ctx.n_update_ctx, context.n_update_ctx)):
        np.testing.assert_array_equal(np.asarray(j_fn(jnp.asarray(ctx), jnp.asarray(err))),
                                      fn(tc, te).numpy())
    # the two steps round differently (2^6 - 1 against 2^6)
    assert not torch.equal(context.q_update_ctx(tc, te, scale=8), context.n_update_ctx(tc, te))


def test_normalize_and_decode_lut():
    rng = np.random.default_rng(2)
    one = np.zeros(256, np.uint32)
    one[255] = 7
    dense = rng.integers(0, 5000, 256).astype(np.uint32)
    skewed = np.zeros(256, np.uint32)
    skewed[:3] = (10**6, 1, 1)
    for hist in (np.zeros(256, np.uint32), one, dense, skewed, np.ones(256, np.uint32)):
        got = histogram.normalize(hist)
        np.testing.assert_array_equal(got, j_hist.normalize(hist))
        assert got.sum() == histogram.NORM_SUM
        acc = histogram.accumulate(got)
        np.testing.assert_array_equal(histogram.decode_lut(acc), j_hist.decode_lut(acc))


def test_finalize_streams_and_dec_step_past_the_end():
    rng = np.random.default_rng(3)
    freq = rng.integers(1, 1 << 15, size=(1, 300)).astype(np.int32)
    facc = rng.integers(0, 1 << 14, size=(1, 300)).astype(np.int32)
    ref = j_rans.finalize_streams(*j_rans.encode_scan(jnp.asarray(freq), jnp.asarray(facc)))
    got = rans.finalize_streams(*rans.encode_scan(torch.from_numpy(freq),
                                                  torch.from_numpy(facc)))
    np.testing.assert_array_equal(got[0], ref[0])
    words = ref[0][:5].astype(np.int64)
    for n in (1, 2, 5):
        j_state, j_ptr = j_rans.dec_start(jnp.asarray(words[:n]))
        state, ptr = rans.dec_start(torch.from_numpy(words[:n]))
        for step in range(8):  # reads past the end take the last word
            h, ha = int(freq[0, step]), int(facc[0, step]) // 2
            lb = int(j_state) & rans.NORM_MASK
            j_state, j_ptr = j_rans.dec_step(j_state, j_ptr, jnp.asarray(words[:n]),
                                             jnp.int32(h), jnp.int32(ha), jnp.uint32(lb))
            state, ptr = rans.dec_step(state, ptr, torch.from_numpy(words[:n]), t1(h),
                                       t1(ha), t1(lb))
            assert (int(state), int(ptr)) == (int(j_state), int(j_ptr)), (n, step)
    with pytest.raises(ValueError):
        rans.dec_start(torch.zeros(0, dtype=torch.int64))


def _planes(seed, shape=(24, 20)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, shape).astype(np.int32) for _ in range(11)]


@pytest.mark.parametrize("seed", [4, 5])
def test_n_predictor_and_context_address(seed):
    planes = _planes(seed)
    if seed == 5:  # ties among the costs: few distinct values
        planes = [p % 3 * 40 for p in planes]
    jn = JNeighbors(*(jnp.asarray(p) for p in planes))
    tn = Neighbors(*(torch.from_numpy(p) for p in planes))
    px = predict.n_simple_predict(tn)
    np.testing.assert_array_equal(px.numpy(), np.asarray(j_predict.n_simple_predict(jn)))
    qu = torch.from_numpy(np.random.default_rng(seed).integers(0, 16, planes[0].shape)
                          .astype(np.int32))
    np.testing.assert_array_equal(
        predict.n_context_address(tn, px, qu).numpy(),
        np.asarray(j_predict.n_context_address(jn, jnp.asarray(px.numpy()),
                                               jnp.asarray(qu.numpy()))))


def test_automapper_sequence():
    rng = np.random.default_rng(6)
    keys = rng.integers(0, 4, 600) * 100
    ys = np.minimum(rng.geometric(0.25, 600) - 1, 30)
    jm, m = j_am.init_mappers(), automapper.init_mappers()
    for key, y in zip(keys, ys):
        z = automapper.fold(m, t1(key), t1(y))
        assert int(z) == int(j_am.fold(jm, key, y))
        assert int(automapper.unfold(m, t1(key), z)) == y
        jm = j_am.observe(jm, key, y)
        automapper.observe(m, t1(key), t1(y))
    for a, b in zip(jm, m):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


K_STEPS = (3, 5, 7, 9, 11, 13, 15, 16)  # min(3 + 2 near, 16), near 0..9


@pytest.mark.parametrize("k_step", K_STEPS)
def test_code_symbol_both_directions(k_step):
    rng = np.random.default_rng(k_step)
    n = 40
    z = np.minimum(rng.geometric(0.08, n) - 1, 255)
    qu = rng.integers(0, 16, n)
    qv = np.where(rng.random(n) < 0.3, qu, rng.integers(0, 16, n))  # qu == qv aliases
    qw = rng.integers(0, 33, n)

    @jax.jit
    def j_encode(args):
        def body(c, a):
            st, tree, _ = j_rc.code_symbol(*c, k_step, a[1], a[2], a[3], a[0], False)
            return (st, tree), None

        init = (j_rc.coder_init_encode(jnp.zeros(8192, jnp.uint8)),
                jnp.full((16, 256, 2), 32, jnp.int32))
        (st, tree), _ = jax.lax.scan(body, init, args)
        st = j_rc.coder_flush(st)
        return st.buf, st.ptr, tree

    j_buf, j_ptr, j_tree = j_encode(jnp.asarray(np.stack([z, qu, qv, qw], 1), jnp.int32))
    ref = np.asarray(j_buf)[: int(j_ptr)]
    st = range_coder.coder_init_encode(torch.zeros(8192 + 4, dtype=torch.uint8))
    tree = torch.full((16, 256, 2), 32, dtype=torch.int64)
    for a in range(n):
        st, tree, _ = range_coder.code_symbol(st, tree, k_step, t1(qu[a]), t1(qv[a]),
                                              t1(qw[a]), t1(z[a]), False)
    st = range_coder.coder_flush(st)
    np.testing.assert_array_equal(st.buf[: int(st.ptr)].numpy(), ref)
    np.testing.assert_array_equal(tree.numpy(), np.asarray(j_tree))
    st = range_coder.coder_init_decode(torch.from_numpy(ref.copy()))
    tree = torch.full((16, 256, 2), 32, dtype=torch.int64)
    out = []
    for a in range(n):
        st, tree, zz = range_coder.code_symbol(st, tree, k_step, t1(qu[a]), t1(qv[a]),
                                               t1(qw[a]), t1(0), True)
        out.append(int(zz))
    assert out == list(z)
    np.testing.assert_array_equal(tree.numpy(), np.asarray(j_tree))


def _system(rng, n, kind):
    """(a, b) int64 of a ridge system: random in the statistics' range,
    wrapping products (entries near 2^40), singular (two equal rows, a zero
    column) or near-singular (rows differing by one)."""
    if kind == "wrapping":
        a = rng.integers(-(1 << 40), 1 << 40, (n, n))
        b = rng.integers(-(1 << 40), 1 << 40, n)
    else:
        a = rng.integers(-(1 << 20), 1 << 20, (n, n))
        b = rng.integers(-(1 << 20), 1 << 20, n)
    if kind == "singular":
        a[3] = a[1]
        a[:, 5] = 0
    elif kind == "near-singular":
        a[3] = a[1] + 1
        a[4] = a[0] * 2
    elif kind == "ties":  # equal pivot magnitudes: the first maximum wins
        a[:, :] = rng.integers(-2, 3, (n, n)) * 1000
    return a.astype(np.int64), b.astype(np.int64)


@pytest.mark.parametrize("kind", ["random", "wrapping", "singular", "near-singular", "ties"])
@pytest.mark.parametrize("n", [6, 10])
def test_solve_axb(kind, n):
    """The port has one int64 solve, ``avp.solve_batch`` (systems in the
    last axis); on solve_axb's inputs it gives nblic_tpu's solve_axb bits:
    JAX's eliminated a is diagonal, and its diagonal, solved b and ok are
    the port's (diag, x_num, ok)."""
    rng = np.random.default_rng(n * 10 + len(kind))
    systems = [_system(rng, n, kind) for _ in range(6)]
    a = torch.from_numpy(np.stack([s[0] for s in systems], -1))
    b = torch.from_numpy(np.stack([s[1] for s in systems], -1))
    diag, num, ok = avp.solve_batch(a, b, n)
    with jax.enable_x64():
        for k, (sa, sb) in enumerate(systems):
            ja, jb, jok = (np.asarray(r) for r in
                           j_avp.solve_axb(jnp.asarray(sa), jnp.asarray(sb), n))
            np.testing.assert_array_equal(ja, np.diag(np.diagonal(ja)), err_msg=kind)
            np.testing.assert_array_equal(np.diagonal(ja), diag[:, k].numpy(), err_msg=kind)
            np.testing.assert_array_equal(jb, num[:, k].numpy(), err_msg=kind)
            assert bool(jok) == bool(ok[k]), kind
    if kind == "singular":
        assert not ok.any()


@pytest.mark.parametrize("n", [6, 10])
def test_avp_predict_update_prefix(n):
    rng = np.random.default_rng(n)
    m = avp.get_m(n)
    assert m == j_avp.get_m(n)
    b_cols = rng.integers(-(1 << 30), 1 << 30, (9, m))
    b_cols[:, 0] = np.abs(b_cols[:, 0])
    b_cols[:, 1 + n :] = np.abs(b_cols[:, 1 + n :])  # a dominant-ish diagonal
    e_acc = rng.integers(0, 1 << 30, m)
    feat = rng.integers(-128, 128, n)
    bias = np.array([0, 7, avp.BIAS_INIT, avp.BIAS_MAX])
    with jax.enable_x64():
        f_ref = np.array(j_avp.precalculate_f(jnp.asarray(b_cols), m))
        np.testing.assert_array_equal(avp.precalculate_f(torch.from_numpy(b_cols), m).numpy(),
                                      f_ref)
        px, ok = avp.predict(torch.from_numpy(e_acc), torch.from_numpy(f_ref[4]),
                             torch.from_numpy(feat), torch.from_numpy(bias), n)
        for k, bb in enumerate(bias):
            j_px, j_ok = j_avp.predict(jnp.asarray(e_acc), jnp.asarray(f_ref[4]),
                                       jnp.asarray(feat), jnp.int64(bb), n)
            assert (int(px[k]), bool(ok[k])) == (int(j_px), bool(j_ok)), bb
        for x, s_curr, s_sum in ((0, 0, 0), (200, 5000, -(1 << 20)), (255, 1 << 16, 1 << 30)):
            ref = j_avp.update(jnp.asarray(e_acc), jnp.asarray(b_cols[2]), jnp.asarray(feat),
                               jnp.int64(x), jnp.int64(s_curr), jnp.int64(s_sum), n)
            got = avp.update(torch.from_numpy(e_acc), torch.from_numpy(b_cols[2]),
                             torch.from_numpy(feat), t1(x), t1(s_curr), t1(s_sum), n)
            for r, g in zip(ref, got):
                np.testing.assert_array_equal(np.asarray(r), g.numpy())
        for bb in (0, 1, 5, avp.BIAS_INIT, 1000, avp.BIAS_MAX):
            ref = j_avp.dual_biases(jnp.int64(bb))
            assert [int(v) for v in avp.dual_biases(t1(bb))] == [int(v) for v in ref], bb
