"""The profile-3 decode walk: the dispatcher, the card path's loop, and the
plain walk against nblic_tpu on images at the chains' extremes.

``strips._decode_walk`` takes the plain walk for a CPU tensor and kernel K4
(``ops/decode_walk.py``, ``csrc/p3_decode_walk.cu``) for a CUDA tensor; the
kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  Here the card path's loop (``_decode_walk_card``: its
launches, K4's layout, the bias and mapper replays between launches) runs
on the CPU with each K4 launch emulated by the plain walk's per-pixel
functions and each K9 launch (the replay, ``ops/table_replay.py``) by its
plain version, the wrappers' checks of shapes and dtypes run for real,
on containers of the port's encoder under every contract the parser
accepts, and is held equal to the plain walk.  Tolerance 0.
"""

import numpy as np
import pytest
import torch

from nblic_tpu.models import strips as j_strips
from nblic_tpu_torch.constants import MAX_VAL, Q_N_CONTEXT
from nblic_tpu_torch.models import strips
from nblic_tpu_torch import kernels
from nblic_tpu_torch.ops import coder3, decode_walk, pavp, rans_bin, table_replay, zcodec3
from nblic_tpu_torch.ops.context import residual_unfold
from nblic_tpu_torch.ops.window import row_start_window, slide_window
from nblic_tpu_torch.utils.synth import edge_images, synth_image
from test_torch_p3_fixtures import load_fixture
from test_torch_p3_table_replay import cpu_check_tensors, emulated_launch

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _oracle_untuned():
    # nblic_tpu reads its tune from NBLIC_P3_* at import; the oracle must
    # start from the default contract
    assert j_strips.TUNE == j_strips.TUNE_V4 and j_strips.AVP_N == 10


def _emulated_launch_segment(st, bias, order, prev1, prev2, i, c0, c1, con, checked=False):
    """What one K4 launch computes, on CPU tensors in the kernel's layout
    (B and F (L, W, m), the mix chains (L, W, 2), E (L, m), the counters
    (L, cells)), from the plain walk's per-pixel functions, which take
    (W, m, L) views of them: F at the row's first launch,
    the columns' pixels segment by segment with the counters' replay at each
    segment's end, then the state back into ``st`` (the carry where the row
    goes on), row i into ``st.out`` and ``prev2``, the columns' replay
    planes."""
    words = st.words.to(torch.int64)
    _, lanes, _ = words.shape
    w = st.out.shape[1]
    n, m, ws, l_u, k_step = con.n_feat, pavp.get_m(con.n_feat), con.ws, con.n_unary, con.k_step
    l_tot = l_u + strips.L_R
    n_class, k_max = con.n_class, con.k_max
    mix, sym, seg_stats, w_pred = (bool(v) for v in (con.mix_e, con.sym_cnt, con.seg_stats,
                                                     con.w_pred))
    img = torch.arange(lanes) // con.lanes_per_image
    bias_off = img * Q_N_CONTEXT
    btab = bias.to(torch.int64)
    order = order.reshape(-1)
    ab, ab_m = pavp.ab_vec(m), pavp.ab_vec(pavp.mix_ab())
    lane = torch.arange(lanes)[:, None]
    lane_rows = torch.arange(lanes)[None] * zcodec3.N_ROW
    esc = torch.tensor(con.esc).view(-1, 1)
    cls = torch.tensor(con.cls).view(-1, 1)
    i_vals = torch.tensor(con.ival)
    r_layers = torch.arange(strips.L_R)[:, None]
    p1, p2 = prev1.t().to(torch.int64), prev2.t().to(torch.int64)  # (L, W) copies
    bw, fw = st.b.permute(1, 2, 0), st.f.permute(1, 2, 0)  # views: writes land in K4's layout
    b_mix = f_mix = None
    if mix:
        b_mix, f_mix = st.b_mix.permute(1, 2, 0), st.f_mix.permute(1, 2, 0)
    utab = st.utab.to(torch.int64).reshape(lanes, zcodec3.N_ROW, n_class, 2)
    rtab = st.rtab.to(torch.int64).reshape(lanes, zcodec3.N_ROW, zcodec3.N_REFINE, 2, 2)
    states, ptrs = list(st.rans[0].unbind(0)), list(st.rans[1].unbind(0))
    phase_words = list(words.unbind(0))
    if c0 == 0:
        fw.copy_(pavp.f_chain(bw, ab=ab))
        if mix:
            f_mix.copy_(pavp.f_chain(b_mix, ab=ab_m))
        regs = row_start_window(i, p1, p2, w)
        err = torch.zeros(lanes, dtype=torch.int64)
        e_acc = torch.zeros((m, lanes), dtype=torch.int64)
        e_mix = torch.zeros((2, lanes), dtype=torch.int64)
    else:
        regs = tuple(st.carry[:11].to(torch.int64).unbind(0))
        err = st.carry[11].to(torch.int64)
        e_acc, e_mix = st.e.t().clone(), st.e_mix.t().clone()

    def code_bin(c, p1b, active):
        b, states[c], ptrs[c] = rans_bin.dec_masked(states[c], ptrs[c], p1b, active,
                                                    phase_words[c])
        return b

    for j0 in range(c0, c1, ws):
        uprob = coder3.prob_table(utab).reshape(-1)
        rprob = coder3.prob_table(rtab).reshape(-1)
        e_seg = e_acc.clone()
        if w_pred:
            stats0 = e_seg + fw[j0]
            diag, num, ok_seg = pavp.solve_stats(stats0, n)
            wq = pavp.quantize_weights(diag, num)
        cols = []
        for j in range(j0, j0 + ws):
            nb, px_s, feats = strips._pixel_taps(regs, p1, i, j, w, n)
            if w_pred:
                px0 = torch.where(ok_seg, pavp.predict_wq(wq, feats.to(torch.int32)), px_s)
                s0 = stats0[0]
            else:
                stats = (e_seg if seg_stats else e_acc) + fw[j]
                px_f, ok = pavp.predict_from_stats(stats, feats, n)
                px_hard = strips._round_px(px_f, ok, px_s)
                px0 = px_hard
                if mix:
                    em = e_mix + f_mix[j]
                    px0 = pavp.mix_blend(px_hard, px_s, em[0], em[1], ok)
                s0 = stats[0]
                if seg_stats:
                    e_seg = pavp.decay(e_seg, ab)
            qu, qv, qw, adr = strips._pixel_ctx(nb, err, px0)
            sign, pxc, key = strips._pixel_correct(px0, btab[bias_off + adr])
            base = (i * w + j) * l_tot
            ru = zcodec3.escalated_row(qu[None], esc, k_step)
            rv = zcodec3.escalated_row(zcodec3.adjust_qv(qu, qv, k_step)[None], esc, k_step)
            ucell_u = (lane_rows + ru) * n_class + cls
            ucell_v = (lane_rows + rv) * n_class + cls
            active = torch.ones(lanes, dtype=torch.bool)
            n_ones = torch.zeros(lanes, dtype=torch.int64)
            for l in range(l_u):
                pr = (lambda c: strips._pair_prob(utab.view(-1, 2)[c])) if sym else \
                    (lambda c: uprob[c])
                b = code_bin((base + l) % 16, coder3.mix_prob(pr(ucell_u[l]), pr(ucell_v[l]),
                                                              qw), active)
                if sym:
                    utab.view(-1).index_add_(0, 2 * ucell_u[l] + b, (coder3.QW_MAX - qw) * active)
                    utab.view(-1).index_add_(0, 2 * ucell_v[l] + b, qw * active)
                n_ones, active = n_ones + b, b
            escaped = active
            stopped = ~escaped
            stop_layer = torch.clamp(n_ones, max=l_u - 1)
            stop_row = ru.gather(0, stop_layer[None])[0]
            k_end = torch.where(stopped, stop_row // k_step, 0)
            z = torch.where(stopped, (i_vals[stop_layer] >> k_max) << k_end, 0)
            kk = torch.clamp(k_end - 1 - r_layers, 0, zcodec3.N_REFINE - 1)
            act_r = (k_end - 1 - r_layers >= 0) & stopped
            rpair = ((lane_rows + stop_row) * zcodec3.N_REFINE + kk) * 2
            weight = torch.where(escaped, 1 << (7 - r_layers), 1 << kk)
            msb = torch.zeros(lanes, dtype=torch.bool)
            for l in range(strips.L_R):
                p1b = torch.full((lanes,), rans_bin.BYPASS_P1)
                if l < zcodec3.N_REFINE:
                    pair = rpair[l] + msb
                    p_ad = strips._pair_prob(rtab.view(-1, 2)[pair]) if sym else rprob[pair]
                    p1b = torch.where(escaped, rans_bin.BYPASS_P1, p_ad)
                b = code_bin((base + l_u + l) % 16, p1b, act_r[l] | escaped)
                if sym and l < zcodec3.N_REFINE:
                    rtab.view(-1).index_add_(0, 2 * pair + b, act_r[l].to(torch.int64))
                msb = msb | b
                z = z + b * weight[l]
            y = torch.where(z < coder3.N_MAP,
                            order[(img * coder3.MAP_KEYS + key) * coder3.N_MAP
                                  + torch.clamp(z, 0, coder3.N_MAP - 1)], z)
            x = residual_unfold(y, pxc, sign, con.near)
            err = torch.clamp(x - px0, -strips.MAX_PX_INC, strips.MAX_PX_INC)
            # B's column and E take the pixel at once, the segment-frozen
            # contracts too (_pixel_update reads channel 0 of the statistics)
            e_acc = strips._pixel_update(x, px_s, feats, s0[None], e_acc, bw, j, ab, n)
            if mix:
                e_mix = strips._mix_update(x, px_hard, px_s, e_mix, b_mix, j, ab_m)
            regs = slide_window(regs, x, i, j, p1, p2, w)
            st.out[i, j] = x.to(torch.uint8)
            prev2[j] = x.to(torch.uint8)
            st.replay[:, j] = torch.stack([bias_off + adr, x - px0, key, y])
            cols.append((z, qu, qv, qw))
        # the segment's end: the counters take its events (live under
        # sym_cnt) and halve
        if sym:
            utab = coder3.halve_pairs(utab, con.cnt_halve)
            rtab = coder3.halve_pairs(rtab, con.cnt_halve)
        else:
            z_c, qu_c, qv_c, qw_c = (torch.stack(v, 1) for v in zip(*cols))
            unary, refine, row_end, k_end, _ = strips._code_events(z_c, qu_c, qv_c, k_step, l_u)
            utab, rtab = coder3.row_updates(
                utab, rtab, qw_c, unary, refine,
                coder3.unary_cells(lane, unary, k_step, l_u, n_class),
                coder3.refine_cells(lane, row_end, k_end, refine[2]), con.cnt_halve)
    st.utab.copy_(utab.reshape(lanes, -1))
    st.rtab.copy_(rtab.reshape(lanes, -1))
    st.rans.copy_(torch.stack([torch.stack(states), torch.stack(ptrs)]))
    if c1 < w:
        st.carry.copy_(torch.stack([*regs, err]))
        st.e.copy_(e_acc.t())
        st.e_mix.copy_(e_mix.t())
    _emulated_launch_segment.launches += 1


_emulated_launch_segment.launches = 0


def _launches_per_row(w, tune, adaptive):
    n_seg = strips._eff_seg(tune.n_seg, w)
    per_seg = n_seg > 1 and ((tune.seg_bias and adaptive) or tune.seg_map)
    return n_seg if per_seg else 1


def _card_loop_equals_plain(monkeypatch, conts, rows=None):
    """The card path's loop, launches emulated, against the plain walk on
    the walk's arguments of ``conts`` (``rows`` cuts the walk's rows); K9
    follows every K4 launch, and K4's check runs once a walk."""
    args, _ = strips._walk_args([strips._parse(c) for c in conts], torch.device("cpu"))
    if rows is not None:
        args = (args[0], args[1], min(rows, args[2]), *args[3:])
    words, bias, th, w, s, n_imgs, n_feat, near, tune = args
    checks = []
    check = decode_walk._check
    monkeypatch.setattr(kernels, "check_tensors", cpu_check_tensors)
    monkeypatch.setattr(decode_walk, "_check", lambda *a: checks.append(a[5:8]) or check(*a))
    monkeypatch.setattr(decode_walk, "launch_segment", _emulated_launch_segment)
    monkeypatch.setattr(table_replay, "launch", emulated_launch)
    before, before9 = _emulated_launch_segment.launches, emulated_launch.launches
    got = strips._decode_walk_card(*args)
    n_launches = th * _launches_per_row(w, tune, bias is None)
    assert _emulated_launch_segment.launches - before == n_launches
    assert emulated_launch.launches - before9 == n_launches
    assert len(checks) == 1
    want = strips._decode_walk_plain(words.to(torch.int64), *args[1:])
    assert got.dtype == torch.uint8 and got.shape == (n_imgs * s, th, w)
    assert torch.equal(got, want)
    return got


def _images(seed, shapes):
    rng = np.random.default_rng(seed)
    return [synth_image(rng, *sh) for sh in shapes]


# every tune the parser accepts; its segments cut the 8 columns into 8
TUNES = ("TUNE_V1", "TUNE_V2", "TUNE_V3", "TUNE_V4", "TUNE_MAX", "TUNE_V3S", "TUNE_V4S")


@pytest.mark.parametrize("tune", TUNES)
def test_card_loop_matches_plain_under_every_tune(monkeypatch, tune):
    monkeypatch.setattr(strips, "TUNE", getattr(strips, tune))
    imgs = _images(TUNES.index(tune), [(8, 12)])  # transposed: 12 rows of 8
    conts = strips.encode_batch(imgs, th=4, device="cpu")
    got = _card_loop_equals_plain(monkeypatch, conts)
    assert np.array_equal(got.reshape(-1, 8).numpy().T, imgs[0])


# (images (h, w), th, near, AVP_N) under TUNE_V4 (the encoder's slots need
# th x W a multiple of 16): lanes not a multiple of a warp, two images in
# one walk, a 1-row strip, a strip taller than the image (th clamped to 16
# rows, 5 walked), a width TUNE_V4's 32 segments do not divide (48
# columns: 24 segments of 2), a 1-pixel column, near 1 (one image
# transposed) and 255, and the feature counts of the other instances
SHAPE_CASES = {
    "lanes6-two-images": ([(12, 8), (12, 8)], 4, 0, 10),
    "th1": ([(16, 16)], 1, 0, 10),
    "strip-taller-than-image": ([(5, 8)], 16, 0, 10),
    "w48": ([(48, 48)], 1, 0, 10),
    "w1": ([(16, 1)], 16, 0, 10),
    "near1": ([(6, 12), (12, 6)], 8, 1, 10),
    "near255": ([(4, 12)], 4, MAX_VAL, 10),
    "n_feat6": ([(4, 12)], 4, 0, 6),
    "n_feat12": ([(4, 12)], 4, 0, 12),
}


@pytest.mark.parametrize("case", list(SHAPE_CASES))
def test_card_loop_matches_plain_on_shapes(monkeypatch, case):
    shapes, th, near, n_feat = SHAPE_CASES[case]
    monkeypatch.setattr(strips, "AVP_N", n_feat)
    imgs = _images(len(case), shapes)
    conts = strips.encode_batch(imgs, th=th, near=near, device="cpu")
    assert all(strips._parse(c)[0][5] == n_feat for c in conts)
    _card_loop_equals_plain(monkeypatch, conts)
    for c, im in zip(strips.decode_batch(conts, device="cpu"), imgs):
        assert np.abs(c.astype(int) - im).max() <= near


@pytest.mark.parametrize("name", ["legacy", "static"])
def test_card_loop_matches_plain_on_legacy_fixtures(monkeypatch, name):
    # TUNE_V1 without a Tune block, and with a transmitted static bias
    # table; the first 4 rows of each strip
    stream, _ = load_fixture(name)
    assert (strips._parse(stream)[1] is not None) == (name == "static")
    _card_loop_equals_plain(monkeypatch, [stream], rows=4)


def test_card_loop_matches_plain_on_garbage(monkeypatch):
    # random payload bytes: the symbols' events are re-derived from z,
    # which a garbage stream's bins need not spell
    stream = bytearray(strips.encode(_images(9, [(8, 12)])[0], th=8, device="cpu"))
    stream[-60:] = np.random.default_rng(9).integers(0, 256, 60, dtype=np.uint8).tobytes()
    _card_loop_equals_plain(monkeypatch, [bytes(stream)])


def test_cpu_tensor_runs_the_plain_walk(monkeypatch):
    conts = strips.encode_batch(_images(11, [(4, 8)]), th=4, device="cpu")
    args, _ = strips._walk_args([strips._parse(c) for c in conts], torch.device("cpu"))
    calls = []
    plain = strips._decode_walk_plain

    def counted(*a):
        calls.append((a[0].device, a[0].dtype))
        return plain(*a)

    def no_kernel(*a):
        raise AssertionError("K4 launched for a CPU tensor")

    monkeypatch.setattr(strips, "_decode_walk_plain", counted)
    monkeypatch.setattr(decode_walk, "launch_segment", no_kernel)
    got = strips._decode_walk(*args)
    assert calls == [(torch.device("cpu"), torch.int64)]
    assert got.dtype == torch.uint8 and got.shape == (2, 4, 4)  # transposed: 8 rows of 4


def _walk_args_on(device):
    conts = strips.encode_batch(_images(12, [(4, 8)]), th=4, device="cpu")
    args, _ = strips._walk_args([strips._parse(c) for c in conts], torch.device("cpu"))
    return (args[0].to(device), *args[1:])


def test_other_devices_raise():
    with pytest.raises(ValueError, match="cpu or cuda"):
        strips._decode_walk(*_walk_args_on("meta"))


@pytest.mark.parametrize("field,value", [("near", MAX_VAL + 1), ("near", -1), ("n_feat", 0),
                                         ("n_feat", strips.N_TAPS + 1)])
def test_near_and_feature_count_outside_the_walks_range_raise(field, value):
    args = list(_walk_args_on("cpu"))
    args[{"near": 7, "n_feat": 6}[field]] = value
    with pytest.raises(ValueError, match="near" if field == "near" else "features"):
        strips._decode_walk(*args)


def test_launch_segment_refuses_what_k4_cannot_run():
    w, lanes, th, n_feat = 8, 2, 3, 10
    tune = strips.TUNE_V4
    con = decode_walk.contract(0, n_feat, tune, 4, lanes)
    words = torch.zeros((16, lanes, 64), dtype=torch.int32)
    st = decode_walk.new_state(words, th, w, con, tune.cnt_init)
    u8 = dict(dtype=torch.uint8)
    bias = torch.zeros(Q_N_CONTEXT, dtype=torch.int16)
    order = coder3.mapper_order(coder3.init_mapper(1))
    rows = [torch.zeros((w, lanes), **u8), torch.zeros((w, lanes), **u8)]
    args = [st, bias, order, *rows, 0, 0, 4, con]
    with pytest.raises(ValueError, match="CUDA"):  # CPU tensors: the plain walk's
        decode_walk.launch_segment(*args)
    for bad, match in ((con._replace(n_feat=13), "features"), (con._replace(near=256), "near"),
                       (con._replace(n_unary=21), "unary"),
                       (con._replace(lanes_per_image=3), "bias")):
        with pytest.raises(ValueError, match=match):
            decode_walk.launch_segment(*args[:-1], bad)
    with pytest.raises(ValueError, match="segments"):  # not whole segments
        decode_walk.launch_segment(*args[:5], 0, 2, 6, con)
    with pytest.raises(ValueError, match="bias"):  # int16 or int32 only
        decode_walk.launch_segment(st, bias.to(torch.int64), *args[2:])
    with pytest.raises(ValueError, match="order"):
        decode_walk.launch_segment(st, bias, order[..., :4], *args[3:])
    with pytest.raises(ValueError, match="b_mix"):  # mix_e needs the mix chains
        decode_walk.launch_segment(st._replace(b_mix=None), *args[1:])


def test_plain_walk_matches_jax_on_edge_images():
    # a checkerboard, a saturated ramp, a constant image and 1-pixel
    # stripes, the default contract, as one batch of strips of 8 rows
    imgs = edge_images()
    conts = strips.encode_batch(imgs, th=8, device="cpu")
    for got, want, im in zip(strips.decode_batch(conts, device="cpu"),
                             j_strips.decode_batch(conts), imgs):
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(got, im)
