"""The profile-3 near-lossless feedback walk: the dispatcher, the card
path's row loop, and the plain walk on images at the chains' extremes.

``strips._near_walk`` takes the plain walk for a CPU tensor and kernel K5
(``ops/near_walk.py``, ``csrc/p3_near_walk.cu``) for a CUDA tensor; the
kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  Here the card path's row loop, layout and bias
moments run on the CPU with each K5 launch emulated by the plain per-pixel
functions and each K9 launch (the bias's replay, ``ops/table_replay.py``)
by its plain version, and the plain walk is held to nblic_tpu on a
checkerboard, a saturated ramp, a constant image and 1-pixel stripes.
Tolerance 0.
"""

import numpy as np
import pytest
import torch

from nblic_tpu.models import strips as j_strips
from nblic_tpu_torch.constants import MAX_VAL, Q_N_CONTEXT
from nblic_tpu_torch.models import strips
from nblic_tpu_torch import kernels
from nblic_tpu_torch.ops import near_walk, pavp, table_replay
from nblic_tpu_torch.ops.context import residual_fold, residual_unfold
from nblic_tpu_torch.ops.window import row_start_window, slide_window
from nblic_tpu_torch.utils.synth import edge_images, synth_image
from test_torch_p3_table_replay import cpu_check_tensors, emulated_launch

torch.set_num_threads(1)

TUNES = {"mix": strips._near_tune(strips.TUNE_V4), "no-mix": strips._near_tune(strips.TUNE_V4S)}


@pytest.fixture(autouse=True)
def _oracle_untuned():
    # nblic_tpu reads its tune from NBLIC_P3_* at import; the oracle must
    # start from the default contract
    assert j_strips.TUNE == j_strips.TUNE_V4 and j_strips.AVP_N == 10


def _strips(seed, lanes, th, w):
    x = synth_image(np.random.default_rng(seed), lanes * th, w).reshape(lanes, th, w)
    return torch.from_numpy(x)


def _emulated_launch_row(x_row, bias, prev1, prev2, b, f, b_mix, f_mix, out, idx, dx, i,
                         near, n_feat):
    """What one K5 launch computes, on CPU tensors in the kernel's layout
    (B and F (L, W, m), the mix chains (L, W, 2)), from the plain walk's
    per-pixel functions, which take (W, m, L) views of them: F into ``f``,
    the row's pixels, B in place, row i into ``prev2``, the planes, idx
    and dx."""
    w, lanes = x_row.shape
    b, f = b.permute(1, 2, 0), f.permute(1, 2, 0)  # views: writes land in K5's layout
    if b_mix is not None:
        b_mix, f_mix = b_mix.permute(1, 2, 0), f_mix.permute(1, 2, 0)
    n_imgs = bias.numel() // Q_N_CONTEXT
    off = torch.arange(n_imgs).repeat_interleave(lanes // n_imgs) * Q_N_CONTEXT
    ab, ab_m = pavp.ab_vec(pavp.get_m(n_feat)), pavp.ab_vec(pavp.mix_ab())
    mix = b_mix is not None
    f.copy_(pavp.f_chain(b, ab=ab))
    if mix:
        f_mix.copy_(pavp.f_chain(b_mix, ab=ab_m))
    p1, p2 = prev1.t().to(torch.int64), prev2.t().to(torch.int64)  # (L, W) copies
    regs = row_start_window(i, p1, p2, w)
    err = torch.zeros(lanes, dtype=torch.int64)
    e_acc = torch.zeros((b.shape[1], lanes), dtype=torch.int64)
    e_mix = torch.zeros((2, lanes), dtype=torch.int64) if mix else None
    for j in range(w):
        px_s, feats, stats, px0, px_hard, qu, qv, qw, adr = strips._pixel_predict(
            regs, p1, err, f[j], f_mix[j] if mix else None, e_acc, e_mix, i, j, w, n_feat)
        sign, pxc, key = strips._pixel_correct(px0, bias.to(torch.int64)[off + adr])
        y = residual_fold(x_row[j].to(torch.int64), pxc, sign, near)
        xr = residual_unfold(y, pxc, sign, near)
        err = torch.clamp(xr - px0, -strips.MAX_PX_INC, strips.MAX_PX_INC)
        e_acc = strips._pixel_update(xr, px_s, feats, stats, e_acc, b, j, ab, n_feat)
        if mix:
            e_mix = strips._mix_update(xr, px_hard, px_s, e_mix, b_mix, j, ab_m)
        regs = slide_window(regs, xr, i, j, p1, p2, w)
        out[:, i, j] = torch.stack([y, qu, qv, qw, key]).to(torch.int32)
        idx[j], dx[j] = off + adr, xr - px0
        prev2[j] = xr.to(torch.uint8)
    _emulated_launch_row.launches += 1


_emulated_launch_row.launches = 0


def test_cpu_tensor_runs_the_plain_walk(monkeypatch):
    x = _strips(1, 3, 4, 12)
    want = strips._near_walk_plain(x, 1, 2, strips.AVP_N, TUNES["mix"])
    calls = []
    plain = strips._near_walk_plain

    def counted(*args):
        calls.append(args[0].device)
        return plain(*args)

    def no_kernel(*args):
        raise AssertionError("K5 launched for a CPU tensor")

    monkeypatch.setattr(strips, "_near_walk_plain", counted)
    monkeypatch.setattr(near_walk, "launch_row", no_kernel)
    got = strips._near_walk(x, 1, 2, strips.AVP_N, TUNES["mix"])
    assert calls == [torch.device("cpu")]
    assert len(got) == 5
    for u, v in zip(got, want):
        assert u.dtype == torch.int64 and u.shape == x.shape and torch.equal(u, v)


def test_other_devices_raise():
    x = _strips(2, 2, 2, 8).to("meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        strips._near_walk(x, 1, 2, strips.AVP_N, TUNES["mix"])


@pytest.mark.parametrize("near", [0, MAX_VAL + 1])
def test_near_outside_the_walks_range_raises(near):
    with pytest.raises(ValueError, match="near"):
        strips._near_walk(_strips(3, 2, 2, 8), 1, near, strips.AVP_N, TUNES["mix"])


# (lanes, images, th, w, near): lanes not a multiple of a warp, mixed
# images, a strip of one row, a column of one pixel
CARD_LOOP_CASES = {
    "lanes3-one-image": (3, 1, 4, 12, 2),
    "lanes6-three-images": (6, 3, 3, 9, 1),
    "th1": (4, 2, 1, 10, 9),
    "w1": (2, 1, 5, 1, MAX_VAL),
}


@pytest.mark.parametrize("tune", list(TUNES))
@pytest.mark.parametrize("case", list(CARD_LOOP_CASES))
def test_card_row_loop_matches_the_plain_walk(monkeypatch, case, tune):
    lanes, n_imgs, th, w, near = CARD_LOOP_CASES[case]
    x = _strips(sum(CARD_LOOP_CASES[case]), lanes, th, w)
    monkeypatch.setattr(kernels, "check_tensors", cpu_check_tensors)
    monkeypatch.setattr(near_walk, "launch_row", _emulated_launch_row)
    monkeypatch.setattr(table_replay, "launch", emulated_launch)
    before, before9 = _emulated_launch_row.launches, emulated_launch.launches
    got = strips._near_walk_card(x, n_imgs, near, strips.AVP_N, TUNES[tune])
    assert _emulated_launch_row.launches == before + th  # one launch a row
    assert emulated_launch.launches == before9 + th  # and the bias's replay after each
    want = strips._near_walk_plain(x, n_imgs, near, strips.AVP_N, TUNES[tune])
    for name, u, v in zip(("y", "qu", "qv", "qw", "key"), got, want):
        assert u.dtype == torch.int64 and u.is_contiguous() and torch.equal(u, v), name


def test_launch_row_refuses_what_k5_cannot_run():
    w, lanes, th = 4, 2, 3
    m = pavp.get_m(strips.AVP_N)
    u8, i64 = dict(dtype=torch.uint8), dict(dtype=torch.int64)
    args = [torch.zeros((w, lanes), **u8), torch.zeros(Q_N_CONTEXT, dtype=torch.int32),
            torch.zeros((w, lanes), **u8), torch.zeros((w, lanes), **u8),
            torch.zeros((lanes, w, m), **i64), torch.zeros((lanes, w, m), **i64), None, None,
            torch.zeros((5, th, w, lanes), dtype=torch.int32), torch.zeros((w, lanes), **i64),
            torch.zeros((w, lanes), **i64), 0, 2]
    with pytest.raises(ValueError, match="CUDA"):  # CPU tensors: the plain walk's
        near_walk.launch_row(*args)
    with pytest.raises(ValueError, match="features"):
        near_walk.launch_row(*args, n_feat=6)
    with pytest.raises(ValueError, match="near"):
        near_walk.launch_row(*args[:-1], 0)
    bad_out = list(args)
    bad_out[8] = torch.zeros((5, th, w, lanes + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="out"):
        near_walk.launch_row(*bad_out)
    bad_bias = list(args)
    bad_bias[1] = torch.zeros(Q_N_CONTEXT, dtype=torch.int64)  # int16 or int32 only
    with pytest.raises(ValueError, match="bias"):
        near_walk.launch_row(*bad_bias)


def test_edge_images_match_jax():
    imgs = edge_images()
    port = strips.encode_batch(imgs, th=8, near=1, device="cpu")
    assert port == j_strips.encode_batch(imgs, th=8, near=1)
    for got, im in zip(strips.decode_batch(port, device="cpu"), imgs):
        assert np.abs(got.astype(np.int32) - im).max() <= 1
