"""The profile-3 decode walk on the card: kernel K4
(``csrc/p3_decode_walk.cu``), one launch a row or a column segment.

Counterpart of ``nblic_tpu/models/strips.py::_decode_seg``, which the JAX
package runs as a jitted ``lax.scan`` (no ``pallas_call``).  The plain
version is ``models/strips.py::_decode_walk_plain``; the dispatcher
``strips._decode_walk`` takes it for a CPU tensor and runs the loop around
:func:`launch_segment` for a CUDA tensor (``strips._decode_walk_card``).
What a lane owns lives in a :class:`State` on the card in K4's layout: K4
runs one warp a lane, so a lane's channels and counters are contiguous (B,
F (L, W, m), the counter tables (L, cells)), the rows and the replay
planes lanes fastest; what an image's lanes share (the bias table and the
mapper's order) is handed to each launch, and kernel K9
(``ops/table_replay.py``) updates it from the replay planes between
launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import kernels
from ..constants import MAX_VAL, Q_N_CONTEXT
from . import coder3, rans_bin, zcodec3

N_FEAT_MAX = 12      # AVP taps a container may name (strips.N_TAPS)
MAX_UNARY = 20       # Tune.n_unary's bound
N_CARRY = 12         # the window's 11 registers and the error
N_REPLAY = 4         # a pixel's image x 3072 + context address, x - px0, key, y
REFINE_CELLS = zcodec3.N_ROW * zcodec3.N_REFINE * 2 * 2
CTA_WARPS = 2        # lanes (warps) a CTA, 1 to 4; fewer where the counters pass its memory


class Contract(NamedTuple):
    """The walk's constants as K4 takes them: the container's replay
    contract, the escalation step and zcodec3's layer constants."""

    near: int
    k_step: int
    k_max: int
    n_class: int
    n_unary: int
    ws: int          # columns a segment
    cnt_halve: int
    lanes_per_image: int
    sym_cnt: int
    seg_stats: int
    w_pred: int
    mix_e: int
    n_feat: int
    esc: tuple       # per unary layer: the escalations before it
    cls: tuple       # its counter class
    ival: tuple      # its unary bin position

    def ints(self) -> list[int]:
        """The 73 ints of the C entry: the scalars, then each layer tuple
        padded to MAX_UNARY."""
        pad = (0,) * (MAX_UNARY - self.n_unary)
        return [*self[:13], *self.esc, *pad, *self.cls, *pad, *self.ival, *pad]


def contract(near: int, n_feat: int, tune, ws: int, lanes_per_image: int) -> Contract:
    """The :class:`Contract` of a walk: ``tune`` the container's replay
    contract (``strips.Tune``), ``ws`` its columns a segment."""
    k_step = min(3 + 2 * near, zcodec3.N_ROW)  # strips._k_step
    lc = zcodec3.layer_consts(k_step, tune.n_unary)
    seg_stats = int(bool(tune.seg_stats))
    return Contract(near, k_step, lc.k_max, lc.n_class, tune.n_unary, ws, tune.cnt_halve,
                    lanes_per_image, int(bool(tune.sym_cnt)), seg_stats,
                    int(bool(tune.w_pred)) & seg_stats, int(bool(tune.mix_e)) & (1 - seg_stats),
                    n_feat, lc.esc_counts, lc.cls_vals, lc.i_vals)


class State(NamedTuple):
    """What K4 keeps of every lane between launches."""

    words: torch.Tensor    # (16, L, wmax) int32 u16 words
    rans: torch.Tensor     # (2, 16, L) int64 states, then pointers
    utab: torch.Tensor     # (L, 16 n_class 2) int32 unary counts
    rtab: torch.Tensor     # (L, 320) int32 refine counts
    b: torch.Tensor        # (L, W, m) int64 column moments
    f: torch.Tensor        # (L, W, m) int64, F of the row
    b_mix: torch.Tensor | None  # (L, W, 2) int64 under mix_e, else None
    f_mix: torch.Tensor | None
    carry: torch.Tensor    # (12, L) int32 window and error between a row's launches
    e: torch.Tensor        # (L, m) int64 E between a row's launches
    e_mix: torch.Tensor    # (L, 2) int64
    out: torch.Tensor      # (th, W, L) uint8 the decoded pixels
    replay: torch.Tensor   # (4, W, L) int64: image x 3072 + address, x - px0, key, y


def new_state(words, th: int, w: int, con: Contract, cnt_init: int) -> State:
    """The initial :class:`State` of a walk of the (16, L, wmax) int32
    streams ``words`` over th x w pixels, on their device; the counters
    start at ``cnt_init``."""
    lanes = words.shape[1]
    dev = words.device
    m = 1 + con.n_feat + con.n_feat * con.n_feat
    i32 = dict(dtype=torch.int32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    state, ptr = rans_bin.dec_init(words[..., :2])
    utab = torch.full((lanes, zcodec3.N_ROW * con.n_class * 2), cnt_init, **i32)
    rtab = torch.full((lanes, REFINE_CELLS), cnt_init, **i32)
    mix = (lambda: torch.zeros((lanes, w, 2), **i64)) if con.mix_e else (lambda: None)
    return State(words, torch.stack([state, ptr]), utab, rtab,
                 torch.zeros((lanes, w, m), **i64), torch.zeros((lanes, w, m), **i64), mix(),
                 mix(), torch.zeros((N_CARRY, lanes), **i32), torch.zeros((lanes, m), **i64),
                 torch.zeros((lanes, 2), **i64),
                 torch.zeros((th, w, lanes), dtype=torch.uint8, device=dev),
                 torch.zeros((N_REPLAY, w, lanes), **i64))


def _check(st: State, bias, order, prev1, prev2, i: int, c0: int, c1: int, con: Contract):
    if not 1 <= con.n_feat <= N_FEAT_MAX:
        raise ValueError(f"K4 serves 1 to {N_FEAT_MAX} AVP features, got {con.n_feat}")
    if not 0 <= con.near <= MAX_VAL:  # the header keeps near in one byte
        raise ValueError(f"the decode walk serves near in 0..{MAX_VAL}, got {con.near}")
    if not 1 <= con.n_unary <= MAX_UNARY:
        raise ValueError(f"K4 serves 1 to {MAX_UNARY} unary layers, got {con.n_unary}")
    if st.words.dim() != 3 or st.words.shape[0] != rans_bin.N_PHASE or st.words.shape[2] < 2:
        raise ValueError(f"words must be ({rans_bin.N_PHASE}, L, wmax >= 2), got "
                         f"{tuple(st.words.shape)}")
    _, lanes, _ = st.words.shape
    th, w, _ = st.out.shape
    if not (0 <= i < th and 0 <= c0 < c1 <= w and con.ws >= 1 and c0 % con.ws == 0
            and (c1 - c0) % con.ws == 0 and w % con.ws == 0):
        raise ValueError(f"row {i}, columns [{c0}, {c1}) are not whole segments of "
                         f"{con.ws} in a ({th}, {w}) walk")
    m = 1 + con.n_feat + con.n_feat * con.n_feat
    n_imgs, rem = divmod(bias.numel(), Q_N_CONTEXT)
    if bias.dim() != 1 or bias.dtype not in (torch.int16, torch.int32) or rem or not n_imgs \
            or lanes != n_imgs * con.lanes_per_image:
        raise ValueError(f"bias must be (n_images * {Q_N_CONTEXT},) int16 or int32 with "
                         f"{con.lanes_per_image} of the {lanes} lanes an image, got "
                         f"{tuple(bias.shape)} {bias.dtype}")
    i32 = torch.int32
    want = {"words": (st.words, st.words.shape, i32),
            "rans": (st.rans, (2, rans_bin.N_PHASE, lanes), torch.int64),
            "utab": (st.utab, (lanes, zcodec3.N_ROW * con.n_class * 2), i32),
            "rtab": (st.rtab, (lanes, REFINE_CELLS), i32),
            "b": (st.b, (lanes, w, m), torch.int64), "f": (st.f, (lanes, w, m), torch.int64),
            "carry": (st.carry, (N_CARRY, lanes), i32),
            "e": (st.e, (lanes, m), torch.int64), "e_mix": (st.e_mix, (lanes, 2), torch.int64),
            "out": (st.out, (th, w, lanes), torch.uint8),
            "replay": (st.replay, (N_REPLAY, w, lanes), torch.int64),
            "prev1": (prev1, (w, lanes), torch.uint8), "prev2": (prev2, (w, lanes), torch.uint8),
            "order": (order, (n_imgs, coder3.MAP_KEYS, coder3.N_MAP), torch.int64),
            "bias": (bias, tuple(bias.shape), bias.dtype)}
    if (st.b_mix is None) != (not con.mix_e) or (st.f_mix is None) != (not con.mix_e):
        raise ValueError("b_mix and f_mix come with mix_e and only with it")
    if con.mix_e:
        want["b_mix"] = (st.b_mix, (lanes, w, 2), torch.int64)
        want["f_mix"] = (st.f_mix, (lanes, w, 2), torch.int64)
    kernels.check_tensors(want, st.words.device, "K4")
    kernels.check_int16(bias)  # the kernel reads the table as int16


@functools.lru_cache(maxsize=16)
def _c_ints(con: Contract):
    """The contract's ints as the C entry takes them, made once a contract."""
    ints = con.ints()
    return (ctypes.c_int * len(ints))(*ints)


def launch_segment(st: State, bias, order, prev1, prev2, i: int, c0: int, c1: int,
                   con: Contract, checked: bool = False) -> None:
    """Row ``i``, columns [c0, c1) of the decode walk for every lane
    (kernel K4): whole segments of ``con.ws``; the row's first launch (c0 =
    0) also computes F, and a launch that stops short of the row's end
    keeps the window, the error and E in ``st`` for the next one.

    bias: (n_images * 3072,) the image's tables, int16, or int32 with
    values in int16 (checked, at the cost of a readback, and cast); order:
    (n_images, 512, 20) int64 ``coder3.mapper_order``; lanes image-major,
    ``con.lanes_per_image`` an image; prev1 / prev2: (W, L) uint8 decoded
    rows i-1 and i-2, row i written into ``prev2``.  Writes row i of
    ``st.out`` and the columns' ``st.replay``, and updates the lanes' state
    in place.  Everything lies on one CUDA device, contiguous; anything
    else raises.  Launches on the current stream and counts the launch.
    ``checked``: the caller has run :func:`_check` on this walk's tensors
    (``strips._decode_walk_card`` does, once a walk); the launch then
    checks nothing itself.
    """
    if not checked:
        _check(st, bias, order, prev1, prev2, i, c0, c1, con)
    lanes, w = st.words.shape[1], st.out.shape[1]
    if not lanes:
        return
    lib = kernels.library()
    mix = st.b_mix is not None
    bias16 = bias.to(torch.int16)
    rc = lib.nbt_p3_decode_segment(
        st.words.data_ptr(), st.words.shape[2], st.rans.data_ptr(), st.utab.data_ptr(),
        st.rtab.data_ptr(), st.b.data_ptr(), st.f.data_ptr(), st.b_mix.data_ptr() if mix else None,
        st.f_mix.data_ptr() if mix else None, st.carry.data_ptr(), st.e.data_ptr(),
        st.e_mix.data_ptr(), prev1.data_ptr(), prev2.data_ptr(),
        bias16.data_ptr(), order.data_ptr(), st.out[i].data_ptr(), st.replay.data_ptr(),
        lanes, w, i, c0, c1, _c_ints(con), CTA_WARPS,
        *kernels.stream_of(st.words))
    kernels.check(rc, "nbt_p3_decode_segment")
    launch_segment.launches += 1


launch_segment.launches = 0
