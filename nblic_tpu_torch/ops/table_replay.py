"""The profile-3 image-table replay on the card: kernel K9
(``csrc/p3_table_replay.cu``), one launch after each K4 or K5 launch.

What an image's strip lanes share in a profile-3 walk: the bias moments
(``n_imgs * 3072`` int64 sums and counts) with the int16 table of their
quantized means that the walk kernels read, and the AutoMapper's history
(``(n_imgs, 512, 20)`` int64) with its order z -> y that the decoder
reads.  The JAX package updates them inside the jitted ``lax.scan`` of its
walks (``nblic_tpu/models/strips.py::_decode_seg``, ``_near_rows``; no
``pallas_call``).  The port's walks run a kernel a row or a column segment
(``strips._decode_walk_card``: K4, ``strips._near_walk_card``: K5), and
between those launches K9 folds the pixels the last launch wrote (their
replay planes, (W, L) int64 each) into the tables: the mapper's and the
bias's events of the columns, the halving of every entry past its
threshold, and the rewrite of the int16 table and the order wherever an
entry changed.  Its plain version :func:`replay_plain` is the torch
sequence the walks ran between their launches before
(:func:`bias_update`, ``context.quantize_bias``, ``coder3.mapper_updates``
and ``coder3.mapper_order``).  The tables live in a :class:`Tables` on
the card for the whole walk; besides the plain version's state they hold
a bit an entry past its threshold (their marks), which K9 keeps so that
its sweeps visit only those entries.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..constants import Q_N_CONTEXT
from . import coder3
from .context import quantize_bias

BIAS_WORDS = Q_N_CONTEXT // 32      # mark words of an image's contexts
MAP_WORDS = coder3.MAP_KEYS // 32   # and of its keys


def bias_update(bsums, bcnts, idx, err, cap: int):
    """Fold coded pixels into the bias moments, halving both moments of a
    context past ``cap`` events.  bsums/bcnts: (B * C,) per image's
    contexts; idx: flat (image * C + adr) indexes; err: raw errors."""
    bsums = bsums.index_add(0, idx.reshape(-1), err.reshape(-1))
    bcnts = bcnts.index_add(0, idx.reshape(-1), torch.ones_like(idx).reshape(-1))
    over = bcnts > cap
    return torch.where(over, bsums >> 1, bsums), torch.where(over, bcnts >> 1, bcnts)


class Contract(NamedTuple):
    """The replay's constants: the walk's lanes an image and width, and
    the container's replay contract (``strips.Tune``)."""

    lanes_per_image: int
    w: int
    bias_cap: int
    bias_shrink: int
    map_bump: int
    map_halve: int


def contract(tune, lanes_per_image: int, w: int) -> Contract:
    return Contract(lanes_per_image, w, tune.bias_cap, tune.bias_shrink, tune.map_bump,
                    tune.map_halve)


class Tables(NamedTuple):
    """An image's shared tables for every image of a walk, image-major."""

    bsum: torch.Tensor   # (n_imgs * 3072,) int64 bias sums
    bcnt: torch.Tensor   # (n_imgs * 3072,) int64 bias counts
    bmark: torch.Tensor  # (n_imgs, 96) int32: bit b of word g, context 32 g + b past bias_cap
    btab: torch.Tensor   # (n_imgs * 3072,) int16 quantize_bias of the moments, or the static table
    mhist: torch.Tensor  # (n_imgs, 512, 20) int64 mapper history
    mmark: torch.Tensor  # (n_imgs, 16) int32: a bit a key whose largest count passes map_halve
    order: torch.Tensor  # (n_imgs, 512, 20) int64 coder3.mapper_order of the history


def over_bits(over):
    """(..., 32 k) bool -> (..., k) int32 words, bit b of word g entry 32 g + b."""
    bits = over.reshape(*over.shape[:-1], -1, 32).to(torch.int64)
    words = (bits << torch.arange(32, device=over.device)).sum(-1)
    return (((words + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def new_tables(n_imgs: int, con: Contract, device, bias_tab=None) -> Tables:
    """The tables at a walk's start: the moments at 0 and their table 0
    (quantize_bias of contexts without events), or ``bias_tab``, a static
    (n_imgs * 3072,) table with values in int16, which no replay changes;
    the mapper at ``coder3.init_mapper`` and its order; the marks of what
    starts past its threshold."""
    i64 = dict(dtype=torch.int64, device=device)
    bsum = torch.zeros(n_imgs * Q_N_CONTEXT, **i64)
    btab = torch.zeros(n_imgs * Q_N_CONTEXT, dtype=torch.int16, device=device)
    if bias_tab is not None:
        btab.copy_(bias_tab)
    mhist = coder3.init_mapper(n_imgs, device)
    return Tables(bsum, torch.zeros_like(bsum),
                  torch.zeros((n_imgs, BIAS_WORDS), dtype=torch.int32, device=device), btab,
                  mhist, over_bits(mhist.amax(-1) > con.map_halve), coder3.mapper_order(mhist))


def replay_plain(tb: Tables, planes, con: Contract, map_cols=None, bias_cols=None) -> None:
    """K9's plain version: the mapper's events of the columns ``map_cols``
    = (c0, c1), the bias moments' of ``bias_cols`` (either None: that table
    is not replayed), from the (W, L) int64 planes (idx, dx, key, y), lanes
    image-major (key and y may be None without ``map_cols``); then the
    int16 table and the order from the new state, and the marks.  Updates
    ``tb`` in place, as K9 does."""
    idx, dx, key, y = planes
    if map_cols is not None:
        n_imgs = tb.mhist.shape[0]
        img = torch.arange(n_imgs, device=key.device).repeat_interleave(con.lanes_per_image)
        cols = slice(*map_cols)
        mhist = coder3.mapper_updates(tb.mhist, img, key[cols].t(), y[cols].t(), con.map_bump,
                                      con.map_halve)
        tb.mhist.copy_(mhist)
        tb.order.copy_(coder3.mapper_order(mhist))
        tb.mmark.copy_(over_bits(mhist.amax(-1) > con.map_halve))
    if bias_cols is not None:
        cols = slice(*bias_cols)
        bsum, bcnt = bias_update(tb.bsum, tb.bcnt, idx[cols], dx[cols], con.bias_cap)
        tb.bsum.copy_(bsum)
        tb.bcnt.copy_(bcnt)
        # quantize_bias clamps to [-2048, 2047]: the int16 copy is exact
        tb.btab.copy_(quantize_bias(bsum, bcnt, con.bias_shrink))
        tb.bmark.copy_(over_bits((bcnt > con.bias_cap).view(-1, Q_N_CONTEXT)))


class Walk(NamedTuple):
    """A walk's replay as :func:`prepare` checked it: its tables, planes
    and contract."""

    tables: Tables
    planes: tuple
    con: Contract


def prepare(tb: Tables, planes, con: Contract) -> Walk:
    """Check a walk's tables and its (idx, dx, key, y) planes once, before
    its first :func:`launch`: (W, L) int64 planes (key and y both None
    where no launch replays the mapper), L a multiple of the contract's
    lanes an image, tables of L / lanes_per_image images, everything on one
    CUDA device, contiguous.  Raises ValueError on anything K9 cannot run."""
    idx, dx, key, y = planes
    if idx.dim() != 2:
        raise ValueError(f"idx must be (W, L), got {tuple(idx.shape)}")
    w, lanes = idx.shape
    n_imgs, rem = divmod(lanes, con.lanes_per_image) if con.lanes_per_image >= 1 else (0, 1)
    if rem or not n_imgs or w != con.w or not w:
        raise ValueError(f"{lanes} lanes of {w} columns are not whole images of "
                         f"{con.lanes_per_image} lanes of {con.w}")
    if con.bias_cap < 1 or con.map_halve < 1:
        raise ValueError(f"bias_cap and map_halve must be at least 1, got {con.bias_cap} and "
                         f"{con.map_halve}")
    if (key is None) != (y is None):
        raise ValueError("key and y come together (the mapper's replay) or not at all")
    i64, i32 = torch.int64, torch.int32
    ctx, hist = (n_imgs * Q_N_CONTEXT,), (n_imgs, coder3.MAP_KEYS, coder3.N_MAP)
    want = {"idx": (idx, (w, lanes), i64), "dx": (dx, (w, lanes), i64),
            "bsum": (tb.bsum, ctx, i64), "bcnt": (tb.bcnt, ctx, i64),
            "bmark": (tb.bmark, (n_imgs, BIAS_WORDS), i32),
            "btab": (tb.btab, ctx, torch.int16), "mhist": (tb.mhist, hist, i64),
            "mmark": (tb.mmark, (n_imgs, MAP_WORDS), i32), "order": (tb.order, hist, i64)}
    if key is not None:
        want["key"] = (key, (w, lanes), i64)
        want["y"] = (y, (w, lanes), i64)
    kernels.check_tensors(want, idx.device, "K9")
    return Walk(tb, tuple(planes), con)


def launch(walk: Walk, map_cols=None, bias_cols=None) -> None:
    """One replay (kernel K9) of a :func:`prepare`-d walk: the mapper's
    events of the columns ``map_cols`` = (c0, c1) and the bias moments' of
    ``bias_cols`` (either None: that table is not replayed), as
    :func:`replay_plain` computes them; updates the tables in place.
    Launches on the current stream and counts the launch; columns out of
    the walk, or neither replay, raise."""
    idx, dx, key, y = walk.planes
    tb, con = walk.tables, walk.con
    m0, m1 = map_cols if map_cols is not None else (0, 0)
    b0, b1 = bias_cols if bias_cols is not None else (0, 0)
    if map_cols is not None and bias_cols is not None and m1 != b1:
        raise ValueError(f"the two replays end at one column, got {m1} and {b1}")
    if map_cols is not None and key is None:
        raise ValueError("the mapper's replay needs the key and y planes")
    rc = kernels.library().nbt_p3_table_replay(
        idx.data_ptr(), dx.data_ptr(), None if key is None else key.data_ptr(),
        None if y is None else y.data_ptr(), tb.bsum.data_ptr(), tb.bcnt.data_ptr(),
        tb.bmark.data_ptr(), tb.btab.data_ptr(), tb.mhist.data_ptr(), tb.mmark.data_ptr(),
        tb.order.data_ptr(), idx.shape[1], idx.shape[1] // con.lanes_per_image, con.w,
        con.bias_cap, con.bias_shrink, con.map_bump, con.map_halve, int(map_cols is not None),
        m0, int(bias_cols is not None), b0, max(m1, b1), *kernels.stream_of(idx))
    kernels.check(rc, "nbt_p3_table_replay")
    launch.launches += 1


launch.launches = 0
