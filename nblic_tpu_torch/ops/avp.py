"""AVP: the reference's online int64 least-squares predictor, and its
constants and C-truncating division as the parallel AVP uses them.

The port's own copy of ``nblic_tpu/ops/avp.py``.  ``ops/pavp.py`` (profile
3) needs the decay denominators, the fixed-point shifts and :func:`tdiv`;
the NBLIC0.3 walk (efforts 2-3) runs the per-pixel functions below: the
feature vector, the right-to-left prefix F of the column moments, the
ridge solve by int64 Gaussian elimination with partial pivoting, the
fixed-point prediction, the decayed rank-1 moment update and the two
candidate ridge strengths.  All int64; products and shifts wrap as the
reference's C does, and every quotient truncates toward zero.  One solve,
``solve_batch``, serves both: the strips' planes put a pixel in each
column, the NBLIC0.3 walk the two ridge strengths of one pixel.  Where the
divisor is a positive constant or a clipped positive sum the walk divides
with ``torch.div(rounding_mode="trunc")``, one operation where
:func:`tdiv` takes six; a solve's pivots may be negative, so its
quotients go through :func:`tdiv` (a truncating division of -2^63 by -1
traps).
"""

from __future__ import annotations

import functools

import torch

from ..constants import MAX_VAL

FIT_BASE = 128
ALPHA = 5   # decay denominator of the regression moments
BETA = 3    # decay denominator of the error-energy channel
FB1 = 12
FB2 = 2
FB3 = FB1 - FB2
BIAS_INIT = 2 << FB2
BIAS_MAX = 1024 << FB2
BIAS_COEF = 21
N_LIST = (-1, 0, 6, 10)  # features per effort


def tdiv(a, b):
    """C-truncating (round-toward-zero) integer division, as the reference's
    int64 math: the quotient of the magnitudes, negated where the signs
    differ.  Never divides by -1, so no operand can trap."""
    return tdiv_by(a, torch.abs(b), b < 0)


def tdiv_by(a, b_abs, b_neg):
    """:func:`tdiv` by a divisor given as its magnitude and sign, for many
    numerators over one divisor."""
    q = torch.div(torch.abs(a), b_abs, rounding_mode="floor")
    return torch.where((a < 0) ^ b_neg, -q, q)


def _div(a, b):
    return torch.div(a, b, rounding_mode="trunc")


def get_m(n: int) -> int:
    """Length of the sufficient statistics: energy, n moments, n x n."""
    return 1 + n + n * n


@functools.lru_cache(maxsize=None)
def _decay(m: int, device):
    """Decay denominators of the m statistics: BETA, then ALPHA."""
    return torch.tensor([BETA] + [ALPHA] * (m - 1), dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=None)
def _eye(n: int, device):
    """The (n, n, 1) int64 identity, made once per device: the walk solves
    every pixel."""
    return torch.eye(n, dtype=torch.int64, device=device)[:, :, None]


def features(nb, t_tap, n: int):
    """The first n of taps a, b, c, d, e, f, t, h, q, g, minus FIT_BASE: (n,)."""
    order = (nb.a, nb.b, nb.c, nb.d, nb.e, nb.f, t_tap, nb.h, nb.q, nb.g)
    return torch.cat(order[:n]).to(torch.int64) - FIT_BASE


def precalculate_f(b_cols: torch.Tensor, m: int) -> torch.Tensor:
    """Right-to-left decayed prefix F of the column moments B: (W, m) ->
    (W, m); the decay applies to F of column j + 1, zero right of the row."""
    ab = _decay(m, b_cols.device)
    f = torch.zeros(m, dtype=torch.int64, device=b_cols.device)
    out = torch.empty_like(b_cols)
    for j in range(b_cols.shape[0] - 1, -1, -1):
        f = _div(f * (ab - 1) + ab // 2, ab) + b_cols[j]
        out[j] = f
    return out


def solve_batch(a, b, n: int):
    """int64 Gaussian elimination, pixel axis last.  a: (n, n, P), b: (n, P).

    Partial pivoting by |A[i, k]| (the first maximum wins), C-truncating
    quotients of full products.  Returns (diag, x_num, ok): solution k is
    x_num[k] / diag[k]; ok is false where a pivot was 0.  The system is
    eliminated as one augmented (n, n + 1, P) matrix, each level's
    quotients over its one divisor at once.
    """
    p = a.shape[2]
    m = torch.cat([a, b[:, None]], 1)
    rows = torch.arange(n, device=a.device)[:, None, None]
    ok = torch.ones(p, dtype=torch.bool, device=a.device)

    def divisor(akk):
        nonlocal ok
        ok = ok & (akk != 0)
        safe = torch.where(akk == 0, 1, akk)
        return torch.abs(safe), safe < 0

    for k in range(n - 1):
        piv = k + torch.argmax(torch.abs(m[k:, k]), dim=0)  # (P,)
        row_p = m.gather(0, piv.view(1, 1, p).expand(1, n + 1, p))
        m = torch.where(rows == piv, m[k : k + 1], m)  # row piv takes row k
        m[k] = row_p[0]
        d_abs, d_neg = divisor(m[k, k])
        m[k + 1 :, k + 1 :] -= tdiv_by(m[k, k + 1 :][None] * m[k + 1 :, k : k + 1], d_abs,
                                       d_neg)
        m[k + 1 :, k] = 0
    for k in range(n - 1, 0, -1):
        d_abs, d_neg = divisor(m[k, k])
        m[:k, n] -= tdiv_by(m[k, n][None] * m[:k, k], d_abs, d_neg)
    return torch.diagonal(m[:, :n]).t(), m[:, n], ok


def predict_from_solve(diag, num, feats):
    """Fixed-point prediction (FB1) from a solved system and features
    (n, P)."""
    safe = torch.where(diag == 0, 1, diag)
    terms = tdiv(((num * feats) << FB2) + (safe >> 1), safe)
    return torch.clamp((FIT_BASE << FB1) + terms.sum(0), 0, MAX_VAL << FB1)


def predict(e_acc, f_col, feat, bias, n: int):
    """Ridge solve of the decayed statistics at each strength of ``bias``
    (P,) -> (fixed-point prediction (P,), ok (P,))."""
    stats = e_acc + f_col
    b = stats[1 : 1 + n, None] + (bias << FB3)
    a = stats[1 + n :].view(n, n, 1) + _eye(n, stats.device) * (bias * n)
    diag, num, ok = solve_batch(a, b, n)
    return predict_from_solve(diag, num, feat[:, None]), ok


def update(e_acc, b_col, feat, x, s_curr, s_sum, n: int):
    """Decayed rank-1 update of the statistics by pixel x: returns
    (e_acc', b_col')."""
    xf = x.to(torch.int64) - FIT_BASE
    s_sum = torch.clamp(s_sum + (1 << FB1), 1 << FB1, 16 << FB1)
    half = s_sum >> 1
    vb = _div(((xf * feat) << (4 + FB1 + FB1)) + half, s_sum)
    va = _div(((feat[:, None] * feat[None, :]) << (4 + FB2 + FB1)) + half, s_sum)
    stats = torch.cat((s_curr.reshape(1), vb, va.reshape(-1)))
    ab = _decay(get_m(n), e_acc.device)
    b_col = _div(b_col * (ab - 1) + (ab >> 1), ab) + stats
    e_acc = _div(e_acc * (ab - 1) + (ab >> 1), ab) + b_col
    return e_acc, b_col


def dual_biases(bias):
    """The two candidate ridge strengths around ``bias``."""
    b1 = torch.clamp(torch.clamp(_div(bias * BIAS_COEF, BIAS_COEF + 1), min=-1),
                     max=bias - 1)
    b2 = torch.clamp(_div(bias * (BIAS_COEF + 1), BIAS_COEF), min=bias + 1).clamp(
        max=BIAS_MAX + 1)
    return torch.clamp(b1, 0, BIAS_MAX), torch.clamp(b2, 0, BIAS_MAX)
