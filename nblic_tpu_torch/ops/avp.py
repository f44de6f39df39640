"""AVP constants and C-truncating division, as the parallel AVP uses them.

The port's own copy of what ``ops/pavp.py`` needs from
``nblic_tpu/ops/avp.py``: the decay denominators of the moment chains, the
fixed-point shifts of the ridge solve and prediction, and ``tdiv``.
"""

from __future__ import annotations

import torch

FIT_BASE = 128
ALPHA = 5   # decay denominator of the regression moments
BETA = 3    # decay denominator of the error-energy channel
FB1 = 12
FB2 = 2
FB3 = FB1 - FB2


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
