"""Two-float ("double-float32") arithmetic on torch float32 tensors.

Counterpart of prisim_tpu/twofloat.py. The NUDFT phase cycle count
nu*(s.b)/c reaches ~1e3 cycles, so it is carried as an unevaluated sum
hi + lo of two float32 values (~2^-44 relative) and reduced modulo 1
exactly. df_sincos_cycles turns such a count into an f32 phasor; the
port's NUDFT engines take the reduced count, which is exact in float64,
into a float64 phasor instead (engine/nudft.py).

PyTorch runs each operation as its own kernel, so nothing is contracted
into an FMA or re-associated: the Dekker/Veltkamp algorithms below are
exact as written, on the CPU and on the card alike. Constants that enter
a compensated product (2*pi here, the frequency-grid scalars in
engine/nudft.py) must be float32 TENSORS: a Python float operand would be
split in float64 and its two_prod would no longer be exact.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["two_sum", "fast_two_sum", "split", "two_prod", "df_add",
           "df_mul", "df_frac", "df_sincos_cycles", "df_dot3", "split_f64",
           "join_f64", "TWO_PI_HI", "TWO_PI_LO"]

# Veltkamp split constant for float32 (2^12 + 1).
_SPLIT_F32 = 4097.0

# 2*pi as a two-float32 (hi rounds to 6.2831855; lo carries the residual).
TWO_PI_HI = float(np.float32(2.0 * np.pi))
TWO_PI_LO = float(np.float32(2.0 * np.pi - float(np.float32(2.0 * np.pi))))


def two_sum(a, b):
    """Knuth exact addition: a + b = s + e with s = fl(a+b)."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def fast_two_sum(a, b):
    """Dekker exact addition, requires |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a):
    """Veltkamp split of a float32 into 12-bit hi and lo halves."""
    t = _SPLIT_F32 * a
    hi = t - (t - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Dekker exact multiplication: a * b = p + e with p = fl(a*b)."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_add(xh, xl, yh, yl):
    """(xh+xl) + (yh+yl) -> normalized two-float."""
    sh, se = two_sum(xh, yh)
    te = xl + yl + se
    return fast_two_sum(sh, te)


def df_mul(xh, xl, yh, yl):
    """(xh+xl) * (yh+yl) -> normalized two-float (drops xl*yl)."""
    ph, pe = two_prod(xh, yh)
    pe = pe + (xh * yl + xl * yh)
    return fast_two_sum(ph, pe)


def df_frac(xh, xl):
    """Reduce a two-float to its fractional part in [-0.5, 0.5].

    Valid while |xh| < 2^23. torch.round rounds half to even, as
    jnp.round does."""
    n = torch.round(xh + xl)
    h = xh - n
    return fast_two_sum(h, xl)


def df_sincos_cycles(ch, cl, two_pi=(TWO_PI_HI, TWO_PI_LO)):
    """(cos, sin) of 2*pi*(ch+cl) for a frac-reduced two-float cycle count.

    The radian conversion is a two-float product (ah + al) and the
    residual enters through the first-order rotation
    sin(ah+al) ~= sin + cos*al, cos(ah+al) ~= cos - sin*al. `two_pi` is
    the (hi, lo) pair of 2*pi, floats or tensors, each taken in ch's
    dtype."""
    tph, tpl = (torch.as_tensor(x, dtype=ch.dtype, device=ch.device)
                for x in two_pi)
    ah, al = df_mul(ch, cl, tph, tpl)
    c = torch.cos(ah)
    s = torch.sin(ah)
    return c - s * al, s + c * al


def df_dot3(ah, al, bh, bl):
    """Two-float dot product of 3-vectors along the last axis.

    a, b: (..., 3) two-float tensors (broadcastable). Returns (...,)."""
    ph, pl = two_prod(ah[..., 0], bh[..., 0])
    pl = pl + (ah[..., 0] * bl[..., 0] + al[..., 0] * bh[..., 0])
    for k in (1, 2):
        qh, ql = two_prod(ah[..., k], bh[..., k])
        ql = ql + (ah[..., k] * bl[..., k] + al[..., k] * bh[..., k])
        ph, pl = df_add(ph, pl, qh, ql)
    return ph, pl


def split_f64(x):
    """Split a float64 array into (hi, lo) float32 numpy arrays,
    hi + lo ~= x (host side)."""
    x = np.asarray(x, dtype=np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def join_f64(hi, lo):
    """Recombine two-float32 into float64 numpy (host side, for tests)."""
    if isinstance(hi, torch.Tensor):
        hi = hi.detach().cpu().numpy()
    if isinstance(lo, torch.Tensor):
        lo = lo.detach().cpu().numpy()
    return np.asarray(hi, dtype=np.float64) + np.asarray(lo, dtype=np.float64)
