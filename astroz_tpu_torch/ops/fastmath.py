"""Fast f32 math of the propagation tail, in plain torch.

Counterpart of ``astroz_tpu/ops/fastmath.py:37-142, 206-236``. Every
function is a chain of single IEEE-rounded f32 operations, written in
the same order as the JAX package's, so the CUDA kernels (``csrc/``,
built without FMA contraction) compute the same bits from the same
inputs. Python float constants are rounded to
f32 by torch exactly as JAX rounds its weakly typed ones.
"""

from __future__ import annotations

import torch

TWO_OVER_PI = 0.6366197723675814
# pi/2 split for Cody-Waite reduction: k * PIO2_HI is exact in f32 for
# k < 2^16 (the high part has 8 mantissa bits)
PIO2_HI = 2.0 * 0.78515625
PIO2_MED = 2.0 * 2.4187564849853515625e-4
PIO2_LO = 2.0 * 3.77489497744594108e-8

# Cephes f32 minimax coefficients on |y| <= pi/4
_S1 = -1.6666654611e-1
_S2 = 8.3321608736e-3
_S3 = -1.9515295891e-4
_C1 = 4.166664568298827e-2
_C2 = -1.388731625493765e-3
_C3 = 2.443315711809948e-5


def sincos(x: torch.Tensor):
    """(sin x, cos x) of an f32 tensor with |x| < ~1e4: quadrant
    k = round-half-even(x * 2/pi), three-part Cody-Waite reduction,
    minimax polynomials and a branchless quadrant fix-up."""
    k = torch.round(x * TWO_OVER_PI)
    y = ((x - k * PIO2_HI) - k * PIO2_MED) - k * PIO2_LO
    y2 = y * y
    sp = y + y * y2 * (_S1 + y2 * (_S2 + y2 * _S3))
    cp = 1.0 - 0.5 * y2 + y2 * y2 * (_C1 + y2 * (_C2 + y2 * _C3))
    q = k.to(torch.int32) & 3
    swap = (q & 1) == 1
    s = torch.where(swap, cp, sp)
    c = torch.where(swap, sp, cp)
    s = torch.where((q & 2) == 2, -s, s)
    c = torch.where(((q + 1) & 2) == 2, -c, c)
    return s, c


def angle_add(sin_a: torch.Tensor, cos_a: torch.Tensor, delta: torch.Tensor):
    """(sin, cos) of ``a + delta`` for small |delta| (< ~0.1 rad): the
    addition theorem with a Taylor sincos of delta."""
    d2 = delta * delta
    sd = delta * (1.0 - d2 * (1.0 / 6.0) * (1.0 - 0.05 * d2))
    cd = 1.0 - 0.5 * d2 * (1.0 - d2 * (1.0 / 12.0))
    return (sin_a * cd + cos_a * sd,
            cos_a * cd - sin_a * sd)


def recip_pos(x: torch.Tensor) -> torch.Tensor:
    """1 / x for strictly positive x, as a true divide."""
    return 1.0 / x


def div_pos(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den for strictly positive den, as a true divide."""
    return num / den


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root of an f32 tensor, on any backend:
    the f64 root rounded to f32 (some CPU builds of torch take an f32
    sqrt that is off by an ulp; the kernel's sqrtf is exact)."""
    return torch.sqrt(x.double()).to(x.dtype)


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(x) from a correctly rounded sqrt and divide (torch.rsqrt
    is an approximation on CUDA, which would split the kernel from its
    plain version)."""
    return 1.0 / sqrt_rn(x)


#: odd minimax polynomial of atan on [-1, 1], degree 15 (the JAX
#: package's coefficients)
_AT = (0.9999994161665577, -0.33330223078054766, 0.1995111999819918,
       -0.1393327926026066, 0.09709489254190584, -0.05688293268565614,
       0.022568342982102904, -0.004257856903975933)
_HALF_PI = 1.5707963267948966
_PI = 3.141592653589793


def fast_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Polynomial atan2 of f32 tensors, range (-pi, pi]: octant folding
    to a ratio in [0, 1], the degree-15 polynomial, quadrant fix-up.
    atan2(0, 0) is 0."""
    abs_y = torch.abs(y)
    abs_x = torch.abs(x)
    swap = abs_y > abs_x
    num = torch.where(swap, abs_x, abs_y)
    den = torch.where(swap, abs_y, abs_x)
    den = torch.where(den > 0.0, den, 1.0)
    z = num / den
    z2 = z * z
    a = _AT[7]
    for c in reversed(_AT[:7]):
        a = c + z2 * a
    a = z * a
    a = torch.where(swap, _HALF_PI - a, a)
    a = torch.where(x < 0.0, _PI - a, a)
    return torch.where(y < 0.0, -a, a)


def fast_cbrt(x: torch.Tensor) -> torch.Tensor:
    """cbrt(x) of an f32 tensor with x > 0: a third of the exponent by a
    bit trick (int32 floor division of the bits by 3, which truncates
    for positive x), then three Newton steps with true divides."""
    i = x.view(torch.int32)
    y = (torch.div(i, 3, rounding_mode="floor") + 0x2A511CD0).view(
        torch.float32)
    y = (2.0 * y + x / (y * y)) * (1.0 / 3.0)
    y = (2.0 * y + x / (y * y)) * (1.0 / 3.0)
    y = (2.0 * y + x / (y * y)) * (1.0 / 3.0)
    return y


def pow23(x: torch.Tensor) -> torch.Tensor:
    """x^(2/3) for x > 0."""
    c = fast_cbrt(x)
    return c * c
