"""The integrator kernel (``csrc/integrate_f64.cu``) and its plain versions.

Not a TPU kernel: the JAX package compiles its integrators into one XLA
program each, which the port's plain versions run as Python loops of
small f64 torch ops. Three modes:

* FIXED, :func:`fixed` (plain :func:`fixed_reference`): the fixed-step
  loop of ``propagators.propagate_fixed`` (JAX's ``lax.scan``,
  ``astroz_tpu/propagators/driver.py:30``), RK4 or DP8(7), over (L, 6)
  lanes, one launch a call;
* ADAPTIVE, :func:`adaptive` (plain :func:`adaptive_reference`): the
  adaptive DP8(7) loop of ``propagators.dp87_adaptive`` (JAX's
  ``lax.while_loop``, ``astroz_tpu/propagators/integrators.py:131``) on
  one trajectory, one launch and one read back a call;
* ATTITUDE, :func:`attitude` (plain :func:`attitude_reference`): the RK4
  loop of ``calculations.propagate_attitude`` (JAX's ``lax.scan``,
  ``astroz_tpu/calculations.py:273``), one thread a body.

FIXED and ADAPTIVE take a force model whose ``terms`` (see
``propagators/forces.py``) the kernel computes. On a CUDA tensor a
wrapper launches its kernel or raises, and adds one to its entry of
:data:`LAUNCHES`; on a CPU tensor it runs its ``*_reference``. The plain
versions are the port's torch loops as they were, here so that the
kernel and the tests hold them side by side.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build

#: kernel launches so far in this process, by mode
LAUNCHES = {"integrate_fixed": 0, "integrate_adaptive": 0,
            "integrate_attitude": 0}

#: the term kinds in the order of the kernel's ``enum Kind``, and the
#: number of parameters each takes
KINDS = ("TWO_BODY", "J2", "J3", "J4", "DRAG", "IMPROVED_DRAG", "SRP")
N_PARAMS = {"TWO_BODY": 1, "J2": 1, "J3": 1, "J4": 1, "DRAG": 4,
            "IMPROVED_DRAG": 19, "SRP": 3}
#: the kernel's limits on a model (``MAX_TERMS``, ``MAX_PARAMS``)
MAX_TERMS = 8
MAX_PARAMS = 19

F64 = torch.float64


@functools.lru_cache(maxsize=64)
def _model(terms):
    """``terms`` as the kernel's host arrays: (n, kinds i32 (MAX_TERMS,),
    params f64 (MAX_TERMS, MAX_PARAMS)); raises on what it cannot take."""
    if not terms or len(terms) > MAX_TERMS:
        raise ValueError(f"the integrator kernel takes 1 to {MAX_TERMS} "
                         f"terms, got {len(terms or ())}")
    kinds = np.zeros(MAX_TERMS, np.int32)
    params = np.zeros((MAX_TERMS, MAX_PARAMS), np.float64)
    for i, (kind, p) in enumerate(terms):
        if kind not in N_PARAMS or len(p) != N_PARAMS[kind]:
            raise ValueError(f"no kernel term {kind!r} of {len(p)} "
                             f"parameters")
        kinds[i] = KINDS.index(kind)
        params[i, :len(p)] = p
    return len(terms), kinds, params


def _model_args(model):
    """The kernel's model arguments of a force model or a deriv that
    carries ``terms``."""
    n, kinds, params = _model(tuple(getattr(model, "terms", None) or ()))
    return n, kinds.ctypes.data, params.ctypes.data


def _check_f64(name, x, shape_tail):
    if x.dtype != F64:
        raise ValueError(f"{name}: the integrator kernel takes f64, got "
                         f"{x.dtype}")
    if tuple(x.shape[-len(shape_tail):]) != shape_tail:
        raise ValueError(f"{name}: expected (..., {shape_tail[-1]}), got "
                         f"{tuple(x.shape)}")


def _launch(mode, fn, *args):
    rc = getattr(_build.library(), fn)(*args)
    if rc != 0:
        raise RuntimeError(f"{mode} kernel launch failed: cudaError {rc}")
    LAUNCHES[mode] += 1


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


# ---------------------------------------------------------------------------
# FIXED
# ---------------------------------------------------------------------------


def fixed_reference(accel, state, t0: float, n_steps: int, h: float, *,
                    method: str = "rk4", substeps: int = 1):
    """The plain fixed-step loop: ``n_steps`` samples of ``substeps`` RK4
    (or fixed DP8(7)) steps of ``h`` from ``state`` (..., 6) at ``t0``;
    returns (n_steps + 1, ..., 6), the first sample ``state``. No host
    read."""
    from ..propagators.integrators import dp87_step, make_deriv, rk4_step

    deriv = make_deriv(accel)
    step_fn = rk4_step if method == "rk4" else \
        (lambda d, s, t, h: dp87_step(d, s, t, h)[0])
    states = torch.empty((n_steps + 1, *state.shape), dtype=state.dtype,
                         device=state.device)
    states[0] = state
    t = float(t0)
    for k in range(n_steps):
        for _ in range(substeps):
            state = step_fn(deriv, state, t, h)
            t = t + h
        states[k + 1] = state
    return states


def fixed(accel, state, t0: float, n_steps: int, h: float, *,
          method: str = "rk4", substeps: int = 1):
    """:func:`fixed_reference` in one launch of FIXED on a CUDA ``state``
    (f64, (..., 6)); ``accel.terms`` must not be ``None``. No kernel term
    reads t, so the launch does not take ``t0``."""
    if state.device.type == "cpu":
        return fixed_reference(accel, state, t0, n_steps, h, method=method,
                               substeps=substeps)
    _check_f64("state", state, (6,))
    if method not in ("rk4", "dp87"):
        raise ValueError(f"method must be 'rk4' or 'dp87', got {method!r}")
    lanes = state.reshape(-1, 6).contiguous()
    out = torch.empty((n_steps + 1, *state.shape), dtype=F64,
                      device=state.device)
    _launch("integrate_fixed", "astroz_integrate_fixed", lanes.data_ptr(),
            out.data_ptr(), lanes.shape[0], int(n_steps), int(substeps),
            float(h), int(method == "dp87"),
            *_model_args(accel), _stream(state))
    return out


# ---------------------------------------------------------------------------
# ADAPTIVE
# ---------------------------------------------------------------------------


def _direction(t0: float, t1: float) -> float:
    return float((t1 > t0) - (t1 < t0))


def adaptive_reference(deriv, state, t0: float, t1: float, h: float, *,
                       rtol: float, atol: float, h_min: float, h_max: float,
                       max_substeps: int):
    """The plain adaptive DP8(7) loop from ``t0`` to ``t1`` (floats),
    starting with the signed step ``h``: the loop runs on the host and
    reads one number a substep, its error norm. Returns (state, h, steps)
    with ``h`` a float and ``steps`` an int."""
    from ..propagators.integrators import dp87_step

    direction = _direction(t0, t1)
    t, steps = t0, 0
    while (t - t1) * direction < 0 and steps < max_substeps:
        # clamp h to not overshoot t1
        hs = t1 - t if (t + h - t1) * direction > 0 else h
        y8, err = dp87_step(deriv, state, t, hs)
        scale = atol + rtol * torch.maximum(torch.abs(state), torch.abs(y8))
        err_norm = float(torch.max(torch.abs(err) / scale))
        factor = min(max(0.9 * max(err_norm, 1e-16) ** (-1.0 / 8.0), 0.1),
                     5.0)
        h = min(max(abs(hs * factor), h_min), h_max) * direction
        if err_norm <= 1.0:
            state, t = y8, t + hs
        steps += 1
    return state, h, steps


def adaptive_launch(deriv, state, t0: float, t1: float, h: float, *,
                    rtol: float, atol: float, h_min: float, h_max: float,
                    max_substeps: int):
    """One launch of ADAPTIVE on a CUDA ``state`` of 6 f64 values;
    returns its (9,) f64 output on the card, [state, t, h, steps], with
    no host read. ``deriv.terms`` must not be ``None``."""
    _check_f64("state", state, (6,))
    if state.numel() != 6:
        raise ValueError(f"state: the adaptive kernel takes one trajectory "
                         f"of 6 values, got {tuple(state.shape)}")
    y = state.reshape(6).contiguous()
    out = torch.empty(9, dtype=F64, device=state.device)
    _launch("integrate_adaptive", "astroz_integrate_adaptive", y.data_ptr(),
            out.data_ptr(), float(t0), float(t1), float(h),
            _direction(t0, t1), float(rtol), float(atol), float(h_min),
            float(h_max), int(max_substeps), *_model_args(deriv),
            _stream(state))
    return out


def adaptive(deriv, state, t0: float, t1: float, h: float, *, rtol: float,
             atol: float, h_min: float, h_max: float, max_substeps: int):
    """:func:`adaptive_reference` in one launch of ADAPTIVE on a CUDA
    ``state``, then one read of (h, steps)."""
    kw = dict(rtol=rtol, atol=atol, h_min=h_min, h_max=h_max,
              max_substeps=max_substeps)
    if state.device.type == "cpu":
        return adaptive_reference(deriv, state, t0, t1, h, **kw)
    out = adaptive_launch(deriv, state, t0, t1, h, **kw)
    h_final, steps = out[7:9].tolist()
    return out[:6].view(state.shape), h_final, int(steps)


# ---------------------------------------------------------------------------
# ATTITUDE
# ---------------------------------------------------------------------------


def attitude_reference(q, w, inertia, torque, dt, n_steps: int):
    """The plain attitude loop: ``n_steps`` RK4 steps of ``dt`` of
    quaternion kinematics and Euler's equations, ``q`` renormalized each
    step. Returns (q, omega)."""
    from ..calculations import _cross, _norm, quaternion_derivative

    def deriv(q, w):
        qd = quaternion_derivative(q, w)
        # Euler: I wdot = T - w x (I w)
        iw = inertia * w
        wd = (torque - _cross(w, iw)) / inertia
        return qd, wd

    for _ in range(n_steps):
        k1q, k1w = deriv(q, w)
        k2q, k2w = deriv(q + 0.5 * dt * k1q, w + 0.5 * dt * k1w)
        k3q, k3w = deriv(q + 0.5 * dt * k2q, w + 0.5 * dt * k2w)
        k4q, k4w = deriv(q + dt * k3q, w + dt * k3w)
        q = q + dt / 6.0 * (k1q + 2 * k2q + 2 * k3q + k4q)
        w = w + dt / 6.0 * (k1w + 2 * k2w + 2 * k3w + k4w)
        q = q / _norm(q, keepdim=True)
    return q, w


def attitude(q, w, inertia, torque, dt: float, n_steps: int):
    """:func:`attitude_reference` in one launch of ATTITUDE on CUDA
    tensors (f64; ``q`` (..., 4), the others (..., 3), broadcast to one
    batch), ``dt`` a float."""
    if q.device.type == "cpu":
        return attitude_reference(q, w, inertia, torque, dt, n_steps)
    for name, x, n in (("q", q, 4), ("omega", w, 3), ("inertia", inertia, 3),
                       ("torque", torque, 3)):
        _check_f64(name, x, (n,))
    if n_steps <= 0:
        return q, w
    batch = torch.broadcast_shapes(q.shape[:-1], w.shape[:-1],
                                   inertia.shape[:-1], torque.shape[:-1])
    q0, w0, i0, t0 = (x.expand(*batch, x.shape[-1]).reshape(-1, x.shape[-1])
                      .contiguous() for x in (q, w, inertia, torque))
    q_out = torch.empty((*batch, 4), dtype=F64, device=q.device)
    w_out = torch.empty((*batch, 3), dtype=F64, device=q.device)
    _launch("integrate_attitude", "astroz_integrate_attitude", q0.data_ptr(),
            w0.data_ptr(), i0.data_ptr(), t0.data_ptr(), q_out.data_ptr(),
            w_out.data_ptr(), q0.shape[0], int(n_steps), float(dt),
            _stream(q))
    return q_out, w_out
