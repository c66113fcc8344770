"""The integrator kernel (``csrc/integrate_f64.cu``): its launches.

Not a TPU kernel: the JAX package compiles its integrators into one XLA
program each; the port's plain versions run them as Python loops of
small f64 torch ops and stay beside their callers, which choose the
route once (``kernel if state.is_cuda and terms else plain``). Modes:

* FIXED, :func:`fixed`: the fixed-step loop of
  ``propagators.propagate_fixed`` (plain ``driver.fixed_reference``; JAX's
  ``lax.scan``, ``astroz_tpu/propagators/driver.py:30``), RK4 or DP8(7),
  over (L, 6) lanes, one launch a call;
* TRAJECTORY, :func:`trajectory`: ``Propagator.propagate`` over a
  ``DormandPrince87`` (plain ``integrators.adaptive_trajectory_reference``;
  JAX's Python loop of ``dp87_adaptive`` calls,
  ``astroz_tpu/propagators/driver.py:76``), every outer step in one
  launch, no read; and :func:`adaptive`, ``propagators.dp87_adaptive``
  on one trajectory (plain ``integrators.adaptive_reference``; JAX's
  ``lax.while_loop``, ``astroz_tpu/propagators/integrators.py:131``) as
  TRAJECTORY's one outer step, one launch and one read back a call,
  counted as ``integrate_adaptive``;
* ATTITUDE, :func:`attitude`: the RK4 loop of
  ``calculations.propagate_attitude`` (plain
  ``calculations.attitude_reference``; JAX's ``lax.scan``,
  ``astroz_tpu/calculations.py:273``), one thread a body.

FIXED and TRAJECTORY take a force model whose ``terms`` (see
``propagators/forces.py``) the kernel computes. Each wrapper takes CUDA
tensors only: it launches its kernel or raises, and adds one to its entry
of :data:`LAUNCHES`. :func:`divide_probe` holds the kernel's divides
through a reciprocal to ``__ddiv_rn`` on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build

#: kernel launches so far in this process, by mode
LAUNCHES = {"integrate_fixed": 0, "integrate_adaptive": 0,
            "integrate_trajectory": 0, "integrate_attitude": 0,
            "integrate_divide_probe": 0}

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


def _check_cuda(name, x):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the integrator kernel takes a CUDA "
                         f"tensor, got one on {x.device}")


def _launch(mode, fn, *args):
    rc = getattr(_build.library(), fn)(*args)
    if rc != 0:
        raise RuntimeError(f"{mode} kernel launch failed: cudaError {rc}")
    LAUNCHES[mode] += 1


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _one_trajectory(state):
    _check_f64("state", state, (6,))
    if state.numel() != 6:
        raise ValueError(f"state: the adaptive kernel takes one trajectory "
                         f"of 6 values, got {tuple(state.shape)}")
    _check_cuda("state", state)
    return state.reshape(6).contiguous()


def fixed(accel, state, t0: float, n_steps: int, h: float, *,
          method: str = "rk4", substeps: int = 1):
    """``n_steps`` samples of ``substeps`` RK4 (or fixed DP8(7)) steps of
    ``h`` from ``state`` (f64, (..., 6), CUDA) in one launch of FIXED;
    returns (n_steps + 1, ..., 6), the first sample ``state``.
    ``accel.terms`` must not be ``None``; no kernel term reads t, so the
    launch does not take ``t0`` (the plain loop's signature)."""
    _check_f64("state", state, (6,))
    if method not in ("rk4", "dp87"):
        raise ValueError(f"method must be 'rk4' or 'dp87', got {method!r}")
    _check_cuda("state", state)
    lanes = state.reshape(-1, 6).contiguous()
    out = torch.empty((n_steps + 1, *state.shape), dtype=F64,
                      device=state.device)
    _launch("integrate_fixed", "astroz_integrate_fixed", lanes.data_ptr(),
            out.data_ptr(), lanes.shape[0], int(n_steps), int(substeps),
            float(h), int(method == "dp87"),
            *_model_args(accel), _stream(state))
    return out


def _trajectory_launch(mode, deriv, state, t0, dt, t_last, n, h_in, *,
                       rtol, atol, h_min, h_max, max_substeps):
    """One launch of TRAJECTORY, counted under ``mode``; ``h_in`` NaN for
    no carried |h|."""
    y = _one_trajectory(state)
    n_outer = max(int(n) - 1, 0)
    dev = state.device
    states = torch.empty((n_outer + 1, *state.shape), dtype=F64, device=dev)
    subs = torch.empty(n_outer, dtype=torch.int64, device=dev)
    hs = torch.empty(n_outer, dtype=F64, device=dev)
    info = torch.empty(4, dtype=F64, device=dev)
    _launch(mode, "astroz_integrate_trajectory", y.data_ptr(),
            states.data_ptr(), subs.data_ptr(), hs.data_ptr(),
            info.data_ptr(), float(t0), float(dt), float(t_last), n_outer,
            float(h_in), float(rtol), float(atol), float(h_min),
            float(h_max), int(max_substeps), *_model_args(deriv),
            _stream(state))
    return states, subs, hs, info


def trajectory(deriv, state, t0: float, dt: float, n: int, *, rtol: float,
               atol: float, h_carried, h_min: float, h_max: float,
               max_substeps: int):
    """``Propagator.propagate``'s ``n - 1`` outer steps of ``dt`` from
    ``t0`` over a ``DormandPrince87`` in one launch of TRAJECTORY, on a
    CUDA ``state`` of 6 f64 values, the integrator's |h| ``h_carried``
    (``None`` for none) carried across them; no host read. Returns
    (states (n, *state.shape), substeps (n - 1,) i64, hs (n - 1,) f64,
    info (4,) f64), all on the card: each outer step's state, substeps
    and |h| after it (the state of a step that took ``max_substeps``
    where the cap left it, rows past it NaN), and [outer steps
    completed, |h| carried out (NaN for none), substeps in all, the
    signed h after the last outer step run]."""
    t0, dt = float(t0), float(dt)
    # the last outer step's end as the loop forms it: numpy's t0 + dt * k,
    # then a float add
    t_last = (t0 + dt * float(max(int(n) - 2, 0))) + dt
    h_in = float("nan") if h_carried is None else float(h_carried)
    return _trajectory_launch(
        "integrate_trajectory", deriv, state, t0, dt, t_last, n, h_in,
        rtol=rtol, atol=atol, h_min=h_min, h_max=h_max,
        max_substeps=max_substeps)


def adaptive(deriv, state, t0: float, t1: float, h: float, *, rtol: float,
             atol: float, h_min: float, h_max: float, max_substeps: int):
    """``dp87_adaptive`` from ``t0`` to ``t1`` on a CUDA ``state`` of 6 f64
    values with the signed step ``h``: one launch of TRAJECTORY for one
    outer step (its |h| is ``h`` times the direction of time, which gives
    ``h`` back), then one read of (substeps, h). Returns (state, h,
    steps) as ``integrators.adaptive_reference`` does. ``deriv.terms``
    must not be ``None``."""
    t0, t1, h = float(t0), float(t1), float(h)
    sign = float((t1 > t0) - (t1 < t0)) or 1.0
    states, _, _, info = _trajectory_launch(
        "integrate_adaptive", deriv, state, t0, 0.0, t1, 2, h * sign,
        rtol=rtol, atol=atol, h_min=h_min, h_max=h_max,
        max_substeps=max_substeps)
    _, _, steps, h_final = info.tolist()
    return states[1], h_final, int(steps)


def attitude(q, w, inertia, torque, dt: float, n_steps: int):
    """``n_steps`` RK4 steps of ``dt`` (a float) of quaternion kinematics
    and Euler's equations in one launch of ATTITUDE on CUDA tensors (f64;
    ``q`` (..., 4), the others (..., 3), broadcast to one batch); returns
    (q, omega)."""
    for name, x, n in (("q", q, 4), ("omega", w, 3), ("inertia", inertia, 3),
                       ("torque", torque, 3)):
        _check_f64(name, x, (n,))
        _check_cuda(name, x)
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


def divide_probe(a, b):
    """The kernel's quotients a / b (through y = RN(1/b) and two
    corrections where a and b lie in its window, ``__ddiv_rn`` elsewhere)
    and ``__ddiv_rn``'s, and its reciprocals of b and ``__ddiv_rn(1,
    b)``'s, on CUDA f64 tensors of one shape: (got, want, rcp,
    rcp_want)."""
    for name, x in (("a", a), ("b", b)):
        if x.dtype != F64:
            raise ValueError(f"{name}: the divide probe takes f64")
        _check_cuda(name, x)
    a, b = (x.contiguous() for x in torch.broadcast_tensors(a, b))
    out = [torch.empty_like(a) for _ in range(4)]
    _launch("integrate_divide_probe", "astroz_integrate_divide_probe",
            a.data_ptr(), b.data_ptr(), *(x.data_ptr() for x in out),
            a.numel(), _stream(a))
    return tuple(out)
