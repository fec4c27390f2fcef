"""Adaptive Dormand-Prince 5(4) and fixed-grid RK4 ODE solvers, counterpart
of `mulan_tpu/ops/ode.py`.

The state lives on the caller's device; the step controller runs on the
host in float32, on 0-d CPU tensors. JAX runs the whole controller inside
a `lax.while_loop`; here each attempted step reads one number from the
device, its error norm, and decides acceptance, the next step size and
whether the solve is done or has failed from it on the host. An attempt is
six RHS evaluations, so that one transfer a step is all the synchronisation
the solve has. RK4 never synchronises.

Every scalar of the controller is float32, as in JAX (`t`, `h`, the tableau
coefficients, the error norm and the tolerances): float64 arithmetic there
would move the step sizes by rounding and change which steps are accepted.
The RHS gets `t` as a 0-d float32 CPU tensor.

  * classic DoPri5 tableau with FSAL: 6 fresh RHS evaluations a step;
  * error control as scipy's RK45: err_norm = RMS over
    err / (atol + rtol max(|y0|, |y1|)), accept when err_norm <= 1, step
    factor 0.9 err^(-1/5) clipped to [0.2, 10] (10 when err_norm == 0),
    never below `min_step`;
  * one error norm for the whole state; with `across_ranks` the state is
    split over the batch coordinates of `mesh` (each holds its rows;
    `parallel.mesh.batch_group`), and the norm is the whole state's:
    their sums of squares and element counts are all-reduced (in float64)
    before the square root, so every rank accepts the same steps and runs
    as many RHS evaluations (`mulan_tpu/ops/ode.py:14-17`, `:114`, where
    the norm runs over the global array). The ranks of a tensor group
    hold the same rows (the score UNet's output is computed whole on each
    from the same gathered channels), which a kernel that sums in no fixed
    order could still round apart: under tensor parallelism every rank
    takes rank 0's norm (`mesh.from_rank0`), so that all decide alike;
  * the solve is done when direction (t1 - t) <= 1e-12 |t1 - t0|, and has
    failed when accepted plus rejected steps reach `max_steps`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from mulan_tpu_torch.parallel import mesh as mesh_lib

# Dormand-Prince 5(4) Butcher tableau.
_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
_A = np.zeros((7, 7))
_A[1, 0] = 1 / 5
_A[2, :2] = [3 / 40, 9 / 40]
_A[3, :3] = [44 / 45, -56 / 15, 32 / 9]
_A[4, :4] = [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729]
_A[5, :5] = [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656]
_A[6, :6] = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84]
_B5 = _A[6, :7].copy()  # 5th-order solution weights (FSAL row)
_B4 = np.array([5179 / 57600, 0.0, 7571 / 16695, 393 / 640,
                -92097 / 339200, 187 / 2100, 1 / 40])
_E = _B5 - _B4  # error weights


class ODESolution(NamedTuple):
  y: torch.Tensor   # final state, float32, on the state's device
  num_steps: int    # accepted steps
  num_rejected: int
  nfe: int          # RHS evaluations
  success: bool     # False if max_steps was hit


def f32(x) -> torch.Tensor:
  """x as a 0-d float32 CPU tensor (a Python float rounds once)."""
  return torch.tensor(x, dtype=torch.float32)


def _axpy(y, s, k):
  """y + s k with one rounding (a fused multiply-add), as XLA contracts
  `y + s * k` and as CUDA's `add` with `alpha` computes it; s is a 0-d
  float32 CPU tensor."""
  return torch.add(y, k, alpha=float(s))


def _fma(a, b, c):
  """a b + c of 0-d float32 tensors, rounded once to float32 (the product
  is exact in float64)."""
  return (a.double() * b.double() + c.double()).float()


def odeint_dopri5(func: Callable, y0: torch.Tensor, t0: float, t1: float, *,
                  rtol: float = 1e-5, atol: float = 1e-5,
                  first_step: float = 0.01, max_steps: int = 10_000,
                  min_step: float = 1e-8,
                  across_ranks: bool = False, mesh=None) -> ODESolution:
  """Integrate dy/dt = func(t, y) from t0 to t1 (either direction).

  `y0` is one float tensor, flat or shaped; callers pack structured state
  (e.g. [z, delta_logp]) themselves. `func(t, y)` gets t as a 0-d float32
  CPU tensor and returns a tensor of y's shape. With `across_ranks`, y0 is
  this rank's part of a state split over the batch coordinates of `mesh`
  (the ranks with none), and the error norm is the whole state's.
  """
  y = y0.float()
  direction = torch.sign(f32(t1 - t0))
  span = torch.abs(f32(t1 - t0))
  t1f, rtol, atol = f32(t1), f32(rtol), f32(atol)
  a = {(i, j): f32(_A[i, j]) for i in range(7) for j in range(i)
       if _A[i, j] != 0.0}
  c, b5, e = ([f32(v) for v in w] for w in (_C, _B5, _E))

  def rhs(t, yy):
    return func(t, yy).float()

  t = f32(t0)
  h = direction * f32(first_step)
  k_last = rhs(t, y)
  steps = rejected = 0
  nfe = 1
  while True:
    # Clip the step to land exactly on t1.
    remaining = t1f - t
    hc = remaining if torch.abs(h) > torch.abs(remaining) else h
    k = [k_last]
    for i in range(1, 7):
      yi = y
      for j in range(i):
        if (i, j) in a:
          yi = _axpy(yi, hc * a[i, j], k[j])
      k.append(rhs(_fma(c[i], hc, t), yi))
    y1 = y
    for i in range(7):
      if _B5[i] != 0.0:
        y1 = _axpy(y1, hc * b5[i], k[i])
    err = torch.zeros_like(y)
    for i in range(7):
      if _E[i] != 0.0:
        err = _axpy(err, hc * e[i], k[i])
    scale = _axpy(atol, rtol, torch.maximum(torch.abs(y), torch.abs(y1)))
    # The one device-to-host read of the attempt.
    if across_ranks:
      sums = mesh_lib.all_reduce_sum(torch.stack([
          torch.sum(torch.square(err / scale)).double(),
          torch.tensor(float(err.numel()), dtype=torch.float64,
                       device=err.device)]), mesh_lib.batch_group(mesh))
      err_norm = mesh_lib.from_rank0(torch.sqrt(sums[0] / sums[1]).float(),
                                     mesh).cpu()
    else:
      err_norm = torch.sqrt(torch.mean(torch.square(err / scale))).cpu()
    nfe += 6
    accept = bool(err_norm <= 1.0)
    if err_norm == 0.0:
      factor = f32(10.0)
    else:
      factor = torch.clamp(f32(0.9) * err_norm ** f32(-0.2), f32(0.2),
                           f32(10.0))
    # Never shrink below min_step (guards infinite loops near stiff spots).
    h = direction * torch.maximum(torch.abs(h * factor), f32(min_step))
    if accept:
      t, y, k_last = t + hc, y1, k[6]
      steps += 1
    else:
      rejected += 1
    failed = steps + rejected >= max_steps
    if failed or bool(direction * (t1f - t) <= f32(1e-12) * span):
      return ODESolution(y, steps, rejected, nfe, not failed)


def odeint_rk4(func: Callable, y0: torch.Tensor, t0: float, t1: float, *,
               num_steps: int = 128, **unused_tolerances) -> ODESolution:
  """Fixed-grid classic RK4 over `num_steps` equal steps: exactly
  4 num_steps RHS evaluations whatever the drift's stiffness, so the cost of
  an evaluation is a dial. rtol/atol (and DoPri5's other arguments) are
  accepted and ignored, so both solvers share a call signature. The two
  midpoint stages of a step get the same t."""
  del unused_tolerances
  y = y0.float()
  h = f32(t1 - t0) / num_steps
  half = f32(0.5) * h

  def rhs(t, yy):
    return func(t, yy).float()

  for i in range(num_steps):
    t = _fma(f32(i), h, f32(t0))
    k1 = rhs(t, y)
    k2 = rhs(t + half, _axpy(y, half, k1))
    k3 = rhs(t + half, _axpy(y, half, k2))
    k4 = rhs(t + h, _axpy(y, h, k3))
    y = _axpy(y, h / f32(6.0), k1 + 2 * k2 + 2 * k3 + k4)
  return ODESolution(y, num_steps, 0, 4 * num_steps, True)
