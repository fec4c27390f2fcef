"""Exact NLL through the probability-flow ODE, and the ODE sampler,
counterpart of `mulan_tpu/evals/nll_ode.py`.

  * The likelihood dequantizes the images (truncated normal on [-3, 3]
    scaled by exp(gamma_min / 2), or uniform), infers the latent on the
    requantized image, and solves [x, delta log p] from t = 0 to 1 with
    DoPri5 or RK4 (`ops/ode.py`); log p(x) is the prior's log density at
    x(1) plus delta log p. The VDM has no latent: its UNet is conditioned on
    a zero column and its latent KL is 0 (`mulan_tpu/evals/nll_ode.py:
    134-142`), and the ODE sampler conditions it on zeros too. A MuLAN's
    score UNet is conditioned on the hard top-k embedding of the encoder's
    logits, whatever `z_conditioning` says, as in JAX. So the likelihood
    refuses the variants where JAX's raises: no encoder (`reparam_type`
    other than 'true') and the Gaussian latent (`_refuse_ode_latent`); with
    `z_conditioning=False` the UNet refuses the embedding, in the
    likelihood and the sampler alike (`models/unet.py`).
  * The divergence of the drift is Hutchinson's estimate eps^T (df/dx) eps,
    by one reverse-mode vector-Jacobian product per RHS evaluation
    (`torch.autograd.grad`). Forward mode would give the same number, but
    the CUDA kernels have no forward-mode rule; reverse mode runs the
    attention kernels' backward (K2, K3) and K8's at every GN-swish site.
    The drift's weights need no gradient: only x requires grad.
  * The probe is drawn once per solve, or, with `redraw_noise`, afresh at
    each distinct RHS time t, keyed by the float32 bit pattern of t (RK4's
    two midpoint stages share one draw). DoPri5 keeps it fixed by default:
    a stochastic RHS reads as stiffness to an adaptive controller.
  * Randomness is keyed: a solve's dequantization and probe come from
    `train.loop.step_key` of its key, and `eval_bpd_ode` keys each solve by
    (iteration, batch, importance-sample group). Both draws can also be
    handed in, as `MuLAN.elbo` takes its noise.

Under `torch.distributed` each rank evaluates its shard of the eval split
(`data.create_one_time_eval_dataset`): a solve's global state is the ranks'
rows concatenated (each importance-sample copy of the global batch in
turn, as JAX tiles it), every rank draws its rows of the global
dequantization and probe (`parallel.mesh.Rows`), DoPri5's error norm is the
global state's (`ops/ode.py`, `across_ranks`), and the per-image bpd is
gathered, so every rank returns the same value (`mulan_tpu/evals/
nll_ode.py:285-340`). The ODE sampler splits its samples the same way.

The likelihood builds an autograd graph in every RHS evaluation, so it runs
outside inference mode (a tensor made inside it cannot be saved for a
backward) and each evaluation enables grad; the encoder runs under
`no_grad` and the sampler needs no gradient. Public tensors are NHWC, as
in JAX.
"""

from __future__ import annotations

import functools
import itertools
import logging
import math
from typing import Callable, Optional

import numpy as np
import torch

from mulan_tpu_torch import data as data_lib
from mulan_tpu_torch.models import latents
from mulan_tpu_torch.models.vdm import VDM
from mulan_tpu_torch.ops.ode import odeint_dopri5, odeint_rk4
from mulan_tpu_torch.parallel import mesh as mesh_lib
from mulan_tpu_torch.train.loop import ODE, step_key

logger = logging.getLogger(__name__)

_TN_LOG_Z = math.log(0.9974613)  # normalizer of TN(-3, 3)
# The draws of one solve, by `step_key(key, stream, ...)`.
_DEQUANT, _PROBE = 0, 1


def _prior_logp(z):
  """log N(z; 0, I) per example, (B,)."""
  n = math.prod(z.shape[1:])
  return (-0.5 * n * math.log(2 * math.pi)
          - 0.5 * torch.sum(z ** 2, dim=tuple(range(1, z.dim()))))


def _hutchinson_noise(generator, shape, kind: str, device):
  if kind == 'Gaussian':
    return torch.randn(shape, generator=generator, device=device)
  if kind == 'Rademacher':
    return (2 * torch.randint(0, 2, shape, generator=generator,
                              device=device) - 1).float()
  raise ValueError(f'unknown hutchinson_type: {kind!r}')


def _generator(device, seed: int) -> torch.Generator:
  return torch.Generator(device).manual_seed(seed)


def bpd_offset(dequantization: str, num_is: int,
               gamma_min: float = -13.3) -> float:
  """Constant bpd offset of each dequantization scheme
  (`mulan_tpu/evals/nll_ode.py:68`)."""
  if dequantization == 'uniform':
    return float(np.log2(128.0))
  if dequantization == 'tn':
    log_sigma = 0.5 * (gamma_min - np.logaddexp(0.0, gamma_min))
    extra = 0.0
    if num_is == 1:
      extra = 0.5 * (1 + np.log(2 * np.pi)) - 0.01522
    return float(-(extra + log_sigma) / np.log(2.0))
  raise ValueError(f'unknown dequantization: {dequantization!r}')


def _refuse_ode_latent(config) -> None:
  """Raises for a MuLAN variant whose latent JAX's ODE likelihood cannot
  read: it feeds `apply_encoder`'s output to `gumbel_kl` and
  `logits_to_embeddings` (`mulan_tpu/evals/nll_ode.py:143-151`)."""
  if config.reparam_type != 'true':
    raise ValueError(
        f'reparam_type={config.reparam_type!r}: the ODE likelihood runs the '
        'latent encoder, which this model has none of (JAX raises '
        'ScopeParamNotFoundError at mulan_tpu/evals/nll_ode.py:148)')
  if config.latent_type == 'gaussian':
    raise ValueError(
        "latent_type='gaussian': the ODE likelihood reads the encoder's "
        'output as top-k logits, not (mu, var) (JAX raises TypeError at '
        'mulan_tpu/evals/nll_ode.py:150)')


def make_ode_likelihood_fn(model, *, hutchinson_type: str = 'Rademacher',
                           rtol: float = 1e-5, atol: float = 1e-5,
                           dequantization: str = 'tn',
                           high_precision: bool = True,
                           max_steps: int = 5000, first_step: float = 0.01,
                           odeint: Callable = odeint_dopri5,
                           redraw_noise: bool = False, mesh=None):
  """Returns likelihood(images, key=0, *, u=None, probe=None, rows=None) ->
  (log_p, log_q_eps, aux_latent_loss, stats) for uint8 NHWC images: the
  first three (B,) on the model's device, `stats` the solver's {nfe,
  num_steps, num_rejected, success}. Callers must check `success` (a solve
  that hit max_steps gives an unconverged log_p).

  log_q_eps is 0 for uniform dequantization (its correction is the constant
  `bpd_offset`). `u` (the images' shape) replaces the dequantization draw
  before scaling: TN(-3, 3) samples for 'tn', U(0, 1) for 'uniform'.
  `probe` replaces the Hutchinson probe at every RHS evaluation. With
  `rows` the images are those rows of a global solve, split over the
  ranks (the batch coordinates of `mesh`): the draws are the global
  state's, cut to them, and the solver's error norm is the global state's.
  `odeint` is injectable (e.g. `functools.partial(odeint_rk4,
  num_steps=...)`).
  """
  cfg = model.config
  d = cfg.n_pixels
  if dequantization not in ('tn', 'uniform'):
    raise ValueError(f'unknown dequantization: {dequantization!r}')
  if not isinstance(model, VDM):
    _refuse_ode_latent(cfg)
  dev = model.device

  def likelihood(images, key: int = 0, *, u=None, probe=None,
                 rows: Optional[mesh_lib.Rows] = None):
    with torch.inference_mode(False):
      images = torch.as_tensor(images, device=dev).reshape(
          -1, *cfg.image_shape).float()
      b = images.shape[0]
      data = 2 * ((torch.round(images) + 0.5) / cfg.vocab_size) - 1
      if u is None:
        gen = _generator(dev, step_key(key, _DEQUANT))

        def dequant(shape):
          u = torch.empty(shape, device=dev)
          if dequantization == 'uniform':
            return u.uniform_(generator=gen)
          return torch.nn.init.trunc_normal_(u, a=-3.0, b=3.0, generator=gen)
        u = mesh_lib.draw_rows(dequant, data.shape, rows)
      u = torch.as_tensor(u, dtype=torch.float32, device=dev)
      if dequantization == 'uniform':
        u = (u - 0.5) * 2 / cfg.vocab_size
        log_q_eps = torch.zeros((b,), device=dev)
      else:
        log_q_eps = _prior_logp(u) - d * _TN_LOG_Z
        u = u * math.exp(0.5 * cfg.gamma_min)
      data = data + u

      if isinstance(model, VDM):
        aux_latent_loss = torch.zeros((b,), device=dev)
        embeddings = torch.zeros((b, 1), device=dev)
      else:  # the latent of the requantized dequantized image
        with torch.no_grad():
          requant = torch.round(torch.clip(
              (cfg.vocab_size / 2) * (data + 1) - 0.5, 0,
              cfg.vocab_size - 1))
          logits = model.apply_encoder(requant)
          aux_latent_loss = latents.gumbel_kl(logits, cfg.latent_size)
          embeddings = latents.logits_to_embeddings(logits, cfg.latent_k)

      def probe_at(t):
        if probe is not None:
          return torch.as_tensor(probe, dtype=torch.float32, device=dev)
        words = (_PROBE,)
        if redraw_noise:
          words += (int(torch.as_tensor(t, dtype=torch.float32)
                        .view(torch.int32)),)
        gen = _generator(dev, step_key(key, *words))
        return mesh_lib.draw_rows(lambda shape: _hutchinson_noise(
            gen, shape, hutchinson_type, dev), data.shape, rows)
      fixed = None if redraw_noise else probe_at(None)

      # State (B, D + 1): each example's latent row and its delta log p.
      def ode_func(t, y):
        eps = fixed if fixed is not None else probe_at(t)
        x = y[:, :d].reshape(data.shape).detach().requires_grad_()
        with torch.enable_grad():
          fx = model.reverse_ode(x, embeddings, t, high_precision)
          (eps_jac,) = torch.autograd.grad(fx, x, eps)  # eps^T (df/dx)
        div = torch.sum(eps_jac * eps, dim=(1, 2, 3))
        return torch.cat([fx.detach().reshape(b, d), div[:, None]], dim=1)

      y0 = torch.cat([data.reshape(b, d), torch.zeros((b, 1), device=dev)],
                     dim=1)
      across = {} if rows is None else {'across_ranks': True, 'mesh': mesh}
      sol = odeint(ode_func, y0, 0.0, 1.0, rtol=rtol, atol=atol,
                   max_steps=max_steps, first_step=first_step, **across)
      log_p = _prior_logp(sol.y[:, :d].reshape(data.shape)) + sol.y[:, d]
    stats = {'nfe': sol.nfe, 'num_steps': sol.num_steps,
             'num_rejected': sol.num_rejected, 'success': sol.success}
    return log_p, log_q_eps, aux_latent_loss, stats

  return likelihood


def auto_is_group(num_is: int, cap: int) -> int:
  """Importance samples in one solve: the divisor of `num_is` nearest to
  `cap` (the rows-a-solve target), at most 1.5 cap, ties to the larger."""
  divisors = [g for g in range(1, num_is + 1)
              if num_is % g == 0 and g <= cap + cap // 2]
  return min(divisors, key=lambda g: (abs(g - cap), -g))


# Rows of one solve that `is_batch=0` aims at (the train step's batch).
IS_ROWS = 128


def eval_bpd_ode(experiment, config, *, hutchinson_type: str = 'Rademacher',
                 dequantization: str = 'tn', num_is: int = 1,
                 num_iters: int = 1, rtol: float = 1e-5, atol: float = 1e-5,
                 deterministic_noise: bool = False, model=None,
                 batch_size: Optional[int] = None,
                 max_batches: Optional[int] = None,
                 high_precision: bool = True, first_step: float = 0.01,
                 max_steps: int = 5000, on_solver_failure: str = 'raise',
                 solver: str = 'dopri5', rk4_steps: int = 128,
                 is_batch: int = 0,
                 redraw_noise: Optional[bool] = None) -> float:
  """Importance-weighted exact-NLL bpd over one pass (`num_iters` passes,
  averaged) of the config's eval split, on the EMA model by default
  (`mulan_tpu/evals/nll_ode.py:213-420`).

  The importance samples of a batch are solved in groups: the batch tiled
  `group` times along its axis is one solve (`is_batch=0`: the divisor of
  num_is nearest to 128 rows a solve on each rank; `is_batch=1`: one
  sample a solve).
  Each solve's randomness is keyed by (iteration, batch, group). A batch's
  per-image estimate is log-mean-exp over the samples of log p - log q
  (log p alone for one sample) minus the latent KL averaged over the
  samples; the bpd adds `bpd_offset`.

  `solver='rk4'` replaces the adaptive DoPri5 by `rk4_steps` fixed steps.
  The probe is redrawn at every RHS time under rk4 unless
  `deterministic_noise`, and fixed within a solve under dopri5;
  `redraw_noise` overrides both. A solve that hits `max_steps` raises
  (`on_solver_failure='raise'`) or, with 'warn', logs an error and drops
  its batch from the mean; dropping more than 5% of the batches raises.
  The solver reads its error norm every step, so a failed solve is known
  when its call returns.
  """
  if on_solver_failure not in ('raise', 'warn'):
    raise ValueError(f'on_solver_failure: {on_solver_failure!r}')
  if redraw_noise is None:
    redraw_noise = solver == 'rk4' and not deterministic_noise
  if model is None:
    model = experiment.state.ema_model
  mesh = None if experiment is None else experiment.mesh
  cfg = model.config
  if solver == 'rk4':
    odeint = functools.partial(odeint_rk4, num_steps=rk4_steps)
  elif solver == 'dopri5':
    odeint = odeint_dopri5
  else:
    raise ValueError(f'unknown solver: {solver!r}')
  likelihood = make_ode_likelihood_fn(
      model, hutchinson_type=hutchinson_type, rtol=rtol, atol=atol,
      dequantization=dequantization, high_precision=high_precision,
      first_step=first_step, max_steps=max_steps, odeint=odeint,
      redraw_noise=redraw_noise, mesh=mesh)
  offset = bpd_offset(dequantization, num_is, cfg.gamma_min)

  def fail_msg(bi, stats):
    return (f'ODE solve hit max_steps={max_steps} without converging '
            f'(batch {bi}, nfe={stats["nfe"]}, '
            f'rejected={stats["num_rejected"]}); raise max_steps '
            f'or loosen rtol/atol ({rtol}/{atol}).')

  iter_means = []
  for it in range(num_iters):
    bpds, n_excluded = [], 0
    loader = data_lib.create_one_time_eval_dataset(config, batch_size, mesh)
    chunks = [{'images': batch['images']}
              for batch in itertools.islice(loader, max_batches)]
    for bi, (batch, _) in enumerate(mesh_lib.even_chunks(chunks)):
      images = torch.as_tensor(batch['images'], device=model.device)
      b = images.shape[0]
      mask = torch.as_tensor(batch.get('mask', np.ones(b, bool)),
                             device=model.device)
      rows = (mesh_lib.row_window(b, mesh)
              if mesh_lib.is_distributed() else None)
      if is_batch <= 0:
        group = auto_is_group(num_is, max(1, min(num_is, IS_ROWS // b)))
      else:
        group = min(is_batch, num_is)
      groups = [group] * (num_is // group)
      if num_is % group:
        groups.append(num_is % group)

      log_ps, log_qs, auxs = [], [], []
      batch_nfe = 0
      for gi, n_rep in enumerate(groups):
        log_p, log_q, aux, stats = likelihood(
            images.repeat(n_rep, 1, 1, 1), step_key(0, ODE, it, bi, gi),
            **({} if rows is None else {'rows': rows.tiled(n_rep)}))
        if not stats['success']:
          break
        batch_nfe += stats['nfe']
        log_ps.append(log_p.reshape(n_rep, b))
        log_qs.append(log_q.reshape(n_rep, b))
        auxs.append(aux.reshape(n_rep, b))
      if not stats['success']:
        msg = fail_msg(bi, stats)
        if on_solver_failure == 'raise':
          raise RuntimeError(msg)
        logger.error('%s — batch excluded from the BPD mean.', msg)
        n_excluded += 1
        continue
      log_ps, log_qs = torch.cat(log_ps), torch.cat(log_qs)  # (num_is, B)
      aux = torch.cat(auxs).mean(dim=0)
      if num_is == 1:
        iws = log_ps[0]
      else:
        iws = torch.logsumexp(log_ps - log_qs, dim=0) - math.log(num_is)
      per_example = mesh_lib.all_gather_rows(-iws + aux, mask, mesh)
      bpds.append(per_example.mean().item()
                  / (cfg.n_pixels * math.log(2.0)) + offset)
      logger.info('ode eval batch %d: cum bpd %.4f (nfe %d over %d grouped '
                  'solves; %d images x %d IS)', bi, np.mean(bpds),
                  batch_nfe, len(groups), len(per_example), num_is)
    if not bpds:
      raise RuntimeError('every ODE batch failed to converge; raise '
                         'max_steps or loosen rtol/atol.')
    if n_excluded:
      frac = n_excluded / (n_excluded + len(bpds))
      msg = (f'{n_excluded}/{n_excluded + len(bpds)} batches '
             f'({100 * frac:.1f}%) were excluded as unconverged — the BPD '
             f'mean is biased toward less-stiff examples.')
      if frac > 0.05:
        raise RuntimeError(msg + ' Raise max_steps or loosen rtol/atol.')
      logger.error(msg)
    iter_means.append(float(np.mean(bpds)))
    logger.info('[iter %d] test bpd: %.4f', it, iter_means[-1])
  return float(np.mean(iter_means))


def make_ode_sample_fn(model, *, rtol: float = 1e-5, atol: float = 1e-5,
                       high_precision: bool = True, max_steps: int = 5000,
                       mesh=None):
  """Returns sample(sample_size, generator=None, *, logits=None,
  prior=None, rows=None) -> (z_0, nfe): DoPri5 on the probability-flow ODE
  from t = 1 to 0, from a standard normal prior (NHWC), each example
  conditioned on the hard top-k embedding of random normal logits
  (`logits`, (sample_size, latent_size), and `prior` replace the draws),
  or, for the VDM, on zeros. With `rows`, sample_size is this rank's rows
  of the global samples (split over the batch coordinates of `mesh`): the
  draws are the global ones cut to them and the solver's error norm is the
  global state's. Decode z_0 with
  `model.generate_x`."""
  cfg = model.config
  dev = model.device

  @torch.no_grad()
  def sample(sample_size: int, generator=None, *, logits=None, prior=None,
             rows: Optional[mesh_lib.Rows] = None):
    shape = (sample_size, *cfg.image_shape)

    def randn(s):
      return torch.randn(s, generator=generator, device=dev)
    if isinstance(model, VDM):
      embeddings = torch.zeros((sample_size, 1), device=dev)
    else:
      if logits is None:
        logits = mesh_lib.draw_rows(randn, (sample_size, cfg.latent_size),
                                    rows)
      embeddings = latents.logits_to_embeddings(
          torch.as_tensor(logits, device=dev), cfg.latent_k)
    if prior is None:
      prior = mesh_lib.draw_rows(randn, shape, rows)

    def ode_func(t, y):
      return model.reverse_ode(y.reshape(shape), embeddings, t,
                               high_precision).reshape(-1)

    sol = odeint_dopri5(ode_func, torch.as_tensor(prior, device=dev)
                        .reshape(-1), 1.0, 0.0, rtol=rtol, atol=atol,
                        max_steps=max_steps, across_ranks=rows is not None,
                        mesh=mesh)
    return sol.y.reshape(shape), sol.nfe

  return sample
