"""`optimizer.fused` and `optimizer.stacked` (`mulan_tpu/train/optimizer.py:
80-84`, `:127-258`) against JAX's `make_fused_adamw` and
`make_stacked_adamw`: three updates of the same gradients on the tiny
model's parameters (seeded, handed to flax through `params.to_flax`), with
and without clipping, the non-score group at half the rate; each update
against JAX's at `tests/test_fused_optimizer.py`'s tolerances, plus two
float32 spacings of the parameter that receives it (torch's AdamW rounds
the parameter twice an update: after the decay's product and after the
step). The stacked variant refuses the arguments it does not
implement, as JAX's does; both run through `Experiment` from the command
line's overrides.
"""

import dataclasses

from flax.traverse_util import flatten_dict, unflatten_dict
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mulan_tpu.train import optimizer as jax_optimizer
from mulan_tpu_torch import configs, params
from mulan_tpu_torch.train import optimizer as port_optimizer
from mulan_tpu_torch.train.loop import Experiment
from torch_port_helpers import seeded_pair

# tests/test_fused_optimizer.py's tolerances.
RTOL, ATOL = 1e-5, 1e-9
ARGS = {'b1': 0.9, 'b2': 0.99, 'eps': 1e-8, 'weight_decay': 0.01}
LR, SCALE = 2e-3, 0.5


@pytest.fixture(scope='module')
def pair():
  _, jax_params, port = seeded_pair(configs.tiny_synthetic().model)
  return jax_params, port


@pytest.mark.parametrize('clip', [None, 1.0], ids=['no_clip', 'clip'])
@pytest.mark.parametrize('variant', ['fused', 'stacked'])
def test_variant_matches_jax(pair, variant, clip):
  jax_params, port = pair
  tx = jax_optimizer.make_optimizer(
      {'name': 'adamw', 'args': ARGS, 'gradient_clip_norm': clip,
       variant: True},
      jax_optimizer.make_lr_schedule(LR, 0, 100, False),
      gamma_lr_scale=SCALE)
  opt_state = tx.init(jax_params)
  update = jax.jit(tx.update)
  theirs = jax_params

  named = [(k, torch.nn.Parameter(p.detach().clone()))
           for k, p in port.named_parameters()]
  mine = dict(named)
  opt = port_optimizer.make_optimizer(
      named, configs.OptimizerConfig(
          args=configs.AdamWArgs(**ARGS), learning_rate=LR,
          gradient_clip_norm=clip, **{variant: True}),
      port_optimizer.make_lr_schedule(LR, 0, 100, False), SCALE)
  option = {'fused': 'fused', 'stacked': 'foreach'}[variant]
  assert opt.adamw.defaults[option] is True

  shapes = {k: np.shape(v) for k, v in
            flatten_dict(jax_params, sep='/').items()}
  rs = np.random.RandomState(7)
  for step in range(3):
    grads = {k: (0.1 * rs.standard_normal(s)).astype(np.float32)
             for k, s in sorted(shapes.items())}
    if clip is not None:
      assert np.sqrt(sum((g * g).sum() for g in grads.values())) > clip
    updates, opt_state = update(unflatten_dict(
        {tuple(k.split('/')): jnp.asarray(v) for k, v in grads.items()}),
                                opt_state, theirs)
    theirs = optax.apply_updates(theirs, updates)
    before = {k: p.detach().numpy().astype(np.float64)
              for k, p in mine.items()}
    for name, g in params.from_flax(grads).items():
      mine[name].grad = g
    opt.step()
    want = params.from_flax({k: np.asarray(v) for k, v in
                             flatten_dict(updates, sep='/').items()})
    for name, w in want.items():
      w = w.numpy().astype(np.float64)
      got = mine[name].detach().numpy() - before[name]
      tol = ATOL + RTOL * np.abs(w) + 2 * np.spacing(
          np.abs(before[name]).astype(np.float32))
      excess = np.abs(got - w) - tol
      assert excess.max() <= 0, (step, name, excess.max())
      assert np.abs(w).max() > 0, (step, name)


def test_stacked_refuses_unimplemented_args():
  """An argument beyond b1, b2, eps and weight_decay: JAX's stacked
  variant and the port's raise ValueError naming it; the default and the
  fused variant take the config."""
  extra = dataclasses.make_dataclass(
      'Args', [*((k, float, v) for k, v in ARGS.items()),
               ('nesterov', bool, True)], frozen=True)()
  named = [('score_model.w', torch.nn.Parameter(torch.ones(2)))]
  schedule = port_optimizer.make_lr_schedule(LR, 0, 100, False)
  with pytest.raises(ValueError, match=r"args \['nesterov'\]"):
    port_optimizer.make_optimizer(named, configs.OptimizerConfig(
        args=extra, stacked=True), schedule)
  with pytest.raises(ValueError, match=r"args \['nesterov'\]"):
    jax_optimizer.make_optimizer(
        {'name': 'adamw', 'args': {**ARGS, 'nesterov': True},
         'stacked': True}, jax_optimizer.make_lr_schedule(LR, 0, 100, False))
  for flags in ({}, {'fused': True}, {'fused': True, 'stacked': True}):
    port_optimizer.make_optimizer(named, configs.OptimizerConfig(
        args=extra, **flags), schedule)


@pytest.mark.parametrize('variant', ['fused', 'stacked'])
def test_variant_trains_from_the_command_line(variant):
  """`--config.optimizer.<variant>=True` on tiny_synthetic: two steps (one
  super-step) of `Experiment.train` within 5% of one update (lr) of the
  default implementation's, and a state_dict of the same layout. Rounding
  apart, the variants compute the same update; the first step's rounding
  reaches the second step's gradients of the tensors whose gradient is 0
  but for rounding (a bias ahead of a GroupNorm), and Adam turns those
  into updates up to 1e-6 apart."""
  runs = {}
  for flags in ([], [f'--config.optimizer.{variant}=True']):
    cfg = configs.from_command_line('tiny_synthetic', [
        '--config.training.num_steps_lr_warmup=0', *flags])
    assert getattr(cfg.optimizer, variant) == bool(flags)
    ex = Experiment(cfg, device='cpu')
    history = ex.train(2)
    runs[bool(flags)] = (history, ex.state)
  (history, state), (got_history, got_state) = runs[False], runs[True]
  np.testing.assert_allclose([h['bpd'] for h in got_history],
                             [h['bpd'] for h in history], rtol=1e-5)
  lr = configs.tiny_synthetic().optimizer.learning_rate
  for name, p in state.params.items():
    np.testing.assert_allclose(got_state.params[name].detach().numpy(),
                               p.detach().numpy(), rtol=0, atol=0.05 * lr,
                               err_msg=name)
  sd, got_sd = (s.optimizer.state_dict() for s in (state, got_state))
  assert sd['state'].keys() == got_sd['state'].keys()
  assert [g['params'] for g in sd['param_groups']] == [
      g['params'] for g in got_sd['param_groups']]
