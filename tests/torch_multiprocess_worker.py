"""One rank of a CPU pod over gloo for tests/test_torch_multiprocess.py.

    python tests/torch_multiprocess_worker.py --rank R --world N \
        --ports P1,...,P6 --workdir DIR --mode {pod,hsdp}

`pod` (world 2): rank 0 first runs the one-process references with no
process group (the port's one-process `Experiment`, the VLB evaluators and
the ODE solvers, fed the global batch: the ranks' batches concatenated in
rank order). Then every rank joins the group on P1 and runs, on its rows,
  a: 3 train steps under DDP; a super-step of 2 (`Experiment.train`, the
     rank's own iterator) under DDP and with training.fsdp = 2;
  b: 4 train steps with training.fsdp = 2, an FSDP step under remat, the
     layout checks and the bf16 casts of an FSDP evaluation;
  d: 2 steps, a checkpoint, a fresh restore and 2 more (bit for bit
     against b's 4), and the checkpoint restored into one process;
  e: the sparse and dense VLB, an RK4 likelihood and a DoPri5 solve;
  g: two steps of each chip-smoke variant V1-V4 under DDP;
  f: `main --mode train --multiprocess` on P2, `eval_bpd --multiprocess`
     on P3, `main --mode eval` under training.fsdp = 2 on P4 and `main
     --mode sample` (ancestral, ODE) on P5 and P6, through torchrun's
     environment.
`hsdp` (world 4): one step on a 2 x 2 ('data', 'fsdp') mesh against one
process.
`tp` (world 2, training.tp = 2, one batch coordinate): rank 0 first runs
the one-process references; then on a ('data', 'tensor') mesh
  t: 3 train steps (the split and whole leaves checked), a super-step of
     2 (`Experiment.train`), 2 steps, a checkpoint, a fresh restore and a
     third (bit for bit), the checkpoint restored into one process;
  u: the sparse and dense VLB, the ancestral sampler, an RK4 likelihood
     and a DoPri5 solve;
  v: two steps of a VDM, an imagenet32-cut (MuLAN-epsilon, 32 channels)
     and an 'ldm' MuLAN;
  j: with <workdir>/jax_case.pt (written by the test), one step from its
     parameters, batch and noise, its state and gradients saved for the
     test to hold against JAX's step;
  c: `main --mode train --multiprocess --config.training.tp=2` on P2, its
     checkpoint exported as a `ckpt-N.flax` and `eval_bpd --multiprocess
     --config.training.tp=2` reading the export on P3.
`tp_hsdp` (world 4, training.fsdp = 2 x training.tp = 2, two batch
coordinates): two steps, the checkpoint into one process, and u's
evaluators against one process on the global batch.

Rank 0 compares with its references and prints `CHECK <name> OK`; every
rank prints `AGREE <name> <value>` for values that must be equal across
ranks, and `WORKER_OK rank=<r>` at the end. Any failure raises.
"""

import argparse
import contextlib
import dataclasses
import datetime
import functools
import io
import json
import os
import sys

os.environ.setdefault('OMP_NUM_THREADS', '1')

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
torch.set_num_threads(1)

from mulan_tpu_torch import configs, data, params  # noqa: E402
from mulan_tpu_torch.evals import nll_ode, vlb  # noqa: E402
from mulan_tpu_torch.models import build_model, layers  # noqa: E402
from mulan_tpu_torch.ops import ode  # noqa: E402
from mulan_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from mulan_tpu_torch.parallel import tensor as tensor_lib  # noqa: E402
from mulan_tpu_torch.parallel import wrap  # noqa: E402
from mulan_tpu_torch.train import checkpoint as ckpt_lib  # noqa: E402
from mulan_tpu_torch.train.loop import Experiment  # noqa: E402
from mulan_tpu_torch.utils import metrics as metrics_lib  # noqa: E402

# TensorBoard's import loads TensorFlow (~17 s a rank): the pods write
# stdout scalars only.
metrics_lib.summary_writer = lambda logdir: None

TRAIN_STEPS = 4
# The chip smoke's phase-15 variants (`chip_smoke.VARIANTS`).
VARIANTS = {
    'v1': dict(unet_type='ldm', gamma_type='learnable_nnet',
               latent_type='gumbel', sample_softmax=True,
               antithetic_time_sampling=False),
    'v2': dict(latent_type='gaussian', gamma_type='linear',
               z_conditioning=False),
    'v3': dict(encoder='cnn', topk_noise_type='gumbel'),
    'v4': dict(reparam_type='none'),
}
# JAX's `test_fsdp.py:30-49` tolerances.
BPD_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6


def log(*words):
  print(*words, flush=True)


def train_config(fsdp=1, **model):
  """tiny_synthetic (dropout 0.1) with a one-step warm-up, lr 2e-5 and
  clipping, so every step after the first moves the state. Adam moves a
  weight by about lr whatever its gradient's size, so where a gradient is
  near 0 its float32 reduction order (one process against the ranks' sum)
  can flip the update: three steps left one weight 2.2e-5 from one process
  at lr 2e-3 and 1.9e-6 at 2e-4, past JAX's atol 1e-6. A rank that updates
  from its own gradient or a wrong dropout mask moves whole tensors by ~lr
  (the 4e-5 of two updates here) and the bpd far past its rtol 1e-5."""
  cfg = configs.tiny_synthetic()
  return configs.replace(
      cfg, model=model, training={'num_steps_lr_warmup': 1, 'fsdp': fsdp},
      optimizer=dataclasses.replace(cfg.optimizer, learning_rate=2e-5,
                                    gradient_clip_norm=1.0))


def rank_batches(cfg, rank, world, steps):
  """Rank `rank`'s first `steps` train batches, as its Experiment's train
  iterator yields them (its shard, seed + rank; unaugmented, so the same
  batches whatever the super-step's size)."""
  images, labels = data.source(cfg.data.dataset, 'train',
                               cfg.model.image_shape,
                               seed=cfg.data.synthetic_seed,
                               examples=cfg.data.synthetic_examples)
  it = data.train_iterator(
      *data.host_shard(images, labels, rank, world),
      batch_size=cfg.training.batch_size_train // world, substeps=1,
      seed=cfg.training.seed + rank)
  return [{k: v[0] for k, v in next(it).items()} for _ in range(steps)]


def concat(batches):
  return {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}


def global_batches(cfg, world, steps):
  per_rank = [rank_batches(cfg, r, world, steps) for r in range(world)]
  return [concat([per_rank[r][s] for r in range(world)])
          for s in range(steps)]


def eval_batches(cfg, rank, world, n=1):
  """Rank `rank`'s first n one-time eval batches (global batch
  `batch_size_eval`)."""
  images, labels = data.source(cfg.data.dataset, 'eval',
                               cfg.model.image_shape,
                               seed=cfg.data.synthetic_seed,
                               examples=cfg.data.synthetic_examples)
  it = data.one_time_eval_iterator(
      *data.host_shard(images, labels, rank, world),
      batch_size=cfg.training.batch_size_eval // world)
  return [next(it) for _ in range(n)]


def full_state(ex):
  """{name: whole tensor} of the params and the EMA (a collective)."""
  sd = ex.state.state_dict()
  return {**{f'params/{k}': v for k, v in sd['params'].items()},
          **{f'ema/{k}': v for k, v in sd['ema_params'].items()}}


def assert_close_state(got, want, what):
  assert got.keys() == want.keys(), what
  for k, w in want.items():
    torch.testing.assert_close(got[k], w, rtol=PARAM_RTOL, atol=PARAM_ATOL,
                               msg=lambda m: f'{what} {k}: {m}')


def assert_bpds(got, want, what):
  np.testing.assert_allclose(got, want, rtol=BPD_RTOL, err_msg=what)


def agree(name, value):
  """Prints a value every rank must print alike."""
  log('AGREE', name, json.dumps(value))


def ode_config():
  """The likelihood's config: the UNet's Fourier features off (with them a
  2-step RK4 amplifies float32 rounding, tests/test_torch_nll_ode.py)."""
  return configs.replace(train_config(), model={
      'with_fourier_features': False})


def closed_form_rhs(world_rows):
  rates = torch.linspace(0.5, 3.0, world_rows)[:, None]

  def rhs_for(rows):
    k = rates if rows is None else rows.take(rates)
    return lambda t, y: -k * y * (1.0 + t)
  return rhs_for


def eval_models(cfg):
  state = params.init_params(cfg.model, torch.Generator().manual_seed(0),
                             perturb_zero_init=0.02)
  return build_model(cfg.vdm_type, cfg.model, device='cpu', state=state)


# -- the one-process references (rank 0, no process group) ---------------------


def references(world):
  cfg = train_config()
  batches = global_batches(cfg, world, TRAIN_STEPS)
  ex = Experiment(cfg, device='cpu')
  global_eval = concat([eval_batches(cfg, r, world)[0]
                        for r in range(world)])
  ref = {'bpd': [], 'state': {}, 'eval': []}
  for s, batch in enumerate(batches):
    ref['bpd'].append(float(ex.train_step(batch)['bpd']))
    ref['state'][s + 1] = {k: v.clone() for k, v in full_state(ex).items()}
    if s + 1 >= 3:
      ref['eval'].append(float(ex.eval_step(global_eval, 0)['bpd']))

  model = eval_models(cfg)
  global_evals = [concat([eval_batches(cfg, r, world, 2)[i]
                          for r in range(world)]) for i in range(2)]
  ref['sparse'] = vlb.eval_bpd_sparse(model, global_evals,
                                      generator=torch.Generator().manual_seed(0))
  ref['dense'] = vlb.eval_bpd_dense(model, global_evals, n_timesteps=4,
                                    generator=torch.Generator().manual_seed(0))
  ocfg = ode_config()
  omodel = eval_models(ocfg)
  real = nll_ode.data_lib.create_one_time_eval_dataset
  nll_ode.data_lib.create_one_time_eval_dataset = lambda *a, **k: iter(
      global_evals[:1])
  try:
    ref['ode'] = nll_ode.eval_bpd_ode(
        None, ocfg, model=omodel, solver='rk4', rk4_steps=2, num_is=1,
        max_batches=1)
  finally:
    nll_ode.data_lib.create_one_time_eval_dataset = real
  rows = 4 * world
  y0 = torch.linspace(-1.0, 2.0, rows * 5).reshape(rows, 5)
  sol = ode.odeint_dopri5(closed_form_rhs(rows)(None), y0, 0.0, 1.0,
                          rtol=1e-2, atol=1e-2)
  ref['dopri5'] = (sol.y, sol.num_steps, sol.num_rejected, sol.nfe)
  return ref


# -- tensor parallelism: modes tp and tp_hsdp ------------------------------------

TP = 2
TP_STEPS = 3
# Two steps of each (the first update has lr 0), against one process.
TP_VARIANTS = {
    'vdm': dict(vdm_type='vdm', model={'gamma_type': 'learnable_nnet',
                                       'z_conditioning': False}),
    'in32_cut': dict(vdm_type='mulan_epsilon', model={'sm_n_embd': 32}),
    'ldm': dict(model=VARIANTS['v1']),
}


def tp_config(fsdp=1):
  return configs.replace(train_config(fsdp=fsdp), training={'tp': TP})


def variant_config(cfg, name):
  spec = dict(TP_VARIANTS[name])
  return configs.replace(cfg, model=spec.pop('model', {}), **spec)


def batch_world(world):
  return world // TP


def tp_references(world, hsdp: bool):
  """Rank 0's one-process runs on the global batches of `world` // TP
  batch coordinates (for `tp_hsdp`, two steps and no variants)."""
  bw = batch_world(world)
  cfg = train_config()
  batches = global_batches(cfg, bw, 2 if hsdp else TP_STEPS)
  ex = Experiment(cfg, device='cpu')
  ref = {'bpd': [], 'state': {}}
  for s, batch in enumerate(batches):
    ref['bpd'].append(float(ex.train_step(batch)['bpd']))
    ref['state'][s + 1] = {k: v.clone() for k, v in full_state(ex).items()}
  model = eval_models(cfg)
  evals = [concat([eval_batches(cfg, r, bw, 2)[i] for r in range(bw)])
           for i in range(2)]
  ref['sparse'] = vlb.eval_bpd_sparse(
      model, evals, generator=torch.Generator().manual_seed(0))
  ref['dense'] = vlb.eval_bpd_dense(
      model, evals, n_timesteps=4, generator=torch.Generator().manual_seed(0))
  from mulan_tpu_torch.evals import harness
  ref['samples'] = harness.random_samples(
      model, 4 * bw, T=2, generator=torch.Generator().manual_seed(0))
  ocfg = ode_config()
  omodel = eval_models(ocfg)
  images = torch.as_tensor(evals[0]['images'])
  for solver in ('rk4', 'dopri5'):
    ref[solver] = tp_likelihood(omodel, solver)(images, 7)
  for name in () if hsdp else TP_VARIANTS:
    vcfg = variant_config(cfg, name)
    vex = Experiment(vcfg, device='cpu')
    ref[name] = ([float(vex.train_step(b)['bpd'])
                  for b in global_batches(vcfg, bw, 2)], full_state(vex))
  return ref


def tp_likelihood(model, solver, mesh=None):
  odeint = (functools.partial(ode.odeint_rk4, num_steps=2) if solver == 'rk4'
            else ode.odeint_dopri5)
  return nll_ode.make_ode_likelihood_fn(model, rtol=1e-2, atol=1e-2,
                                        odeint=odeint, mesh=mesh)


def check_tp_layout(ex, rank):
  """A rank holds 1/TP of every split score-UNet leaf; the encoder, the
  schedule network and conv_out are whole, and their gradients alike on
  both ranks of the tensor group."""
  split = whole = 0
  full_shapes = {k: v.shape for k, v in params.init_params(
      ex.config.model, torch.Generator().manual_seed(0)).items()}
  for name, p in ex.state.params.items():
    local = wrap.local(p)
    if tensor_lib.split_segments(name) is None:
      assert tuple(local.shape) == tuple(full_shapes[name]), name
      assert name.startswith(('encoder_model.', 'gamma.',
                              'score_model.conv_out.')), name
      both = tensor_lib._gather_parts(p.grad, ex.state.optimizer.tensor)
      assert torch.equal(both[0], both[1]), name
      whole += 1
    else:
      assert local.shape[0] * TP == full_shapes[name][0], name
      assert tuple(local.shape[1:]) == tuple(full_shapes[name][1:]), name
      split += 1
  assert split > 0 and whole > 0
  agree('tp_layout', [split, whole])
  if rank == 0:
    log('CHECK tp_layout OK', json.dumps([split, whole]))


def check_tp_train(ref, rank, world, workdir):
  cfg = tp_config()
  bw = batch_world(world)
  batches = rank_batches(cfg, rank // TP, bw, TP_STEPS)
  states = {}

  def after(ex, step):
    states[step] = {k: v.clone() for k, v in full_state(ex).items()}
    if step == 1:
      check_tp_layout(ex, rank)
  ex, bpds = run_train(cfg, batches, TP_STEPS, rank, after)
  assert ex.mesh.mesh_dim_names == ('data', 'tensor'), ex.mesh
  assert (mesh_lib.batch_rank(ex.mesh),
          mesh_lib.batch_world(ex.mesh)) == (rank // TP, bw)
  agree('tp_bpd', bpds)
  check_superstep(ref, rank, ('tp', cfg))
  if rank == 0:
    assert_bpds(bpds[:1], ref['bpd'][:1], 'tp first step bpd')
    assert_close_state(states[1], ref['state'][1], 'tp first step state')
    log('CHECK tp_super_step_matches_one_process OK')
    assert_bpds(bpds, ref['bpd'], 'tp bpd')
    for step in (2, 3):
      assert_close_state(states[step], ref['state'][step],
                         f'tp state {step}')
    log('CHECK tp_matches_one_process OK')
  # Two steps, a checkpoint, a fresh restore and the third.
  ckpt = ckpt_lib.CheckpointManager(os.path.join(workdir, 'tp_ckpts'))
  first, _ = run_train(cfg, batches, 2, rank)
  ckpt.save(first.state.step, first.state)
  del first
  second = Experiment(cfg, device='cpu')
  ckpt.restore(second.state)
  second.train_step(batches[2])
  resumed = full_state(second)
  if rank == 0:
    for k, v in states[TP_STEPS].items():
      assert torch.equal(resumed[k], v), k
    log('CHECK tp_resume_bit_for_bit OK')
  return ckpt.path(2), second.mesh


def check_tp_evals(ref, rank, world, mesh):
  """The evaluators on a rank's rows (of `mesh`'s batch coordinates) and
  tensor slices, against one process on the global batch."""
  tensor = tensor_lib.tensor_group(mesh)
  from mulan_tpu_torch.evals import harness
  bw = batch_world(world)
  cfg = train_config()
  state = params.init_params(cfg.model, torch.Generator().manual_seed(0),
                             perturb_zero_init=0.02)
  model = build_model(cfg.vdm_type, cfg.model, device='cpu', state=state,
                      tensor=tensor)
  evals = eval_batches(cfg, rank // TP, bw, 2)
  sparse = vlb.eval_bpd_sparse(model, evals,
                               generator=torch.Generator().manual_seed(0),
                               mesh=mesh)
  dense = vlb.eval_bpd_dense(model, evals, n_timesteps=4,
                             generator=torch.Generator().manual_seed(0),
                             mesh=mesh)
  rows = mesh_lib.row_window(4, mesh)
  images, z0 = harness.random_samples(
      model, 4, T=2, generator=torch.Generator().manual_seed(0), rows=rows)
  z0 = mesh_lib.all_gather_rows(z0, mesh=mesh)
  ocfg = ode_config()
  ostate = params.init_params(ocfg.model, torch.Generator().manual_seed(0),
                              perturb_zero_init=0.02)
  omodel = build_model(ocfg.vdm_type, ocfg.model, device='cpu',
                       state=ostate, tensor=tensor)
  b = len(evals[0]['images'])
  solved = {}
  for solver in ('rk4', 'dopri5'):
    log_p, _, _, stats = tp_likelihood(omodel, solver, mesh)(
        torch.as_tensor(evals[0]['images']), 7,
        rows=mesh_lib.row_window(b, mesh))
    solved[solver] = (mesh_lib.all_gather_rows(log_p, mesh=mesh),
                      stats['nfe'])
  agree('tp_evals', [sparse, dense, solved['rk4'][1], solved['dopri5'][1]])
  if rank == 0:
    np.testing.assert_allclose(sparse, ref['sparse'], rtol=1e-5)
    np.testing.assert_allclose(dense, ref['dense'], rtol=1e-5)
    torch.testing.assert_close(z0, ref['samples'][1], rtol=1e-5, atol=1e-5)
    for solver in ('rk4', 'dopri5'):
      want_p, _, _, want_stats = ref[solver]
      assert solved[solver][1] == want_stats['nfe'], (solver, solved)
      torch.testing.assert_close(solved[solver][0], want_p, rtol=1e-4,
                                 atol=1e-3)
    log('CHECK tp_evals_match_one_process OK',
        json.dumps({s: v[1] for s, v in solved.items()}))


def check_tp_variants(ref, rank, world):
  bw = batch_world(world)
  for name in TP_VARIANTS:
    cfg = variant_config(tp_config(), name)
    ex, bpds = run_train(cfg, rank_batches(cfg, rank // TP, bw, 2), 2, rank)
    state = full_state(ex)
    agree(f'tp_variant_{name}', bpds)
    if rank == 0:
      assert_bpds(bpds, ref[name][0], f'tp {name} bpd')
      assert_close_state(state, ref[name][1], f'tp {name} state')
  if rank == 0:
    log('CHECK tp_variants_match_one_process OK')


def check_tp_jax_case(rank, workdir):
  """One step from the test's parameters, batch and noise (JAX's
  `test_tp_training_matches_dp` setting: no dropout); rank 0 saves the
  whole parameters and gradients after it."""
  path = os.path.join(workdir, 'jax_case.pt')
  if not os.path.exists(path):
    return
  case = torch.load(path, weights_only=False)
  cfg = configs.replace(tp_config(), model=case['model'],
                        training=case['training'],
                        optimizer=case['optimizer'])
  ex = Experiment(cfg, device='cpu', state=case['state'])
  bpd = float(ex.train_step(case['batch'], noise=case['noise'])['bpd'])
  tensor = ex.state.optimizer.tensor
  grads = {k: tensor_lib.gather_tensor(k, p.grad, tensor)
           for k, p in ex.state.params.items()}
  state = ex.state.state_dict()
  if rank == 0:
    torch.save({'bpd': bpd, 'params': state['params'], 'grads': grads},
               os.path.join(workdir, 'jax_case_out.pt'))
    log('CHECK tp_jax_case_written OK')


def check_tp_clis(ports, rank, world, workdir):
  from mulan_tpu_torch import compat, eval_bpd, main
  os.environ['COMPOSER_RUN_NAME'] = 'tp'
  real_draw = Experiment.draw_samples
  Experiment.draw_samples = functools.partialmethod(real_draw, T=2)
  try:
    _, out = run_cli(ports[1], rank, world, [
        '--mode=train', '--multiprocess', '--device=cpu',
        '--config=tiny_synthetic', f'--workdir={workdir}/tp_cli',
        '--config.training.num_steps_train=2', f'--config.training.tp={TP}'],
                     main)
  finally:
    Experiment.draw_samples = real_draw
  ckpts = os.path.join(workdir, 'tp_cli', 'tiny_synthetic',
                       'tp-num_steps_train=2-tp=2', 'checkpoints')
  flax_dir = os.path.join(workdir, 'tp_flax')
  if rank == 0:
    compat.export_reference_checkpoint(ckpts, flax_dir)
  bpd, out_eval = run_cli(ports[2], rank, world, [
      '--config=tiny_synthetic', '--multiprocess', '--device=cpu',
      f'--checkpoint_directory={flax_dir}', '--bpd_eval_method=sparse',
      f'--config.training.tp={TP}'], eval_bpd)
  agree('tp_cli_eval_bpd', bpd)
  if rank == 0:
    assert sorted(os.listdir(ckpts)) == ['ckpt_2.pt'], os.listdir(ckpts)
    assert 'train_bpd' in out and out_eval.startswith('Test BPD:'), (
        out, out_eval)
  return ckpts, bpd


def check_tp_restore_one_process(ref, path, ckpts, cli_bpd, world):
  """Rank 0, after the group is gone: the tp checkpoint of step 2
  restores into one process, whose step 3 is the reference's; the CLI's
  checkpoint evaluates as `eval_bpd --config.training.tp=2` read it."""
  from mulan_tpu_torch import eval_bpd
  cfg = train_config()
  ex = Experiment(cfg, device='cpu')
  ex.state.load_state_dict(ckpt_lib.load(path))
  step = ex.state.step
  batches = global_batches(cfg, batch_world(world), step + 1)
  if step < len(ref['bpd']):  # the step after the checkpoint
    bpd = float(ex.train_step(batches[step])['bpd'])
    assert_bpds([bpd], ref['bpd'][step:step + 1],
                'one-process step after tp restore')
    step += 1
  assert_close_state(full_state(ex), ref['state'][step], 'tp restored state')
  log('CHECK tp_checkpoint_restores_in_one_process OK')
  if ckpts is not None:
    with contextlib.redirect_stdout(io.StringIO()):
      one = eval_bpd.main(['--config=tiny_synthetic', '--device=cpu',
                           f'--checkpoint_directory={ckpts}',
                           '--bpd_eval_method=sparse'])
    np.testing.assert_allclose(cli_bpd, one, rtol=1e-5)
    log('CHECK tp_cli_flax_round_trip OK')


def run_tp(rank, world, workdir, hsdp: bool):
  ref = tp_references(world, hsdp) if rank == 0 else None
  init(rank, world)
  if hsdp:
    cfg = tp_config(fsdp=2)
    bw = batch_world(world)
    ex, bpds = run_train(cfg, rank_batches(cfg, rank // TP, bw, 2), 2, rank)
    assert ex.mesh.mesh_dim_names == ('data', 'fsdp', 'tensor'), ex.mesh
    state = full_state(ex)
    ckpt = ckpt_lib.CheckpointManager(os.path.join(workdir, 'hsdp_ckpts'))
    ckpt.save(2, ex.state)
    check_tp_evals(ref, rank, world, ex.mesh)
    agree('tp_hsdp_bpd', bpds)
    if rank == 0:
      assert_bpds(bpds, ref['bpd'][:2], 'tp hsdp bpd')
      assert_close_state(state, ref['state'][2], 'tp hsdp state')
      log('CHECK tp_hsdp_matches_one_process OK')
    dist.destroy_process_group()
    if rank == 0:
      check_tp_restore_one_process(ref, ckpt.path(2), None, None, world)
    return
  path, mesh = check_tp_train(ref, rank, world, workdir)
  check_tp_evals(ref, rank, world, mesh)
  check_tp_variants(ref, rank, world)
  check_tp_jax_case(rank, workdir)
  dist.destroy_process_group()
  ckpts, bpd = check_tp_clis(PORTS, rank, world, workdir)
  if rank == 0:
    check_tp_restore_one_process(ref, path, ckpts, bpd, world)


# -- the distributed checks ---------------------------------------------------------


def run_train(cfg, batches, steps, rank, after=None):
  ex = Experiment(cfg, device='cpu')
  bpds = []
  for s in range(steps):
    bpds.append(float(ex.train_step(batches[s])['bpd']))
    if after is not None:
      after(ex, s + 1)
  return ex, bpds


def check_dp(ref, rank, world):
  cfg = train_config()
  batches = rank_batches(cfg, rank, world, 3)
  ex, bpds = run_train(cfg, batches, 3, rank)
  assert isinstance(ex.train_model,
                    torch.nn.parallel.DistributedDataParallel)
  state = full_state(ex)
  agree('dp_bpd', bpds)
  if rank == 0:
    assert_bpds(bpds, ref['bpd'][:3], 'dp bpd')
    assert_close_state(state, ref['state'][3], 'dp state')
    log('CHECK dp_matches_one_process OK')
  check_superstep(ref, rank, ('dp', cfg), ('fsdp', train_config(fsdp=2)))


def check_superstep(ref, rank, *named_configs):
  """One super-step of the configs' 2 substeps through `Experiment.train`
  on the rank's own iterator: the global scalars of both substeps and the
  state after them against one process's first two steps."""
  for name, cfg in named_configs:
    assert cfg.training.substeps == 2, cfg.training
    ex = Experiment(cfg, device='cpu')
    bpds = [h['bpd'] for h in ex.train(2)]
    assert ex.state.step == 2
    state = full_state(ex)
    agree(f'{name}_superstep_bpd', bpds)
    if rank == 0:
      assert_bpds(bpds, ref['bpd'][:2], f'{name} super-step bpd')
      assert_close_state(state, ref['state'][2], f'{name} super-step state')
  if rank == 0:
    log('CHECK superstep_matches_one_process OK',
        json.dumps([name for name, _ in named_configs]))


def check_fsdp(ref, rank, world):
  from torch.distributed.tensor import DTensor
  cfg = train_config(fsdp=2)
  batches = rank_batches(cfg, rank, world, TRAIN_STEPS)
  evals, states = [], {}
  eval_batch = eval_batches(cfg, rank, world)[0]

  def after(ex, step):
    if step == 3:
      # The layout after three steps: sharded params and EMA alike, the
      # schedule network whole, its gradient the same on every rank.
      sharded = 0
      for name, p in ex.state.params.items():
        ema = ex.state.ema_params[name]
        assert isinstance(ema, DTensor) == isinstance(p, DTensor), name
        if name.startswith('gamma.'):
          assert not isinstance(p, DTensor), name
          grads = mesh_lib.all_gather_rows(p.grad[None])
          assert torch.equal(grads[0], grads[1]), name
          continue
        assert isinstance(p, DTensor), name
        assert ema.placements == p.placements, name
        if p.shape[0] >= world:
          assert p.to_local().numel() < p.numel(), name
          sharded += 1
      assert sharded > 0
    if step >= 3:
      states[step] = {k: v.clone() for k, v in full_state(ex).items()}
      evals.append(float(ex.eval_step(eval_batch, 0)['bpd']))

  ex, bpds = run_train(cfg, batches, TRAIN_STEPS, rank, after)
  agree('fsdp_bpd', bpds)
  agree('fsdp_eval', evals)
  if rank == 0:
    assert_bpds(bpds, ref['bpd'], 'fsdp bpd')
    for step in (3, 4):
      assert_close_state(states[step], ref['state'][step],
                         f'fsdp state {step}')
    assert_bpds(evals, ref['eval'], 'fsdp eval (the EMA after each step)')
    log('CHECK fsdp_matches_one_process OK')
  straight = states[TRAIN_STEPS]

  # One remat mode under FSDP: two steps, as the straight run's first two.
  rcfg = train_config(fsdp=2, remat='all')
  rex, rbpds = run_train(rcfg, batches, 2, rank)
  rstate = full_state(rex)
  if rank == 0:
    assert_bpds(rbpds, ref['bpd'][:2], 'fsdp remat bpd')
    assert_close_state(rstate, ref['state'][2], 'fsdp remat state')
    log('CHECK fsdp_remat_matches_one_process OK')
  return straight, batches


def check_fsdp_casts(rank):
  """The bf16 casts of a no-grad ELBO: the FSDP-sharded EMA model casts
  every weight on every call (no cache: `parallel/wrap.py`), also after
  the weights move; the unwrapped model's second call casts nothing until
  they move."""
  cfg = configs.replace(train_config(fsdp=2),
                        model={'compute_dtype': 'bfloat16'})
  images = eval_batches(cfg, rank, 2)[0]['images']
  models = {'fsdp': Experiment(cfg, device='cpu').state.ema_model,
            'plain': eval_models(cfg)}
  counts = {}
  for name, model in models.items():
    got = []
    for moved in (False, False, True):
      with torch.no_grad():
        if moved:
          for p in model.parameters():
            wrap.local(p).mul_(1.0 + 1e-3)
        before = layers.cast_param.casts
        model(images, generator=torch.Generator().manual_seed(0))
      got.append(layers.cast_param.casts - before)
    counts[name] = got
  assert counts['fsdp'][0] > 0 and counts['fsdp'] == [counts['fsdp'][0]] * 3, (
      counts)
  assert counts['plain'][1] == 0 and counts['plain'][2] > 0, counts
  agree('fsdp_casts', counts)
  if rank == 0:
    log('CHECK fsdp_eval_recasts OK', json.dumps(counts))


def check_resume(ref, straight, batches, rank, workdir):
  cfg = train_config(fsdp=2)
  ckpt = ckpt_lib.CheckpointManager(os.path.join(workdir, 'ckpts'))
  first, bpds = run_train(cfg, batches, 2, rank)
  ckpt.save(first.state.step, first.state)
  del first
  second = Experiment(cfg, device='cpu')
  ckpt.restore(second.state)
  for batch in batches[2:]:
    bpds.append(float(second.train_step(batch)['bpd']))
  resumed = full_state(second)
  if rank == 0:
    for k, v in straight.items():
      assert torch.equal(resumed[k], v), k
    log('CHECK fsdp_resume_bit_for_bit OK')
  agree('resume_bpd', bpds)
  return ckpt.path(2)


def check_evals(ref, rank, world):
  cfg = train_config()
  model = eval_models(cfg)
  evals = eval_batches(cfg, rank, world, 2)
  sparse = vlb.eval_bpd_sparse(model, evals,
                               generator=torch.Generator().manual_seed(0))
  dense = vlb.eval_bpd_dense(model, evals, n_timesteps=4,
                             generator=torch.Generator().manual_seed(0))
  ocfg = ode_config()
  omodel = eval_models(ocfg)
  real = nll_ode.data_lib.create_one_time_eval_dataset
  nll_ode.data_lib.create_one_time_eval_dataset = lambda *a, **k: iter(
      evals[:1])
  try:
    ode_bpd = nll_ode.eval_bpd_ode(
        None, ocfg, model=omodel, solver='rk4', rk4_steps=2, num_is=1,
        max_batches=1)
  finally:
    nll_ode.data_lib.create_one_time_eval_dataset = real
  rows_total = 4 * world
  rows = mesh_lib.row_window(4)
  y0 = torch.linspace(-1.0, 2.0, rows_total * 5).reshape(rows_total, 5)
  sol = ode.odeint_dopri5(closed_form_rhs(rows_total)(rows), rows.take(y0),
                          0.0, 1.0, rtol=1e-2, atol=1e-2, across_ranks=True)
  steps = [sol.num_steps, sol.num_rejected, sol.nfe]
  agree('eval_bpds', [sparse, dense, ode_bpd])
  agree('dopri5_steps', steps)
  y = mesh_lib.all_gather_rows(sol.y)
  if rank == 0:
    np.testing.assert_allclose(sparse, ref['sparse'], rtol=1e-5)
    np.testing.assert_allclose(dense, ref['dense'], rtol=1e-5)
    np.testing.assert_allclose(ode_bpd, ref['ode'], rtol=1e-4)
    want_y, *want_steps = ref['dopri5']
    assert steps == want_steps, (steps, want_steps)
    torch.testing.assert_close(y, want_y, rtol=1e-6, atol=1e-6)
    log('CHECK evals_match_one_process OK')
    log('CHECK dopri5_same_steps OK', json.dumps(steps))


def check_variants(rank, world):
  for name, overrides in VARIANTS.items():
    cfg = train_config(**overrides)
    batches = rank_batches(cfg, rank, world, 2)
    ex, bpds = run_train(cfg, batches, 2, rank)
    assert all(np.isfinite(bpds)), (name, bpds)
    agree(f'variant_{name}', bpds)
  if rank == 0:
    log('CHECK variants_ddp OK')


def run_cli(port, rank, world, argv, module):
  os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                    LOCAL_RANK=str(rank), MASTER_ADDR='127.0.0.1',
                    MASTER_PORT=str(port))
  out = io.StringIO()
  try:
    with contextlib.redirect_stdout(out):
      result = module.main(argv)
  finally:
    if dist.is_initialized():
      dist.destroy_process_group()
  return result, out.getvalue()


def check_clis(ports, rank, world, workdir):
  from mulan_tpu_torch import eval_bpd, main
  saved = []
  real_save = torch.save
  torch.save = lambda obj, f, *a, **k: (saved.append(str(f)),
                                        real_save(obj, f, *a, **k))[1]
  real_draw = Experiment.draw_samples
  Experiment.draw_samples = functools.partialmethod(real_draw, T=2)
  os.environ['COMPOSER_RUN_NAME'] = 'pod'
  try:
    _, out = run_cli(ports[1], rank, world, [
        '--mode=train', '--multiprocess', '--device=cpu',
        '--config=tiny_synthetic', f'--workdir={workdir}/cli',
        '--config.training.num_steps_train=2'], main)
    ckpts = os.path.join(workdir, 'cli', 'tiny_synthetic',
                         'pod-num_steps_train=2', 'checkpoints')
    bpd, out_eval = run_cli(ports[2], rank, world, [
        '--config=tiny_synthetic', '--multiprocess', '--device=cpu',
        f'--checkpoint_directory={ckpts}', '--bpd_eval_method=sparse'],
                            eval_bpd)
    # `--mode eval` restores the EMA into an FSDP2 experiment; `--mode
    # sample` gathers every rank's samples, ancestral and by the ODE.
    _, out_mode_eval = run_cli(ports[3], rank, world, [
        '--mode=eval', '--multiprocess', '--device=cpu',
        '--config=tiny_synthetic', '--config.training.fsdp=2',
        f'--workdir={workdir}/cli_eval', f'--checkpoint={ckpts}'], main)
    outs = [out, out_eval, out_mode_eval]
    for port, sampler in ((ports[4], 'ancestral'), (ports[5], 'ode')):
      outs.append(run_cli(port, rank, world, [
          '--mode=sample', '--multiprocess', '--device=cpu',
          '--config=tiny_synthetic', f'--workdir={workdir}/cli_sample',
          f'--checkpoint={ckpts}', f'--sampler={sampler}',
          '--sample_batch=4', '--sample_T=2'], main)[1])
  finally:
    torch.save = real_save
    Experiment.draw_samples = real_draw
  agree('cli_eval_bpd', bpd)
  if rank == 0:
    assert sorted(os.listdir(ckpts)) == ['ckpt_2.pt'], os.listdir(ckpts)
    assert any(p.endswith('.tmp') for p in saved), saved
    assert 'train_bpd' in out and 'Training at workdir' in out, out
    assert out_eval.startswith('Test BPD:'), out_eval
    assert 'eval_bpd' in out_mode_eval, out_mode_eval
    assert os.listdir(os.path.join(workdir, 'cli_eval', 'eval')) == [
        'samples_2.png']
    assert sorted(os.listdir(os.path.join(workdir, 'cli_sample'))) == [
        'samples_ckpt2_ancestral.png', 'samples_ckpt2_ode.png']
    assert 'Wrote 4 samples' in outs[3] and 'nfe' in outs[4], outs
    log('CHECK cli_rank0_writes OK')
  else:
    assert not saved, saved
    assert outs == [''] * 5, outs


def check_restore_one_process(ref, path, world):
  """Rank 0, after the group is gone: the fsdp = 2 checkpoint of step 2
  restores into one process, whose step 3 is the reference's."""
  cfg = train_config()
  ex = Experiment(cfg, device='cpu')
  ex.state.load_state_dict(ckpt_lib.load(path))
  bpd = float(ex.train_step(global_batches(cfg, world, 3)[2])['bpd'])
  assert_bpds([bpd], ref['bpd'][2:3], 'one-process step after restore')
  assert_close_state(full_state(ex), ref['state'][3], 'restored state')
  log('CHECK fsdp_checkpoint_restores_in_one_process OK')


def check_hsdp(rank, world):
  cfg = train_config(fsdp=2)
  ref = None
  if rank == 0:
    one = Experiment(train_config(), device='cpu')
    batches = global_batches(cfg, world, 2)
    ref = ([float(one.train_step(b)['bpd']) for b in batches],
           full_state(one))
  init(rank, world)
  ex, bpds = run_train(cfg, rank_batches(cfg, rank, world, 2), 2, rank)
  assert ex.mesh.mesh_dim_names == ('data', 'fsdp'), ex.mesh
  assert tuple(ex.mesh.shape) == (2, 2), ex.mesh
  state = full_state(ex)
  agree('hsdp_bpd', bpds)
  if rank == 0:
    assert_bpds(bpds, ref[0], 'hsdp bpd')
    assert_close_state(state, ref[1], 'hsdp state')
    log('CHECK hsdp_matches_one_process OK')


PORTS = []


def init(rank, world):
  dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{PORTS[0]}',
                          rank=rank, world_size=world,
                          timeout=datetime.timedelta(seconds=150))


def main():
  p = argparse.ArgumentParser()
  p.add_argument('--rank', type=int, required=True)
  p.add_argument('--world', type=int, required=True)
  p.add_argument('--ports', required=True)
  p.add_argument('--workdir', required=True)
  p.add_argument('--mode', choices=('pod', 'hsdp', 'tp', 'tp_hsdp'),
                 required=True)
  args = p.parse_args()
  PORTS.extend(int(x) for x in args.ports.split(','))
  rank, world = args.rank, args.world
  if args.mode == 'hsdp':
    check_hsdp(rank, world)
  elif args.mode in ('tp', 'tp_hsdp'):
    run_tp(rank, world, args.workdir, args.mode == 'tp_hsdp')
  else:
    ref = references(world) if rank == 0 else None
    init(rank, world)
    check_dp(ref, rank, world)
    straight, batches = check_fsdp(ref, rank, world)
    check_fsdp_casts(rank)
    path = check_resume(ref, straight, batches, rank, args.workdir)
    check_evals(ref, rank, world)
    check_variants(rank, world)
    dist.destroy_process_group()
    if rank == 0:
      check_restore_one_process(ref, path, world)
    check_clis(PORTS, rank, world, args.workdir)
  if dist.is_initialized():
    dist.destroy_process_group()
  log(f'WORKER_OK rank={rank}')


if __name__ == '__main__':
  main()
