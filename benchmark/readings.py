"""The readings that the limits of a cell's correctness check are set
from, in one process on the card:

  python3 benchmark/readings.py --workload <cell> --seeds 1,2,... \
      [--control-seeds 1,2,3] [--controls fp8,half_batch,...] [--dump]

For each seed of `--seeds` the program's set-up and checked path runs as
a run of the cell runs it (a training cell's first super-steps; a dense
cell's one call at the timed size), and the reference computes the same in
float32: each number the check compares is printed. For each seed of
`--control-seeds` the reference stands in the program's place, computed in
a lower precision ('fp8', 'bfloat16') or with a planted fault
('half_batch': the mean over half of the batch; 'answer': one image's
bpd set to zero where it is produced), and its numbers against the
float32 reference are printed. `--dump` adds, for a training cell, each
compared leaf's moment norm on both sides and the rows whose hard top-k
latent selection differs from the float32 reference's, with the
program's margin between its k-th and (k+1)-th noisy logit. The
benchmark's own runs do not run this. Lines go to standard output as
JSON, one a reading.
"""

import argparse
import gc
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _seeds(text):
  return [int(s) for s in text.split(',') if s]


def main(argv):
  p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  p.add_argument('--workload', required=True)
  p.add_argument('--seeds', type=_seeds, default=[])
  p.add_argument('--control-seeds', type=_seeds, default=[])
  p.add_argument('--controls', default='fp8,half_batch')
  p.add_argument('--root', default=ROOT,
                 help='where BENCHMARK.json and benchmark/ are read from')
  p.add_argument('--device', default='cuda',
                 help="'cpu' rehearses the script on the CPU")
  p.add_argument('--dump', action='store_true',
                 help="a training cell's lines also carry each compared "
                 "leaf's moment norms and where the two sides' top-k latent "
                 "selections differ")
  args = p.parse_args(argv)
  import torch
  from benchmark.harness import device as device_lib
  from benchmark.harness import spec
  from benchmark.harness.runner import Context
  from benchmark.reference import mulan as ref
  cell = spec.load_cell(args.root, args.workload)
  dev = torch.device(args.device)
  why = dev.type == 'cuda' and device_lib.missing_chips(cell.chips)
  if why:
    print(f'no run: {why}', file=sys.stderr)
    return 3
  entry = cell.entry_module()
  controls = [c for c in args.controls.split(',') if c]

  def emit(**kw):
    if dev.type == 'cuda':
      kw.update(device=torch.cuda.get_device_name(dev),
                power_limit_w=device_lib.power_limit_w())
    kw.update(cell=cell.name)
    print(json.dumps(kw), flush=True)

  def context(seed):
    return Context(cell, seed, 0.0, False, dev, time.perf_counter(),
                   tempfile.mkdtemp(prefix='mulan-readings-'))

  def numerics(name):
    return ref.Numerics(name) if name in ('fp8', 'bfloat16') else ref.FLOAT32

  def fault(name):
    return '' if name in ('fp8', 'bfloat16') else name

  selections = _Selections() if args.dump else None

  def dumped(model, got, want, side, reference_side):
    if not args.dump:
      return {}
    big = entry.moment_leaves(model)
    return {'moment_norms': {k: [got.moment[k], want.moment[k]]
                             for k in sorted(big)},
            'topk': selections.compare(side, reference_side)}

  try:
    _read(args, cell, dev, entry, controls, emit, context, numerics, fault,
          selections, dumped)
  finally:
    if selections:
      selections.close()
  return 0


def _read(args, cell, dev, entry, controls, emit, context, numerics, fault,
          selections, dumped):
  from benchmark.harness import device as device_lib
  for seed in sorted(set(args.seeds) | set(args.control_seeds)):
    ctx = context(seed)
    try:
      t = time.perf_counter()
      if cell.traffic['entry'] == 'train':
        if selections:
          selections.start('program')
        prep = entry.prepare(ctx)
        program = prep.program
        prep.experiment = None
        gc.collect()
        device_lib.free_memory(dev)
        t_prog = time.perf_counter() - t
        t = time.perf_counter()
        if selections:
          selections.start('float32')
        want = entry.reference(ctx, prep)
        t_ref = time.perf_counter() - t
        if seed in args.seeds:
          emit(seed=seed, side='program',
               numbers=entry.numbers(prep.model, program, want,
                                     cell.workload.get('loss_steps')),
               losses=program.losses, reference_losses=want.losses,
               program_s=t_prog, reference_s=t_ref,
               leaves=entry.leaf_detail(prep.model, program, want),
               **dumped(prep.model, program, want, 'program', 'float32'))
        if seed in args.control_seeds:
          for name in controls:
            t = time.perf_counter()
            if selections:
              selections.start(name)
            got = entry.reference(ctx, prep, numerics(name), fault(name))
            emit(seed=seed, side=name,
                 numbers=entry.numbers(prep.model, got, want,
                                       cell.workload.get('loss_steps')),
                 losses=got.losses, seconds=time.perf_counter() - t,
                 leaves=entry.leaf_detail(prep.model, got, want),
                 **dumped(prep.model, got, want, name, 'float32'))
      else:
        ev = entry.Evaluator(ctx)
        images = ev.next_images()
        key = entry.call_key(seed, 0)
        got = ev(images, key)
        device_lib.synchronize(dev)
        t_prog = time.perf_counter() - t
        ev.experiment = None
        gc.collect()
        device_lib.free_memory(dev)
        t = time.perf_counter()
        per_image = ev.reference(ctx, images, key)
        want = ev.mean(per_image)
        t_ref = time.perf_counter() - t
        if seed in args.seeds:
          emit(seed=seed, side='program', numbers={'bpd': abs(got - want)
                                                   / abs(want)},
               program=got, reference=want, program_s=t_prog,
               reference_s=t_ref)
        if seed in args.control_seeds:
          for name in controls:
            t = time.perf_counter()
            if name in ('fp8', 'bfloat16'):
              other = ev.mean(ev.reference(ctx, images, key, numerics(name)))
            else:
              other = ev.mean(per_image, name)
            emit(seed=seed, side=name,
                 numbers={'bpd': abs(other - want) / abs(want)},
                 value=other, reference=want,
                 seconds=time.perf_counter() - t)
    finally:
      shutil.rmtree(ctx.tmpdir, ignore_errors=True)
      gc.collect()
      device_lib.free_memory(dev)


class _Selections:
  """Records the hard top-k latent selection of every row that either
  side's top-k embedding computes, by wrapping the program's
  `latents.topk_embedding` and the reference's `topk_embedding`, which
  each call at run time; the wrappers return what they wrap returns."""

  def __init__(self):
    from mulan_tpu_torch.models import latents
    from benchmark.reference import mulan as ref
    self.rows, self.side = {}, None
    program, reference = latents.topk_embedding, ref.topk_embedding

    def program_topk(logits, k, noise):
      out = program(logits, k, noise)
      self._record(logits + noise, k)
      return out

    def reference_topk(m, logits, variates):
      out = reference(m, logits, variates)
      self._record(out[0].detach(), m.latent_k, hard=True)
      return out

    latents.topk_embedding = program_topk
    ref.topk_embedding = reference_topk

    def close():
      latents.topk_embedding = program
      ref.topk_embedding = reference
    self.close = close

  def start(self, side):
    self.side = side
    self.rows[side] = []

  def _record(self, x, k, hard=False):
    import torch
    x = x.detach().float()
    if hard:
      self.rows[self.side].append(((x > 0.5).cpu(), None))
      return
    x = x - x.mean(dim=-1, keepdim=True)
    top = torch.topk(x, k + 1, dim=-1).values
    kth = top[..., k - 1:k]
    self.rows[self.side].append(((x >= kth).cpu(),
                                 (top[..., k - 1] - top[..., k]).cpu()))

  def compare(self, side, reference_side):
    import torch
    a = self.rows.get(side) or []
    b = self.rows.get(reference_side) or []
    if not a or not b:
      return {}
    ha, hb = (torch.cat([h for h, _ in r]) for r in (a, b))
    out = {'rows': [len(ha), len(hb)]}
    if len(ha) != len(hb):
      return out
    differ = (ha != hb).any(dim=-1).nonzero().flatten().tolist()
    out['differ'] = differ[:32]
    out['n_differ'] = len(differ)
    margins = [m for _, m in a if m is not None]
    if margins:
      margin = torch.cat(margins)
      out['margin_min'] = float(margin.min())
      out['margin_at_differ'] = [float(margin[i]) for i in differ[:32]]
    return out


if __name__ == '__main__':
  sys.path.insert(0, ROOT)
  sys.exit(main(sys.argv[1:]))
