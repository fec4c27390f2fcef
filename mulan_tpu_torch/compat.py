"""Reference checkpoints (`ckpt-N.flax`) for the port, counterpart of the
checkpoint side of `mulan_tpu/compat.py`.

A `ckpt-N.flax` file is `flax.serialization.to_bytes` of {step, params,
ema_params[, opt_state]} in the parameter layout of the reference MuLAN
(s-sahoo/MuLAN): the layout of its released checkpoints, and what the JAX
package's export writes. The port reads and writes it with its own
standard-library msgpack codec (`utils/msgpack.py`):

  * `convert_params` / `export_params` map the reference tree to the JAX
    package's layout and back (pure re-indexing); `params.from_flax` /
    `params.to_flax` map that layout to the port's state_dict and back;
  * `load_reference_state` reads a `ckpt-N[.flax]` (or the latest in a
    directory); `reference_state_dict` turns its params into a port
    state_dict and raises with a readable diff when they do not fit the
    configured model;
  * `import_reference_checkpoint` writes a port checkpoint
    (`<workdir>/checkpoints/ckpt_<N>.pt`) with the file's params, EMA and
    step and a fresh AdamW state, which training resumes from and
    `EvalExperiment` reads;
  * `export_reference_checkpoint` writes a port checkpoint's step, params
    and EMA as a bare `ckpt-N.flax`. The TF sidecar files that
    `clu.checkpoint` needs are not written, as the JAX package skips them
    without TensorFlow.

    python -m mulan_tpu_torch.compat --mode import \
        --config=cifar10_conditioned --reference_checkpoint=<dir>/ckpt-223 \
        --workdir=<dir> [--device=cpu]
    python -m mulan_tpu_torch.compat --mode export \
        --checkpoint=<workdir>/checkpoints --output=<dir>
"""

from __future__ import annotations

import argparse
import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from mulan_tpu_torch import configs as configs_lib
from mulan_tpu_torch import params as params_lib
from mulan_tpu_torch.models import resolve_device
from mulan_tpu_torch.models.mulan import MuLAN
from mulan_tpu_torch.utils import msgpack

_TOP = {'score_model', 'encoder_model', 'gamma'}

# -- reference layout -> the JAX package's layout -----------------------------


def _convert_attn(ref_attn: Dict[str, Any]) -> Dict[str, Any]:
  """Dense (c, c) projections -> DenseGeneral with one (c, 1, c) head."""
  c = ref_attn['q']['kernel'].shape[0]
  out = {'GroupNormF32_0': {'GroupNorm_0': ref_attn['GroupNorm_0']}}
  for name in ('q', 'k', 'v'):
    out[name] = {'kernel': ref_attn[name]['kernel'].reshape(c, 1, c),
                 'bias': ref_attn[name]['bias'].reshape(1, c)}
  out['proj_out'] = {
      'kernel': ref_attn['proj_out']['kernel'].reshape(1, c, c),
      'bias': ref_attn['proj_out']['bias']}
  return out


def _convert_block(ref_block: Dict[str, Any]) -> Dict[str, Any]:
  """ResnetBlock: the GroupNorms move into GroupNormF32 wrappers."""
  out = {}
  for name, sub in ref_block.items():
    if name == 'GroupNorm_0':
      out['GroupNormF32_0'] = {'GroupNorm_0': sub}
    elif name == 'GroupNorm_1':
      out['GroupNormF32_1'] = {'GroupNorm_0': sub}
    else:
      out[name] = sub
  return out


def _convert_unet(ref: Dict[str, Any]) -> Dict[str, Any]:
  """Score UNet / encoder trunk: `a.b` modules become `a_b`, attention and
  ResNet blocks converted, the final GroupNorm wrapped."""
  out = {}
  for name, sub in ref.items():
    new = name.replace('.', '_')
    if 'attn' in name:
      out[new] = _convert_attn(sub)
    elif 'block' in name:
      out[new] = _convert_block(sub)
    elif name == 'GroupNorm_0':
      out['GroupNormF32_0'] = {'GroupNorm_0': sub}
    else:
      out[new] = sub
  return out


# The reference CNN encoder upper-cases its module names.
_CNN_IMPORT = {'CONV1': 'conv1', 'CONV2': 'conv2', 'DENSE': 'dense'}
_CNN_EXPORT = {v: k for k, v in _CNN_IMPORT.items()}


def convert_params(ref_params: Dict[str, Any]) -> Dict[str, Any]:
  """Reference param tree -> the JAX package's layout
  (`mulan_tpu/compat.py:convert_params`)."""
  ref = dict(ref_params)
  unknown = set(ref) - _TOP
  if unknown:
    raise ValueError(f'unexpected top-level reference keys: {sorted(unknown)}')
  out = {'score_model': _convert_unet(ref['score_model'])}
  if 'encoder_model' in ref:
    encoder = _convert_unet(dict(ref['encoder_model']))
    heads = {k: encoder.pop(k) for k in sorted(encoder)
             if k.startswith('dense_layer_final')}
    if heads:  # UNet encoder: trunk + logits head(s)
      out['encoder_model'] = {'trunk': encoder, **heads}
    else:  # CNN encoder
      out['encoder_model'] = {_CNN_IMPORT.get(k, k): v
                              for k, v in encoder.items()}
  if 'gamma' in ref:
    out['gamma'] = ref['gamma']
  return out


# -- the JAX package's layout -> reference layout -----------------------------

# Only the reference's down./mid./up. UNet module names contain dots.
_DOTTED_RE = re.compile(r'^(down|mid|up)_((?:block|attn)_\d+)$')


def _export_attn(attn: Dict[str, Any]) -> Dict[str, Any]:
  c = np.shape(attn['q']['kernel'])[0]
  out = {'GroupNorm_0': attn['GroupNormF32_0']['GroupNorm_0']}
  for name in ('q', 'k', 'v'):
    out[name] = {'kernel': np.asarray(attn[name]['kernel']).reshape(c, c),
                 'bias': np.asarray(attn[name]['bias']).reshape(c)}
  out['proj_out'] = {
      'kernel': np.asarray(attn['proj_out']['kernel']).reshape(c, c),
      'bias': np.asarray(attn['proj_out']['bias'])}
  return out


def _export_block(block: Dict[str, Any]) -> Dict[str, Any]:
  out = {}
  for name, sub in block.items():
    if name == 'GroupNormF32_0':
      out['GroupNorm_0'] = sub['GroupNorm_0']
    elif name == 'GroupNormF32_1':
      out['GroupNorm_1'] = sub['GroupNorm_0']
    else:
      out[name] = sub
  return out


def _export_unet(tree: Dict[str, Any]) -> Dict[str, Any]:
  out = {}
  for name, sub in tree.items():
    m = _DOTTED_RE.match(name)
    new = f'{m.group(1)}.{m.group(2)}' if m else name
    if 'attn' in name:
      out[new] = _export_attn(sub)
    elif 'block' in name:
      out[new] = _export_block(sub)
    elif name == 'GroupNormF32_0':
      out['GroupNorm_0'] = sub['GroupNorm_0']
    else:
      out[new] = sub
  return out


def export_params(params: Dict[str, Any]) -> Dict[str, Any]:
  """The JAX package's layout -> the reference layout, the exact inverse of
  `convert_params` (`mulan_tpu/compat.py:export_params`)."""
  tree = dict(params)
  unknown = set(tree) - _TOP
  if unknown:
    raise ValueError(f'unexpected top-level param keys: {sorted(unknown)}')
  out = {'score_model': _export_unet(tree['score_model'])}
  if 'encoder_model' in tree:
    encoder = dict(tree['encoder_model'])
    if 'trunk' in encoder:
      flat = _export_unet(encoder.pop('trunk'))
      flat.update(encoder)
      out['encoder_model'] = flat
    else:
      out['encoder_model'] = {_CNN_EXPORT.get(k, k): v
                              for k, v in encoder.items()}
  if 'gamma' in tree:
    out['gamma'] = tree['gamma']
  return out


# -- nested trees, flat paths and the port's state_dict -----------------------


def flatten(tree: Dict[str, Any], prefix: str = '') -> Dict[str, Any]:
  """Nested dicts -> {'a/b/c': leaf}."""
  out = {}
  for key, value in tree.items():
    path = f'{prefix}{key}'
    if isinstance(value, dict):
      out.update(flatten(value, path + '/'))
    else:
      out[path] = value
  return out


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
  """{'a/b/c': leaf} -> nested dicts, keys sorted at every level (the order
  of a flax init's params)."""
  tree: Dict[str, Any] = {}
  for path in sorted(flat):
    *parents, leaf = path.split('/')
    node = tree
    for name in parents:
      node = node.setdefault(name, {})
    node[leaf] = flat[path]
  return tree


def expected_shapes(model_config) -> Dict[str, tuple]:
  """{state_dict name: shape} of the port's MuLAN for `model_config`."""
  with torch.device('meta'):
    return {k: tuple(v.shape) for k, v in
            MuLAN(model_config).state_dict().items()}


def assert_compatible(state: Dict[str, torch.Tensor],
                      expected: Dict[str, tuple]) -> None:
  """Raises with a readable diff unless `state` has exactly the names and
  shapes of `expected` (`mulan_tpu/compat.py:assert_tree_compatible`)."""
  missing = sorted(set(expected) - set(state))
  extra = sorted(set(state) - set(expected))
  mismatched = sorted(k for k in set(state) & set(expected)
                      if tuple(state[k].shape) != expected[k])
  if missing or extra or mismatched:
    lines = []
    if missing:
      lines.append(f'missing from checkpoint: {missing[:8]}')
    if extra:
      lines.append(f'unconsumed checkpoint leaves: {extra[:8]}')
    if mismatched:
      lines.append('shape mismatches: ' + ', '.join(
          f'{k}: ckpt{tuple(state[k].shape)} vs model{expected[k]}'
          for k in mismatched[:8]))
    raise ValueError('reference checkpoint does not match the configured '
                     'model:\n  ' + '\n  '.join(lines))


def reference_state_dict(ref_params: Dict[str, Any],
                         model_config) -> Dict[str, torch.Tensor]:
  """A reference-layout param tree -> the port's state_dict, checked
  against the port's MuLAN for `model_config`."""
  state = params_lib.from_flax(flatten(convert_params(ref_params)))
  assert_compatible(state, expected_shapes(model_config))
  return state


def to_reference_params(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
  """The port's state_dict -> a reference-layout tree of float32 numpy."""
  return export_params(unflatten(params_lib.to_flax(state)))


# -- reference checkpoint files -----------------------------------------------

_CKPT_RE = re.compile(r'^ckpt-(\d+)\.flax$')


def resolve_flax_path(path: str) -> str:
  """`.../ckpt-N`, `.../ckpt-N.flax`, or a directory (latest N wins)."""
  if os.path.isdir(path):
    found = [(int(m.group(1)), name) for name in os.listdir(path)
             for m in [_CKPT_RE.match(name)] if m]
    if not found:
      raise FileNotFoundError(f'no ckpt-N.flax files under {path}')
    return os.path.join(path, max(found)[1])
  return path if path.endswith('.flax') else path + '.flax'


def is_reference_checkpoint(path: str) -> bool:
  """Whether `path` names a `ckpt-N[.flax]` file or a directory of them
  (and no port checkpoints)."""
  if os.path.isdir(path):
    names = os.listdir(path)
    return (any(_CKPT_RE.match(n) for n in names)
            and not any(n.startswith('ckpt_') for n in names))
  return _CKPT_RE.match(os.path.basename(resolve_flax_path(path))) is not None


def load_reference_state(path: str) -> Dict[str, Any]:
  """A `ckpt-N[.flax]` as a nested dict {step, params, ema_params, ...}
  (keys as saved; arrays are read-only views of the file's bytes)."""
  with open(resolve_flax_path(path), 'rb') as f:
    return msgpack.restore(f.read())


def reference_step(state: Dict[str, Any], path: str) -> int:
  """The file's step, or the N of its `ckpt-N` name when it holds none (or
  0)."""
  step = int(np.asarray(state.get('step', 0)))
  m = _CKPT_RE.match(os.path.basename(resolve_flax_path(path)))
  return step or (int(m.group(1)) if m else 0)


def import_reference_checkpoint(config, reference_checkpoint: str,
                                workdir: str, *, device='cuda') -> int:
  """Writes a reference `ckpt-N[.flax]` as the port checkpoint
  `<workdir>/checkpoints/ckpt_<N>.pt`: its params, EMA (the params when it
  has none) and step, with the optimizer freshly initialized. Returns N."""
  from mulan_tpu_torch.train import checkpoint as ckpt_lib
  from mulan_tpu_torch.train.loop import create_train_state

  device = resolve_device(device)
  ref = load_reference_state(reference_checkpoint)
  step = reference_step(ref, reference_checkpoint)
  params = reference_state_dict(ref['params'], config.model)
  ema = reference_state_dict(ref.get('ema_params', ref['params']),
                             config.model)
  _, state = create_train_state(config, device, params)
  state.load_tensors('ema_params', ema)
  state.step = step
  ckpt_lib.CheckpointManager(os.path.join(workdir, 'checkpoints')).save(
      step, state)
  return step


def export_reference_checkpoint(checkpoint_dir: str, output_dir: str,
                                step: Optional[int] = None) -> str:
  """Writes port checkpoint `step` (default: the latest) of
  `checkpoint_dir` as `<output_dir>/ckpt-<step>.flax`: msgpack of {step,
  params, ema_params} in the reference layout. Returns its path."""
  from mulan_tpu_torch.train import checkpoint as ckpt_lib

  restored = ckpt_lib.CheckpointManager(checkpoint_dir).restore_dict(step)
  step = int(restored['step'])
  tree = {'step': np.int64(step),
          'params': to_reference_params(restored['params']),
          'ema_params': to_reference_params(restored['ema_params'])}
  os.makedirs(output_dir, exist_ok=True)
  path = os.path.join(output_dir, f'ckpt-{step}.flax')
  with open(path + '.tmp', 'wb') as f:
    for piece in msgpack.serialize_pieces(tree):
      f.write(piece)
  os.replace(path + '.tmp', path)
  return path


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  parser.add_argument('--mode', choices=('import', 'export'),
                      default='import')
  parser.add_argument('--config', help='--mode import: a port config name '
                      'or a JAX config file')
  parser.add_argument('--reference_checkpoint',
                      help='a ckpt-N[.flax] file or its directory')
  parser.add_argument('--workdir', help='--mode import: output workdir')
  parser.add_argument('--checkpoint',
                      help='--mode export: a port checkpoints directory')
  parser.add_argument('--output', help='--mode export: output directory')
  parser.add_argument('--device', default='cuda')
  args = parser.parse_args(argv)
  if args.mode == 'import':
    if not (args.config and args.reference_checkpoint and args.workdir):
      parser.error('--mode import needs --config, --reference_checkpoint '
                   'and --workdir')
    step = import_reference_checkpoint(
        configs_lib.get_config(args.config), args.reference_checkpoint,
        args.workdir, device=args.device)
    print(f'Imported step {step} into {args.workdir}/checkpoints')
  else:
    if not (args.checkpoint and args.output):
      parser.error('--mode export needs --checkpoint and --output')
    print(f'Wrote {export_reference_checkpoint(args.checkpoint, args.output)}')


if __name__ == '__main__':
  main()
