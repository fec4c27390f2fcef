"""What a run makes from its seed: the images, written as the program's
`npz:<dir>` source, and the program's configuration from the files of the
cell."""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

# The seeds of the streams a run draws, so that no two share one.
IMAGES, WEIGHTS, CALLS, SAMPLE = 0, 1, 2, 3


def stream_seed(seed: int, stream: int) -> int:
  """A 63-bit seed of (run seed, stream)."""
  words = np.random.SeedSequence((seed, 104729, stream)).generate_state(
      2, np.uint32)
  return (int(words[0]) << 31) ^ int(words[1])


def make_images(rng: np.random.Generator, n: int, size: int,
                channels: int) -> np.ndarray:
  """n uint8 images (n, size, size, channels): uniform noise around a level
  and with an amplitude drawn for each image, so that images differ in
  brightness and contrast as a data set's do."""
  level = rng.integers(0, 256, (n, 1, 1, 1), dtype=np.int16)
  amp = rng.integers(0, 129, (n, 1, 1, 1), dtype=np.int16)
  noise = rng.integers(-128, 128, (n, size, size, channels), dtype=np.int16)
  return np.clip(level + ((noise * amp) >> 7), 0, 255).astype(np.uint8)


def write_dataset(seed: int, directory: str, train: int, evaluation: int,
                  size: int, channels: int) -> str:
  """`<directory>/train.npz` and `eval.npz` from the seed; returns the
  program's dataset name for them."""
  rng = np.random.default_rng(stream_seed(seed, IMAGES))
  for split, n in (('train', train), ('eval', evaluation)):
    images = make_images(rng, n, size, channels)
    np.savez(os.path.join(directory, f'{split}.npz'), images=images,
             labels=np.zeros(n, np.int32))
  return 'npz:' + directory


def program_config(configs_module, spec: Dict[str, Any],
                   overrides: Dict[str, Any]):
  """The program's Config: `spec['program_config']`'s, with every field the
  configuration file states and then `overrides` ({'section.field':
  value}) applied through the program's own override."""
  cfg = configs_module.get_config(spec['program_config'])
  fields = {}
  for section in ('model', 'training', 'optimizer', 'data'):
    for key, value in spec.get(section, {}).items():
      if isinstance(value, dict):
        for sub, v in value.items():
          fields[f'{section}.{key}.{sub}'] = v
      else:
        fields[f'{section}.{key}'] = value
  for key in ('vdm_type', 'lr_gamma_network_scale'):
    if key in spec:
      fields[key] = spec[key]
  fields.update(overrides)
  for dotted, value in fields.items():
    text = str(value).lower() if isinstance(value, bool) else str(value)
    cfg = configs_module.override(cfg, dotted, text)
  for dotted, value in fields.items():
    got = cfg
    for part in dotted.split('.'):
      got = getattr(got, part)
    if got != value:
      raise ValueError(f'{dotted}: the configuration states {value!r}, the '
                       f'program took {got!r}')
  return cfg
