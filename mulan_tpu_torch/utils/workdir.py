"""Workdir naming from the command line, counterpart of
`mulan_tpu/utils/workdir.py`."""

from __future__ import annotations

import os
import sys
import time


def get_workdir(argv=None) -> str:
  """`<config name>/<job id or time stamp>[-<override>...]`: the config
  file's basename, the SLURM job id, run name or current time, then the
  last part of each `--config.<...>=<value>` override (its last two when the
  last is a number or empty); `--workdir` and `ckpt_restore_dir` are left
  out."""
  argv = sys.argv if argv is None else argv
  parts = []
  job_id = os.environ.get('SLURM_JOB_ID')
  run_name = os.environ.get('COMPOSER_RUN_NAME')
  if job_id:
    parts.append(job_id)
  elif run_name:
    parts.append(run_name)
  else:
    parts.append(time.strftime('%Y%m%d-%H%M%S'))
  config_file = 'config'
  for arg in argv[1:]:
    if arg.startswith('--config='):
      config_file = os.path.basename(arg.split('=', 1)[1]).removesuffix('.py')
    elif arg.startswith(('--workdir=', '--config.ckpt_restore_dir=')):
      continue
    elif arg.startswith('--config'):
      pieces = arg.split('.')
      tag = pieces[-1]
      if tag.isnumeric() or not tag:
        tag = pieces[-2] + '.' + pieces[-1]
      parts.append(tag)
  return os.path.join(config_file, '-'.join(parts))
