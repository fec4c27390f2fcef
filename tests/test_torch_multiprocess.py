"""The port across processes on the CPU over gloo: data parallelism, FSDP
and HSDP training, exact resume, the evaluators and the command lines,
each rank against one process fed the global batch (the ranks' batches
concatenated in rank order, as `jax.make_array_from_process_local_data`
assembles it).

The chain to JAX: the one-process port is held to JAX's `Experiment`
(`test_torch_train.py`: 3 steps against a JAX loop, train-mode gradients
with the same dropout masks), its evaluators to JAX's
(`test_torch_evals.py`, `test_torch_nll_ode.py`), and here an N-rank run to
the one-process port; JAX's own multi-process run is
`tests/test_multiprocess.py`. Dropout is on (the tiny config's 0.1): each
rank's masks are its rows of the global masks, and a rank that drew rank
0's masks would fail the comparisons.

Each pod runs `torch_multiprocess_worker.py` once per rank (one torch
thread each, a time limit per process) and is shared by the tests that
read it; a pod that fails on a transport error is started once more.
"""

import os
import socket
import subprocess
import sys

import pytest

import torch_port_helpers  # noqa: F401  (caps torch's threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, 'tests', 'torch_multiprocess_worker.py')
TIMEOUT_S = 180
_TRANSPORT = ('Connection reset', 'Connection refused', 'Address already in',
              'Connect timeout', 'connect() timed out', 'Gloo connectFullMesh')


def _free_ports(n):
  socks = [socket.socket(socket.AF_INET, socket.SOCK_STREAM)
           for _ in range(n)]
  try:
    for s in socks:
      s.bind(('127.0.0.1', 0))
    return [s.getsockname()[1] for s in socks]
  finally:
    for s in socks:
      s.close()


def _launch(world, mode, workdir):
  ports = ','.join(map(str, _free_ports(6)))
  env = dict(os.environ, OMP_NUM_THREADS='1',
             PYTHONPATH=REPO + os.pathsep + os.environ.get('PYTHONPATH', ''))
  for key in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
              'MASTER_PORT'):
    env.pop(key, None)
  procs = [subprocess.Popen(
      [sys.executable, WORKER, '--rank', str(r), '--world', str(world),
       '--ports', ports, '--workdir', str(workdir), '--mode', mode],
      cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
      text=True) for r in range(world)]
  outs = []
  try:
    for proc in procs:
      try:
        out, _ = proc.communicate(timeout=TIMEOUT_S)
      except subprocess.TimeoutExpired:
        for p in procs:
          p.kill()
        out, _ = proc.communicate()
        out = (out or '') + f'\n<<< rank timed out after {TIMEOUT_S} s >>>'
      outs.append(out)
  finally:
    for proc in procs:
      if proc.poll() is None:
        proc.kill()
  return [p.returncode for p in procs], outs


def _run_pod(world, mode, tmp_path_factory):
  for attempt in range(2):
    rcs, outs = _launch(world, mode,
                        tmp_path_factory.mktemp(f'{mode}{attempt}'))
    ok = all(rc == 0 and f'WORKER_OK rank={r}' in out
             for r, (rc, out) in enumerate(zip(rcs, outs)))
    if ok or not any(t in out for out in outs for t in _TRANSPORT):
      break
  return rcs, outs


def _lines(out, prefix):
  return [l for l in out.splitlines() if l.startswith(prefix)]


def _assert_check(pod, name):
  rcs, outs = pod
  report = '\n'.join(f'--- rank {r} (rc {rc}) ---\n{out[-5000:]}'
                     for r, (rc, out) in enumerate(zip(rcs, outs)))
  assert any(l.startswith(f'CHECK {name} OK') for l in
             _lines(outs[0], 'CHECK ')), report
  agreed = [_lines(out, 'AGREE ') for out in outs]
  assert all(a == agreed[0] for a in agreed), report
  assert all(rc == 0 for rc in rcs), report


@pytest.fixture(scope='module')
def pod(tmp_path_factory):
  return _run_pod(2, 'pod', tmp_path_factory)


@pytest.fixture(scope='module')
def hsdp_pod(tmp_path_factory):
  return _run_pod(4, 'hsdp', tmp_path_factory)


@pytest.mark.parametrize('check', [
    'dp_matches_one_process',                     # (a)
    'superstep_matches_one_process',
    'fsdp_matches_one_process',                   # (b)
    'fsdp_remat_matches_one_process',
    'fsdp_eval_recasts',
    'fsdp_resume_bit_for_bit',                    # (d)
    'fsdp_checkpoint_restores_in_one_process',
    'evals_match_one_process',                    # (e)
    'dopri5_same_steps',
    'variants_ddp',                               # (g)
    'cli_rank0_writes',                           # (f)
])
def test_two_ranks_equal_one_process(pod, check):
  """World 2: every check of the pod, rank 0 against one process; every
  rank prints the same values (bpds, evaluations, DoPri5 step counts)."""
  _assert_check(pod, check)


def test_hsdp_two_by_two_equals_one_process(hsdp_pod):
  """World 4 as 2 data x 2 fsdp: two steps against one process."""
  _assert_check(hsdp_pod, 'hsdp_matches_one_process')
