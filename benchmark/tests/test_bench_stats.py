"""The metric arithmetic on synthetic records."""

import pytest

from benchmark.harness import stats, trace


def test_rate_is_over_the_whole_window():
  # 10 steps of 128 images in a window of 2.5 s, the drain included.
  assert stats.rate(10 * 128, 2.5) == 512.0
  with pytest.raises(ValueError):
    stats.rate(1, 0.0)


def test_p90_is_over_all_steps():
  steps = [100.0] * 90 + [200.0] * 10
  assert stats.percentile(steps, 90) == 100.0
  assert stats.percentile(steps + [300.0], 90) == 200.0
  assert stats.percentile(list(range(1, 11)), 90) == 9


def test_union_of_intervals():
  assert stats.union_length([(0, 2), (1, 3), (5, 6)]) == 4
  assert stats.union_length([(5, 6), (0, 10)]) == 10
  assert stats.union_length([]) == 0
  assert stats.gaps([(1, 2), (1.5, 3), (5, 6)], 0, 8) == [
      (0, 1), (3, 5), (6, 8)]


def test_trace_record_idle_share_and_breakdown():
  ops = [('sm90_xmma_fprop_implicit_gemm', 0, 40),
         ('nchwToNhwcKernel', 30, 50),      # overlaps the first
         ('vectorized_elementwise_kernel', 70, 90),
         ('Memcpy HtoD (Pinned -> Device)', 90, 95)]
  spans = [('input', 0, 5), ('call', 5, 60), ('call', 60, 100)]
  rec = trace.reduce(ops, spans, [(55, 58)], calls=2)
  assert rec['window_s'] == pytest.approx(100e-9)
  assert rec['busy_s'] == pytest.approx(75e-9)   # [0, 50) + [70, 95)
  assert rec['kernels'] == 3                     # the copy is no kernel
  assert rec['kernel_s'] == pytest.approx(80e-9)
  assert rec['by_category_s'][trace.LAYOUT] == pytest.approx(20e-9)
  gaps = rec['breakdown']['idle_gaps']
  assert gaps[0] == ['call', pytest.approx(20e-9)]   # [50, 70)
  assert gaps[1] == ['call', pytest.approx(5e-9)]    # [95, 100)
  ops_named = [name for name, _ in rec['breakdown']['device_ops']]
  assert ops_named[0].startswith('convolutions and GEMMs: ')
  assert rec['syncs'] == [(pytest.approx(55e-9), pytest.approx(58e-9))]
