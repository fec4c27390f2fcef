"""`schedule_device_ms_per_chunk.eval`: device ms a dense-VLB chunk in the
program's span `schedule` (CUDA events)."""

from benchmark.harness.program import schedule_device_ms as read  # noqa: F401
