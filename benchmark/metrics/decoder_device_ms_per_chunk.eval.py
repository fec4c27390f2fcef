"""`decoder_device_ms_per_chunk.eval`: device ms a dense-VLB chunk in the
program's span `decoder` (CUDA events)."""

from benchmark.harness.program import decoder_device_ms as read  # noqa: F401
