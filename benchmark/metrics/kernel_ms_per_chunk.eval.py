"""`kernel_ms_per_chunk.eval`: device kernel ms a dense-VLB chunk (traced
calls)."""

from benchmark.harness.readers import kernel_ms_per_chunk as read  # noqa: F401
