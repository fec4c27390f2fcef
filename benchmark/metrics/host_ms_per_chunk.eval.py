"""`host_ms_per_chunk.eval`: host ms a dense-VLB chunk, to the call's read of
its result."""

from benchmark.harness.readers import host_ms_per_chunk as read  # noqa: F401
