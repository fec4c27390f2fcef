"""`latent_device_ms_per_chunk.eval`: device ms a dense-VLB chunk in the
program's spans `encoder` and `latent` (CUDA events)."""

from benchmark.harness.program import latent_device_ms as read  # noqa: F401
