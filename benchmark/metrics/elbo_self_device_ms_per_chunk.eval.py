"""`elbo_self_device_ms_per_chunk.eval`: device ms a dense-VLB chunk in the
program's span `elbo` less its children (CUDA events): the loss algebra and
the noise."""

from benchmark.harness.program import elbo_self_device_ms as read  # noqa: F401
