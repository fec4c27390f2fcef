"""`optimizer_host_ms_per_step.paced_train`: host ms a train step in the
program's span `optimizer` (AdamW's step), in a host-paced training cell."""

from benchmark.harness.program import optimizer_host_ms as read  # noqa: F401
