"""`mfu.eval`: the dense VLB's share of the card's bf16 peak, in %."""

from benchmark.harness.readers import mfu_eval as read  # noqa: F401
