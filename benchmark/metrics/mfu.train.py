"""`mfu.train`: the train step's share of the card's bf16 peak, in %, in a
device-bound training cell."""

from benchmark.harness.readers import mfu as read  # noqa: F401
