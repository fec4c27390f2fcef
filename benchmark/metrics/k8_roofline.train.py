"""`k8_roofline.train`: K8's share of its roofline in a training cell: the
least time of the GroupNorm+swish forward and backward work the program
counted in the traced calls over the device time of K8's two categories
there, in %."""

from benchmark.harness.gn_roofline import train as read  # noqa: F401
