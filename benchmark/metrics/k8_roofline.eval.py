"""`k8_roofline.eval`: K8's share of its roofline on the dense VLB: the
least time of the GroupNorm+swish work the program counted in the traced
calls over K8's device time there, in %."""

from benchmark.harness.gn_roofline import dense_eval as read  # noqa: F401
