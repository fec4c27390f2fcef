"""`layout_ms_per_step.paced_train`: cuDNN's NCHW/NHWC transposes' ms a train
step (traced calls), in a host-paced training cell."""

from benchmark.harness.readers import layout_ms_per_step as read  # noqa: F401
