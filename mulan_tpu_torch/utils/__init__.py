"""Metric writers, image grids and PNG files, the msgpack codec of
`ckpt-N.flax` files, and workdir naming."""
