"""Device activities (kernels and copies) in the traced segment, a
training step: the reader of ``kernels_per_token``, whose unit is the
runner's (a token there, a step here)."""

from perfbench.metrics.kernels_per_token import read  # noqa: F401
