"""Errors shared by the port's layers."""

from __future__ import annotations


class NotInPort(ValueError):
    """A request option the JAX package serves but the port does not yet."""

    def __init__(self, option: str):
        super().__init__(f"{option} is not yet in the PyTorch port")
        self.option = option
