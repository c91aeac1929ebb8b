"""The stream description shared by every consumer surface of a config:
:class:`PartialShuffleSpec` (its wire form is the JAX package's)."""

from .spec import PartialShuffleSpec  # noqa: F401

__all__ = ["PartialShuffleSpec"]
