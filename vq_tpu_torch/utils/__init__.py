"""Serialization of the port's models in the JAX package's npz format."""

from vq_tpu_torch.utils.serialize import load, save

__all__ = ["save", "load"]
