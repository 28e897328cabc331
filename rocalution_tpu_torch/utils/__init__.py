"""Utilities: test-problem generators."""

from .generators import (convection_diffusion_2d, fem_2d_unstructured,
                         laplacian_2d, laplacian_3d, random_banded_spd)

__all__ = ["convection_diffusion_2d", "fem_2d_unstructured", "laplacian_2d",
           "laplacian_3d", "random_banded_spd"]
