"""Utilities: test-problem generators."""

from .generators import (anisotropic_laplacian_2d, convection_diffusion_2d,
                         fem_2d_unstructured, laplacian_2d,
                         laplacian_2d_block, laplacian_3d,
                         laplacian_3d_block, permuted_identity,
                         random_banded_spd, random_spd)

__all__ = ["anisotropic_laplacian_2d", "convection_diffusion_2d",
           "fem_2d_unstructured", "laplacian_2d", "laplacian_2d_block",
           "laplacian_3d", "laplacian_3d_block", "permuted_identity",
           "random_banded_spd", "random_spd"]
