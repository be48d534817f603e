"""Diffusion schedule and sampling math."""
from .gaussian import GaussianDiffusion, create_gaussian_diffusion

__all__ = ["GaussianDiffusion", "create_gaussian_diffusion"]
