"""LM model zoo: the 10 architectures as config-driven PyTorch models."""
from .config import ArchConfig
from .model import Model, build_model, init_params

__all__ = ["ArchConfig", "Model", "build_model", "init_params"]
