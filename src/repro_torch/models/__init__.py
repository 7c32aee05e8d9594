"""Models of the port: the paper's sine MLP and the dense decoder family."""
from repro_torch.models.init import Spec, materialize
from repro_torch.models.simple import SineMLP
from repro_torch.models.transformer import Model, build_model

__all__ = ["Spec", "materialize", "SineMLP", "Model", "build_model"]
