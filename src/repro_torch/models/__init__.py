"""Models of the port (this slice: the paper's sine MLP)."""
from repro_torch.models.init import Spec, materialize
from repro_torch.models.simple import SineMLP

__all__ = ["Spec", "materialize", "SineMLP"]
