"""Models of the port: the paper's sine MLP and few-shot CNN, and the LM
families (the dense decoder and Mamba2)."""
from repro_torch.models.init import Spec, count_params, materialize
from repro_torch.models.simple import FewShotCNN, SineMLP
from repro_torch.models.transformer import Model, build_model

__all__ = ["Spec", "count_params", "materialize", "FewShotCNN", "SineMLP",
           "Model", "build_model"]
