from repro_torch.models.model import Model, build_model, cross_entropy

__all__ = ["Model", "build_model", "cross_entropy"]
