"""Model stack of the port: GQA decoder LMs, dense and mixture of experts
(see ``model.Model``)."""
from repro_torch.models.model import Model

__all__ = ["Model"]
