"""Model stack of the port: dense GQA decoder LMs (see ``model.Model``)."""
from repro_torch.models.model import Model

__all__ = ["Model"]
