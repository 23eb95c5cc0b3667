"""Serving engine of the port (``repro.serve``'s counterpart)."""
from repro_torch.serve.engine import (AdmissionRejected, Request,
                                      ServeConfig, ServeEngine)

__all__ = ["AdmissionRejected", "Request", "ServeConfig", "ServeEngine"]
