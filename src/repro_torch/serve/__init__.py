"""Serving: the model ``BatchServer`` and ``generate``, the streaming plan
server over the device plan arena (``planserve``), and their shared
deadline-batching primitive. Twin of ``repro.serve``."""
from .engine import BatchServer, GenResult, Request, Response, generate, take_batch
from .planserve import PlanServer

__all__ = ["BatchServer", "GenResult", "PlanServer", "Request", "Response",
           "generate", "take_batch"]
