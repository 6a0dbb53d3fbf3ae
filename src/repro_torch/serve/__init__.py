"""Serving: the streaming plan server over the device plan arena
(``planserve``) and its deadline-batching primitive. Twin of
``repro.serve``; the model-serving ``BatchServer`` and ``generate`` come with
the ML-stack slice of the port."""
from .engine import take_batch
from .planserve import PlanServer

__all__ = ["PlanServer", "take_batch"]
