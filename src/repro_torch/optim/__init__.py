"""The LM's optimizer (``adamw``) and its gradient synchronisation over a
mesh, of world dims or of processes (``distributed``)."""
from repro_torch.optim.adamw import AdamW, OptState
from repro_torch.optim.distributed import clip_by_global_norm, global_grad_norm, sync_gradients

__all__ = ["AdamW", "OptState", "sync_gradients", "global_grad_norm", "clip_by_global_norm"]
