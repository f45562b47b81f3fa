"""The mapper→reducer shuffle on the world-dim mesh (``spmd``)."""
from repro_torch.shuffle import spmd
from repro_torch.shuffle.spmd import partition_tokens, shuffle_reduce, token_shuffle

__all__ = ["spmd", "partition_tokens", "shuffle_reduce", "token_shuffle"]
