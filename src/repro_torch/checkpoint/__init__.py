from repro_torch.checkpoint.ckpt import save_pytree, restore_pytree
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["save_pytree", "restore_pytree", "CheckpointManager"]
