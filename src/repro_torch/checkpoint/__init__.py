from .manager import CheckpointManager, save_pytree, restore_pytree  # noqa: F401
