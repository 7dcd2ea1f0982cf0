"""repro_torch.checkpoint — the counterpart of ``repro.checkpoint``."""
from repro_torch.checkpoint.io import latest_step, load_pytree, restore, save

__all__ = ["latest_step", "load_pytree", "restore", "save"]
