# repro_torch.ckpt — checkpoint save/restore (npz + zstd, async writer)
# and elastic resharding onto changed meshes; counterpart of repro.ckpt.

from repro_torch.ckpt.checkpoint import (CheckpointManager, load_checkpoint,
                                         save_checkpoint)
from repro_torch.ckpt.elastic import reshard_checkpoint

__all__ = ["CheckpointManager", "save_checkpoint", "load_checkpoint",
           "reshard_checkpoint"]
