# repro_torch.ckpt — checkpoint save/restore (npz + zstd, async writer);
# counterpart of repro.ckpt.  The elastic resharding (repro/ckpt/elastic.py)
# waits for the port of repro.sharding (ROADMAP A.5).

from repro_torch.ckpt.checkpoint import (CheckpointManager, load_checkpoint,
                                         save_checkpoint)

__all__ = ["CheckpointManager", "save_checkpoint", "load_checkpoint"]
