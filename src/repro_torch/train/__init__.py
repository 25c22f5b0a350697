# repro_torch.train — optimizer, loss, train step, gradient communication
# (counterpart of repro.train).

from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update, cosine_schedule)
from repro_torch.train.train_step import TrainConfig, loss_fn, train_step
from repro_torch.train.grad_comm import (GradCommConfig, bucketize,
                                         compress_decompress)

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
    "TrainConfig", "train_step", "loss_fn",
    "GradCommConfig", "compress_decompress", "bucketize",
]
