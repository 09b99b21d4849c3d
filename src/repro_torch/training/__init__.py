"""Training: AdamW, deterministic data, checkpoints and the train step
(every family)."""
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.data import (CARD_TRAIN_FRAMES,
                                       CARD_TRAIN_PATCHES, CARD_TRAIN_SHAPES,
                                       DataConfig, batch_at, leval_trace,
                                       sharegpt_trace, side_inputs)
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_opt_state)
from repro_torch.training.train_step import Trainer, chunked_ce_loss

__all__ = ["CheckpointManager", "CARD_TRAIN_FRAMES", "CARD_TRAIN_PATCHES",
           "CARD_TRAIN_SHAPES", "DataConfig", "batch_at", "leval_trace",
           "sharegpt_trace", "side_inputs", "AdamWConfig", "adamw_update",
           "init_opt_state", "Trainer", "chunked_ce_loss"]
