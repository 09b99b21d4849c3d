"""Training: AdamW, deterministic data, checkpoints and the train step
(dense family)."""
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.data import (DataConfig, batch_at, leval_trace,
                                       sharegpt_trace)
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_opt_state)
from repro_torch.training.train_step import Trainer, chunked_ce_loss

__all__ = ["CheckpointManager", "DataConfig", "batch_at", "leval_trace",
           "sharegpt_trace", "AdamWConfig", "adamw_update", "init_opt_state",
           "Trainer", "chunked_ce_loss"]
