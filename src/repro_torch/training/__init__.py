from repro_torch.training.optimizer import AdamW, AdamWState, constant_lr, \
    cosine_lr
from repro_torch.training.train_loop import TrainLoop, TrainLoopConfig
from repro_torch.training.checkpoint import latest_step, load_checkpoint, \
    save_checkpoint

__all__ = ["AdamW", "AdamWState", "cosine_lr", "constant_lr", "TrainLoop",
           "TrainLoopConfig", "save_checkpoint", "load_checkpoint",
           "latest_step"]
