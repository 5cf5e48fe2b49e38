from repro_torch.train.loop import (
    TrainConfig,
    make_train_step,
    make_eval_step,
    loss_fn,
    Trainer,
)

__all__ = ["TrainConfig", "make_train_step", "make_eval_step", "loss_fn", "Trainer"]
