"""Training (counterpart of repro.training): the synthetic data pipeline,
AdamW / Adafactor, the train step and the restart-safe trainer, for the
dense family; the attention gradient runs the hand backward kernel on the
card."""
from .data import DataConfig, DataIterator, batch_at_step  # noqa: F401
from .optimizer import (  # noqa: F401
    AdafactorConfig,
    AdamWConfig,
    opt_init,
    opt_update,
)
from .train_loop import Trainer, TrainerConfig  # noqa: F401
from .train_step import make_train_step  # noqa: F401
