"""The training path of the port: AdamW, the train state, and the train
step with microbatches and the int8 error-feedback compressed DP step."""
from .optimizer import AdamWConfig, adamw_init, adamw_update, warmup_cosine
from .step import TrainStepConfig, build_train_step
from .train_state import TrainState

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "warmup_cosine",
           "TrainStepConfig", "build_train_step", "TrainState"]
