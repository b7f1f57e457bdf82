"""``repro_torch.train`` — the training path: AdamW with f32 masters,
the mixed-precision train step, checkpoints and fault tolerance."""
from repro_torch.train.optimizer import adamw_init, adamw_update  # noqa: F401
from repro_torch.train.train_step import TrainState, make_train_step  # noqa: F401
