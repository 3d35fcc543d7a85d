"""repro_torch.train — the train step and its data-parallel plane sync
(PyTorch port)."""
from .step import TrainState, make_train_step, loss_fn, init_state  # noqa: F401
