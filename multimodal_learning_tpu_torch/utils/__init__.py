from .checkpoint import (load_checkpoint, load_jax_snapshot, load_train_state,
                         resume_train_state, save_checkpoint,
                         save_jax_snapshot, save_train_state)
from .logging import MetricsLogger
