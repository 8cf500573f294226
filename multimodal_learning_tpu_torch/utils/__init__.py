from .checkpoint import (load_checkpoint, load_train_state, save_checkpoint,
                         save_train_state)
from .logging import MetricsLogger, StepTimer
