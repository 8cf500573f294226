"""The teacher's and the students' train and eval steps (PyTorch)."""
from .ema import ema_alpha, update_ema
from .optim import ScheduledOptimizer, make_optimizer
from .schedules import make_lr_schedule
from .state import TrainState
